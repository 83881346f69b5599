// K2: packed-real inverse W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `irfft_w` (kernel
// `_w_rinv_kernel`, core `_w_rinv_core`).  (rows, N/2) half spectrum,
// real and imaginary planes in split order with Z[N/2] packed into Im of
// lane 0, stored in the io type TI -> (rows, N) real rows in the even/odd
// split lane layout, stored as TO (f32 unless the caller asks for bf16).
// The exact inverse of K1; its core `w_inv_core` is the one K6 runs twice
// per row.
//
// Bound on the H100: bytes (two half planes read, one full plane written;
// 36 complex multiply-adds per point at 12 MP).  One block per row, the
// design of K1 run backwards: the row's spectrum, both stage outputs and
// the unpack stay in the two shared row buffers.
#include "lpt_dft.cuh"

using namespace lpt;

template <typename TI, typename TO>
__global__ void __launch_bounds__(256, 3) irfft_w_kernel(const TI* __restrict__ zr,
                                                      const TI* __restrict__ zi,
                                                      TO* __restrict__ out,
                                                      const float2* __restrict__ tab, int m,
                                                      int n1, int n2) {
  constexpr int V = vec_len<TI, TO>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  __syncthreads();
  const size_t hr = (size_t)blockIdx.x * m;
  const float2 z0 = make_float2(ld1(zr + hr, Fix{}), ld1(zi + hr, Fix{}));
  const float2* X = w_inv_core<TI, V>(zr + hr, zi + hr, z0, A, B, p, R);
  store_row<TO, V>(X, out + 2 * hr, m);
}

template <typename TI, typename TO>
static int run(const void* zr, const void* zi, void* out, const float2* tab, int rows, int m,
               int n1, int n2, void* stream) {
  return launch(irfft_w_kernel<TI, TO>, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)zr, (const TI*)zi, (TO*)out, tab, m, n1, n2);
}

// io: storage code of zr and zi; out: that of the output (F32 or BF16).
extern "C" int lpt_irfft_w(const void* zr, const void* zi, void* out, const float2* tab,
                           int rows, int m, int n1, int n2, int io, int out_code, void* stream) {
  using bf = __nv_bfloat16;
  switch (io * 3 + out_code) {
    case F32 * 3 + F32: return run<float, float>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case F32 * 3 + BF16: return run<float, bf>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case BF16 * 3 + F32: return run<bf, float>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case BF16 * 3 + BF16: return run<bf, bf>(zr, zi, out, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
