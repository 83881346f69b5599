// K2: packed-real inverse W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `irfft_w` (:1831;
// kernel `_w_rinv_kernel`, core `_w_rinv_core` :1631).  (rows, N/2) half
// spectrum, real and imaginary planes in split order with Z[N/2] packed
// into Im of lane 0, stored in the io type TI -> (rows, N) real rows in
// the even/odd split lane layout, stored as TO (f32 unless the caller asks
// for bf16).  The exact inverse of K1.  Bound on the H100: bytes (two half
// planes read, one full plane written).
//
// Two designs, chosen by M = N/2 alone in `lpt_irfft_w` with K1's rule
// (kernels.irfft_w_design = rfft_w_design; neither falls back on the
// other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): `irfft_row`
//   of lpt_fft.cuh, K1's radix FFT run backwards.  One block of M/16
//   threads per row: the half spectrum by 16-byte loads into the split
//   layout of one padded buffer, the unpack at each thread's pass-0
//   frequencies, the inverse by conjugation through the forward radix
//   passes, one exchange into natural order, and the row stored from the
//   registers at j = t + T r (one coalesced access per register and
//   plane).  34.8 KB of shared memory at M = 4096, four blocks an SM.
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   the two-stage DFT of lpt_dft.cuh, `w_inv_core` (the core K6's split
//   design runs twice per row).  One block per row keeps the row's
//   spectrum, both stage outputs and the unpack in two shared row buffers
//   (69.6 KB at 12 MP, three blocks an SM): 0.562 / 0.537 ms at 12 MP, f32
//   / bf16 io (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

using namespace lpt;

template <typename TI, typename TO, bool kGen>
__global__ void __launch_bounds__(256, 3) irfft_w_kernel(const TI* __restrict__ zr,
                                                      const TI* __restrict__ zi,
                                                      TO* __restrict__ out,
                                                      const float2* __restrict__ tab, int m,
                                                      int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<TI, TO>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  __syncthreads();
  const size_t hr = (size_t)blockIdx.x * m;
  const float2 z0 = make_float2(ld1(zr + hr, Fix{}), ld1(zi + hr, Fix{}));
  const float2* X = w_inv_core<TI, V, kGen>(zr + hr, zi + hr, z0, A, B, p, R);
  store_row<TO, V>(X, out + 2 * hr, m);
}

template <typename TI, typename TO>
static int run(const void* zr, const void* zi, void* out, const float2* tab, int rows, int m,
               int n1, int n2, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<TI, TO>()) ? irfft_w_kernel<TI, TO, true>
                                                           : irfft_w_kernel<TI, TO, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream, (const TI*)zr,
                (const TI*)zi, (TO*)out, tab, m, n1, n2);
}

template <typename TI, typename TO, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? 4 : 1)
    irfft_w_radix_kernel(const TI* __restrict__ zr, const TI* __restrict__ zi,
                         TO* __restrict__ out, const float2* __restrict__ tab, int n1, int n2) {
  extern __shared__ float2 sm[];
  const fft::RTable<M> tb(tab, n1, n2);
  const size_t hr = (size_t)blockIdx.x * M;
  const float2 z0 = make_float2(ld1(zr + hr, Fix{}), ld1(zi + hr, Fix{}));
  float2 v[fft::RADIX];
  fft::irfft_row<TI, M>(zr + hr, zi + hr, z0, tb.en, tb.tw, n1, n2, sm, v);
  fft::store_split_row<TO, M>(v, out + 2 * hr);
}

template <typename TI, typename TO, int M>
static int run_radix(const void* zr, const void* zi, void* out, const float2* tab, int rows,
                     int n1, int n2, void* stream) {
  return launch(irfft_w_radix_kernel<TI, TO, M>, dim3(rows), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const TI*)zr, (const TI*)zi, (TO*)out, tab,
                n1, n2);
}

// The design by m alone (see the header note).
template <typename TI, typename TO>
static int dispatch(const void* zr, const void* zi, void* out, const float2* tab, int rows,
                    int m, int n1, int n2, void* stream) {
  switch (m) {
    case 64: return run_radix<TI, TO, 64>(zr, zi, out, tab, rows, n1, n2, stream);
    case 128: return run_radix<TI, TO, 128>(zr, zi, out, tab, rows, n1, n2, stream);
    case 256: return run_radix<TI, TO, 256>(zr, zi, out, tab, rows, n1, n2, stream);
    case 512: return run_radix<TI, TO, 512>(zr, zi, out, tab, rows, n1, n2, stream);
    case 1024: return run_radix<TI, TO, 1024>(zr, zi, out, tab, rows, n1, n2, stream);
    case 2048: return run_radix<TI, TO, 2048>(zr, zi, out, tab, rows, n1, n2, stream);
    case 4096: return run_radix<TI, TO, 4096>(zr, zi, out, tab, rows, n1, n2, stream);
    default: return run<TI, TO>(zr, zi, out, tab, rows, m, n1, n2, stream);
  }
}

// io: storage code of zr and zi; out: that of the output (F32 or BF16).
// tab: the split table, followed in the radix design by the radix
// twiddles and the natural-order unpack factors (fft::RTable).
extern "C" int lpt_irfft_w(const void* zr, const void* zi, void* out, const float2* tab,
                           int rows, int m, int n1, int n2, int io, int out_code, void* stream) {
  using bf = __nv_bfloat16;
  switch (io * 3 + out_code) {
    case F32 * 3 + F32: return dispatch<float, float>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case F32 * 3 + BF16: return dispatch<float, bf>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case BF16 * 3 + F32: return dispatch<bf, float>(zr, zi, out, tab, rows, m, n1, n2, stream);
    case BF16 * 3 + BF16: return dispatch<bf, bf>(zr, zi, out, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
