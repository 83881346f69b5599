// K13: full-width inverse W transform, real output.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `ifft_w` (kernel
// `_w_inv_kernel`, core `_w_inv_core`).  (rows, W) split-order spectrum,
// real and imaginary planes in the io type TI -> (rows, W) real part of
// the inverse transform, natural order, scaled 1/W, stored as TO (f32
// unless the caller asks for bf16).  No spectrum is assumed Hermitian.
//
// Bound on the H100: bytes (two planes read, one written; 40 complex
// multiply-adds per point at 12 MP, one complex DFT for two rows).  One
// block loads two rows' spectra, forms C = herm(a0) + i herm(a1) in shared
// memory (`load_two_spectra`), whose inverse holds the two real outputs
// as its real and imaginary parts.  134 KB of shared memory at 12 MP: one
// block of 512 threads per SM.
#include "lpt_dft.cuh"

using namespace lpt;

template <typename TI, typename TO>
__global__ void __launch_bounds__(FW_THREADS, 1)
    ifft_w_kernel(const TI* __restrict__ vr, const TI* __restrict__ vi, TO* __restrict__ out,
                  const float2* __restrict__ tab, int rows, int n1, int n2) {
  constexpr int V = vec_len<TI, TO>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int r0 = 2 * blockIdx.x, n = p.n;
  const bool two = r0 + 1 < rows;
  const size_t o0 = (size_t)r0 * n, o1 = o0 + n;
  const float sc = load_two_spectra<TI, V>(vr + o0, vi + o0, two ? vr + o1 : nullptr,
                                           two ? vi + o1 : nullptr, A, B, p);
  const float2* X = c_inv_core(A, B, p, R, 1.f / (float)n);
  store_two_rows<TO, V>(X, n, out + o0, two ? out + o1 : nullptr, 1.f / sc);
}

template <typename TI, typename TO>
static int run(const void* vr, const void* vi, void* out, const float2* tab, int rows, int n1,
               int n2, void* stream) {
  return launch(ifft_w_kernel<TI, TO>, dim3((rows + 1) / 2), dim3(FW_THREADS), w_smem_bytes(n1, n2),
                stream, (const TI*)vr, (const TI*)vi, (TO*)out, tab, rows, n1, n2);
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of vr and
// vi; out_code: that of the output (F32 or BF16).
extern "C" int lpt_ifft_w(const void* vr, const void* vi, void* out, const float2* tab, int rows,
                          int n1, int n2, int io, int out_code, void* stream) {
  using bf = __nv_bfloat16;
  switch (io * 3 + out_code) {
    case F32 * 3 + F32: return run<float, float>(vr, vi, out, tab, rows, n1, n2, stream);
    case F32 * 3 + BF16: return run<float, bf>(vr, vi, out, tab, rows, n1, n2, stream);
    case BF16 * 3 + F32: return run<bf, float>(vr, vi, out, tab, rows, n1, n2, stream);
    case BF16 * 3 + BF16: return run<bf, bf>(vr, vi, out, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
