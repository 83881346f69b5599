// K11: full-width post-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `ifft_w_dual` (kernel
// `_w_inv_dual_kernel`).  Per row:
//   image = Re ifft_W(a0),  fwd = Re ifft_W(a1)
// from the split-order spectra a0, a1 (real and imaginary planes), both
// stored in natural order.  No spectrum is assumed Hermitian.  Rows may be
// the rows of a stack of P planes.
//
// Storage: spectra, image and fwd in the io type TI (f32 or bf16).
//
// Bound on the H100: bytes (4 planes read, 2 written; 40 complex
// multiply-adds per point at 12 MP for the one complex DFT of a row).  The
// two inverses are one: C = herm(a0) + i herm(a1) is formed in shared
// memory (`load_two_spectra`) and its inverse holds image in its real and
// fwd in its imaginary part.  134 KB of shared memory at 12 MP: one block
// of 512 threads per SM.
#include "lpt_dft.cuh"

using namespace lpt;

template <typename TI>
__global__ void __launch_bounds__(FW_THREADS, 1) ifft_w_dual_kernel(
    const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
    const TI* __restrict__ a1i, TI* __restrict__ img, TI* __restrict__ fwd,
    const float2* __restrict__ tab, int n1, int n2) {
  constexpr int V = vec_len<TI>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int n = p.n;
  const size_t o = (size_t)blockIdx.x * n;
  const float sc = load_two_spectra<TI, V>(a0r + o, a0i + o, a1r + o, a1i + o, A, B, p);
  const float2* X = c_inv_core(A, B, p, R, 1.f / (float)n);
  store_two_rows<TI, V>(X, n, img + o, fwd + o, 1.f / sc);
}

template <typename TI>
static int run(const void* const* in, void* img, void* fwd, const float2* tab, int rows, int n1,
               int n2, void* stream) {
  return launch(ifft_w_dual_kernel<TI>, dim3(rows), dim3(FW_THREADS), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TI*)in[2], (const TI*)in[3], (TI*)img,
                (TI*)fwd, tab, n1, n2);
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of the
// spectra, image and fwd (F32 or BF16).
extern "C" int lpt_ifft_w_dual(const void* a0r, const void* a0i, const void* a1r, const void* a1i,
                               void* img, void* fwd, const float2* tab, int rows, int n1, int n2,
                               int io, void* stream) {
  const void* in[4] = {a0r, a0i, a1r, a1i};
  switch (io) {
    case F32: return run<float>(in, img, fwd, tab, rows, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(in, img, fwd, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
