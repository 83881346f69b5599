// K9: v2 post-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `irfft_w_dual`
// (kernel `_w_rinv_dual_kernel`).  Per row:
//   lane 0 of the a0 / a1 half spectra <- the dc_patch values (p0*, p1*)
//   image = inverse packed-real W transform of a0
//   fwd   = inverse packed-real W transform of a1
// both stored.  The dual inverse half of K6 (w_dual_state.cu) without its
// X / v update: the v2 placement carries fwd through device memory to the
// next iteration's K8.  Rows may be the rows of a stack of P planes.
//
// Storage: the spectra, image and fwd in the io type TI (f32 or bf16);
// the patch columns in f32, one value per row (the JAX kernel's (m, 128)
// column operands use only column 0).
//
// Bound on the H100: bytes (4 half planes read, 2 full planes written;
// the two W cores of a row do 72 complex multiply-adds per point at
// 12 MP).  One block per row runs w_inv_core twice through the two shared
// row buffers (about 69 KB at 12 MP, three blocks per SM).
#include "lpt_dft.cuh"

using namespace lpt;

template <typename TI, bool kGen>
__global__ void __launch_bounds__(256, 3) irfft_w_dual_kernel(
    const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
    const TI* __restrict__ a1i, const float* __restrict__ p0r, const float* __restrict__ p0i,
    const float* __restrict__ p1r, const float* __restrict__ p1i, TI* __restrict__ img,
    TI* __restrict__ fwd, const float2* __restrict__ tab, int m, int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<TI>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  __syncthreads();
  const int r = blockIdx.x;
  const size_t hr = (size_t)r * m, fr = 2 * hr;
  const float2* X =
      w_inv_core<TI, V, kGen>(a0r + hr, a0i + hr, make_float2(p0r[r], p0i[r]), A, B, p, R);
  store_row<TI, V>(X, img + fr, m);
  __syncthreads();
  const float2* F =
      w_inv_core<TI, V, kGen>(a1r + hr, a1i + hr, make_float2(p1r[r], p1i[r]), A, B, p, R);
  store_row<TI, V>(F, fwd + fr, m);
}

template <typename TI>
static int run(const void* const* in, const float* const* cols, void* img, void* fwd,
               const float2* tab, int rows, int m, int n1, int n2, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<TI>()) ? irfft_w_dual_kernel<TI, true>
                                                       : irfft_w_dual_kernel<TI, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TI*)in[2], (const TI*)in[3], cols[0],
                cols[1], cols[2], cols[3], (TI*)img, (TI*)fwd, tab, m, n1, n2);
}

// rows: the rows of all planes.  io: storage code of the spectra, image
// and fwd (F32 or BF16).
extern "C" int lpt_irfft_w_dual(const void* a0r, const void* a0i, const void* a1r,
                                const void* a1i, const float* p0r, const float* p0i,
                                const float* p1r, const float* p1i, void* img, void* fwd,
                                const float2* tab, int rows, int m, int n1, int n2, int io,
                                void* stream) {
  const void* in[4] = {a0r, a0i, a1r, a1i};
  const float* cols[4] = {p0r, p0i, p1r, p1i};
  switch (io) {
    case F32: return run<float>(in, cols, img, fwd, tab, rows, m, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(in, cols, img, fwd, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
