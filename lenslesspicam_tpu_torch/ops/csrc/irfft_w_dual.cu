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
// Bound on the H100: bytes (4 half planes read, 2 full planes written).
// Two designs, chosen by M = N/2 alone in `lpt_irfft_w_dual` with K1's
// rule (kernels.irfft_w_dual_design = rfft_w_design; neither falls back on
// the other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): K2's radix
//   design once for each spectrum, one block of M/16 threads per row and
//   spectrum (grid rows x 2) on the radix FFT of lpt_fft.cuh:
//   `fft::irfft_row` of a0 (z0 = p0) stored as image by
//   `fft::store_split_row` in the blocks of blockIdx.y = 0, of a1 (z0 = p1)
//   into fwd in those of blockIdx.y = 1; one padded buffer of
//   fft::smem_bytes (34.8 KB at M = 4096) a block, 64 registers, no
//   spill.  0.3347 / 0.2803 ms at 12 MP, f32 / bf16 io; both rows in one
//   block (K6's first half twice) ran 0.4093 / 0.3402 at its best blocks
//   an SM (three for f32, two for bf16, 80-128 registers), 0.594 / 0.653
//   at four (64 registers, 284-488 B of spills) (H100 80GB HBM3, 700 W,
//   ab_kernels.py).
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   one block of 256 threads per row runs w_inv_core twice through the two
//   shared row buffers (about 69 KB at 12 MP, three blocks per SM; the two
//   W cores of a row do 72 complex multiply-adds per point there).  1.126
//   / 1.007 ms at 12 MP, f32 / bf16 io (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

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

// Blocks an SM the radix kernel is compiled for at M = 4096 (its
// __launch_bounds__; 256 threads a block): K2's choice, whose kernel this
// one is.
constexpr int kMinBlocks = 4;

template <typename TI, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? kMinBlocks : 1)
    irfft_w_dual_radix_kernel(const TI* __restrict__ a0r, const TI* __restrict__ a0i,
                              const TI* __restrict__ a1r, const TI* __restrict__ a1i,
                              const float* __restrict__ p0r, const float* __restrict__ p0i,
                              const float* __restrict__ p1r, const float* __restrict__ p1i,
                              TI* __restrict__ img, TI* __restrict__ fwd,
                              const float2* __restrict__ tab, int n1, int n2) {
  extern __shared__ float2 sm[];
  const fft::RTable<M> tb(tab, n1, n2);
  const int r = blockIdx.x;
  const bool one = blockIdx.y;  // the spectrum: a0 -> image, a1 -> fwd
  const size_t hr = (size_t)r * M;
  float2 x[fft::RADIX];
  fft::irfft_row<TI, M>((one ? a1r : a0r) + hr, (one ? a1i : a0i) + hr,
                        one ? make_float2(p1r[r], p1i[r]) : make_float2(p0r[r], p0i[r]), tb.en,
                        tb.tw, n1, n2, sm, x);
  fft::store_split_row<TI, M>(x, (one ? fwd : img) + 2 * hr);
}

template <typename TI, int M>
static int run_radix(const void* const* in, const float* const* cols, void* img, void* fwd,
                     const float2* tab, int rows, int n1, int n2, void* stream) {
  return launch(irfft_w_dual_radix_kernel<TI, M>, dim3(rows, 2), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const TI*)in[0], (const TI*)in[1],
                (const TI*)in[2], (const TI*)in[3], cols[0], cols[1], cols[2], cols[3], (TI*)img,
                (TI*)fwd, tab, n1, n2);
}

// The design by m alone (see the header note).
template <typename TI>
static int dispatch(const void* const* in, const float* const* cols, void* img, void* fwd,
                    const float2* tab, int rows, int m, int n1, int n2, void* stream) {
#define LPT_E9R(M) return run_radix<TI, M>(in, cols, img, fwd, tab, rows, n1, n2, stream)
  switch (m) {
    case 64: LPT_E9R(64);
    case 128: LPT_E9R(128);
    case 256: LPT_E9R(256);
    case 512: LPT_E9R(512);
    case 1024: LPT_E9R(1024);
    case 2048: LPT_E9R(2048);
    case 4096: LPT_E9R(4096);
    default: return run<TI>(in, cols, img, fwd, tab, rows, m, n1, n2, stream);
  }
#undef LPT_E9R
}

// rows: the rows of all planes.  io: storage code of the spectra, image
// and fwd (F32 or BF16).  tab: the split table, followed in the radix
// design by the radix twiddles and the natural-order unpack factors
// (fft::RTable).
extern "C" int lpt_irfft_w_dual(const void* a0r, const void* a0i, const void* a1r,
                                const void* a1i, const float* p0r, const float* p0i,
                                const float* p1r, const float* p1i, void* img, void* fwd,
                                const float2* tab, int rows, int m, int n1, int n2, int io,
                                void* stream) {
  const void* in[4] = {a0r, a0i, a1r, a1i};
  const float* cols[4] = {p0r, p0i, p1r, p1i};
  switch (io) {
    case F32: return dispatch<float>(in, cols, img, fwd, tab, rows, m, n1, n2, stream);
    case BF16: return dispatch<__nv_bfloat16>(in, cols, img, fwd, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
