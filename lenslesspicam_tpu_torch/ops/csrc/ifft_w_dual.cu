// K11: full-width post-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `ifft_w_dual` (:1329;
// kernel `_w_inv_dual_kernel` :1265, core `_w_inv_core` :735).  Per row:
//   image = Re ifft_W(a0),  fwd = Re ifft_W(a1)
// from the split-order spectra a0, a1 (real and imaginary planes), both
// stored in natural order.  No spectrum is assumed Hermitian.  Rows may be
// the rows of a stack of P planes.
//
// Storage: spectra, image and fwd in the io type TI (f32 or bf16).
//
// Bound on the H100: bytes (4 planes read, 2 written: 1208.0 / 604.0 MB at
// 12 MP).  The two inverses are one: the inverse of C = herm(a0) + i s
// herm(a1) holds image in its real and fwd (times the balancing power of
// two s) in its imaginary part.
//
// Two designs, chosen by W alone in `lpt_ifft_w_dual`
// (kernels.ifft_w_dual_design; neither falls back on the other):
//
// radix (W a power of two from 512 to 8192; the 12 MP grid's 8192): the
//   register-resident radix FFT of lpt_fft.cuh, run forward on conj C.
//   One block of W/16 threads a row, 16 points a thread in registers,
//   8192 = 16 * 16 * 16 * 2 in four passes.  The mirror pairing runs on
//   the loads (a vector and its mirror are both aligned 16-byte loads),
//   so one padded buffer of W + W/16 float2 (69.6 KB at 8192) holds the
//   half spectra, the passes' exchanges and the natural-order exchange,
//   and __launch_bounds__(512, 2) keeps two rows an SM (64 registers).
//   About 60 flops a point (three radix-16 passes of 11.75, a radix-2 one
//   of 2, three twiddle multiplies of 5.6, the mirror sums, gather and
//   scales) against the split design's 320 (40 complex multiply-adds).
//   At 12 MP it takes 0.531 / 0.401 ms, f32 / bf16 io (H100 80GB HBM3,
//   700 W): 76 % / 51 % of the bytes' time at the measured 2.982 TB/s.
//   The block max of the balance costs at most 5 % of it (a shuffle tree
//   would save 2 %); the rest is the passes' and exchanges' work.
// split (any other W, any factors n1 x n2; `general_form` in lpt_dft.cuh): the
//   two-stage DFT of lpt_dft.cuh.  One block of 512 threads per row keeps
//   two padded (n1+1)(n2+1) buffers and the roots in shared memory
//   (`load_two_spectra` forms C in them): 134 KB at 12 MP, one block per
//   SM, its load, DFT passes and store one after another.  At 12 MP it
//   took 1.760 / 1.313 ms, f32 / bf16 io (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

using namespace lpt;

template <typename TI, bool kGen>
__global__ void __launch_bounds__(FW_THREADS, 1) ifft_w_dual_kernel(
    const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
    const TI* __restrict__ a1i, TI* __restrict__ img, TI* __restrict__ fwd,
    const float2* __restrict__ tab, int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<TI>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int n = p.n;
  const size_t o = (size_t)blockIdx.x * n;
  const float sc = load_two_spectra<TI, V>(a0r + o, a0i + o, a1r + o, a1i + o, A, B, p);
  const float2* X = c_inv_core<kGen>(A, B, p, R, 1.f / (float)n);
  store_two_rows<TI, V>(X, n, img + o, fwd + o, 1.f / sc);
}

template <typename TI>
static int run(const void* const* in, void* img, void* fwd, const float2* tab, int rows, int n1,
               int n2, void* stream) {
  auto kernel = general_form(n1, n2, n1 * n2, vec_len<TI>()) ? ifft_w_dual_kernel<TI, true>
                                                             : ifft_w_dual_kernel<TI, false>;
  return launch(kernel, dim3(rows), dim3(FW_THREADS), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TI*)in[2], (const TI*)in[3], (TI*)img,
                (TI*)fwd, tab, n1, n2);
}

template <typename TI, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, 1024 / fft::Plan<M>::THREADS)
    ifft_w_dual_radix_kernel(const TI* __restrict__ a0r, const TI* __restrict__ a0i,
                             const TI* __restrict__ a1r, const TI* __restrict__ a1i,
                             TI* __restrict__ img, TI* __restrict__ fwd,
                             const float2* __restrict__ tw) {
  extern __shared__ float4 smem4[];
  const size_t o = (size_t)blockIdx.x * M;
  fft::ifft_two_rows<TI, M>(a0r + o, a0i + o, a1r + o, a1i + o, img + o, fwd + o, tw,
                            reinterpret_cast<float2*>(smem4));
}

// The table: the split design's [r1f | r2f | r1i | r2i | Tf | Ti]
// (make_plan, no unpack factors), then the radix twiddles of length W.
template <int M>
static int run_radix(const void* const* in, void* img, void* fwd, const float2* tab, int rows,
                     int n1, int n2, int io, void* stream) {
  if (n2 != 128 || n1 != M / 128) return (int)cudaErrorInvalidValue;
  const float2* tw = tab + 2 * (n1 + n2) + 2 * M;
  const size_t smem = fft::inv_smem_bytes(M);
  const dim3 block(fft::Plan<M>::THREADS);
  switch (io) {
    case F32:
      return launch(ifft_w_dual_radix_kernel<float, M>, dim3(rows), block, smem, stream,
                    (const float*)in[0], (const float*)in[1], (const float*)in[2],
                    (const float*)in[3], (float*)img, (float*)fwd, tw);
    case BF16: {
      using B = __nv_bfloat16;
      return launch(ifft_w_dual_radix_kernel<B, M>, dim3(rows), block, smem, stream,
                    (const B*)in[0], (const B*)in[1], (const B*)in[2], (const B*)in[3], (B*)img,
                    (B*)fwd, tw);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of the
// spectra, image and fwd (F32 or BF16).  The design is chosen by W alone
// (see the header note).
extern "C" int lpt_ifft_w_dual(const void* a0r, const void* a0i, const void* a1r, const void* a1i,
                               void* img, void* fwd, const float2* tab, int rows, int n1, int n2,
                               int io, void* stream) {
  const void* in[4] = {a0r, a0i, a1r, a1i};
  switch (n1 * n2) {
    case 512: return run_radix<512>(in, img, fwd, tab, rows, n1, n2, io, stream);
    case 1024: return run_radix<1024>(in, img, fwd, tab, rows, n1, n2, io, stream);
    case 2048: return run_radix<2048>(in, img, fwd, tab, rows, n1, n2, io, stream);
    case 4096: return run_radix<4096>(in, img, fwd, tab, rows, n1, n2, io, stream);
    case 8192: return run_radix<8192>(in, img, fwd, tab, rows, n1, n2, io, stream);
    default: break;
  }
  switch (io) {
    case F32: return run<float>(in, img, fwd, tab, rows, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(in, img, fwd, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
