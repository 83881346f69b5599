// K13: full-width inverse W transform, real output.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `ifft_w` (:812; kernel
// `_w_inv_kernel`, core `_w_inv_core`).  (rows, W) split-order spectrum,
// real and imaginary planes in the io type TI -> (rows, W) real part of
// the inverse transform, natural order, scaled 1/W, stored as TO (f32
// unless the caller asks for bf16).  No spectrum is assumed Hermitian.
//
// Bound on the H100: bytes (two planes read, one written: 604.0 MB at 12
// MP in f32, 302.0 MB bf16 in and out).  One block serves two rows r0 and
// r0 + 1: the inverse of C = herm(a0) + i s herm(a1), a0 = row r0 and a1
// = row r0 + 1 (s the balancing power of two), holds both real outputs
// as its real and imaginary parts.  With an odd row count the last block
// has one row: a1 = a0, and only the real part is stored.
//
// Two designs, chosen by W alone in `lpt_ifft_w` (kernels.ifft_w_design;
// neither falls back on the other):
//
// radix (W a power of two from 512 to 8192; the 12 MP grid's 8192): K11's
//   row function `fft::ifft_two_rows` of lpt_fft.cuh as it is, on two
//   rows instead of one row's two spectra.  One block of W/16 threads for
//   each pair of rows, 16 points a thread in registers, 8192 = 16 * 16 *
//   16 * 2 in four forward passes on conj C; one padded buffer of W +
//   W/16 float2 (69.6 KB at 8192) and __launch_bounds__(512, 2): two
//   blocks an SM at 64 registers.  A block does K11's per-block work over
//   half as many blocks.
// split (any other W, any factors n1 x n2; `general_form` in lpt_dft.cuh): the
//   two-stage DFT of lpt_dft.cuh.  One block of 512 threads per pair of
//   rows forms C in two padded (n1+1)(n2+1) buffers (`load_two_spectra`)
//   beside the roots: 134 KB at 12 MP, one block per SM, its load, DFT
//   passes and store one after another.  At 12 MP it took 0.884 / 0.713
//   ms, f32 / bf16 in and f32 out (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

using namespace lpt;

template <typename TI, typename TO, bool kGen>
__global__ void __launch_bounds__(FW_THREADS, 1)
    ifft_w_kernel(const TI* __restrict__ vr, const TI* __restrict__ vi, TO* __restrict__ out,
                  const float2* __restrict__ tab, int rows, int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<TI, TO>();
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
  const float2* X = c_inv_core<kGen>(A, B, p, R, 1.f / (float)n);
  store_two_rows<TO, V>(X, n, out + o0, two ? out + o1 : nullptr, 1.f / sc);
}

template <typename TI, typename TO>
static int run(const void* vr, const void* vi, void* out, const float2* tab, int rows, int n1,
               int n2, void* stream) {
  auto kernel = general_form(n1, n2, n1 * n2, vec_len<TI, TO>())
                    ? ifft_w_kernel<TI, TO, true>
                    : ifft_w_kernel<TI, TO, false>;
  return launch(kernel, dim3((rows + 1) / 2), dim3(FW_THREADS), w_smem_bytes(n1, n2), stream,
                (const TI*)vr, (const TI*)vi, (TO*)out, tab, rows, n1, n2);
}

template <typename TI, typename TO, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, 1024 / fft::Plan<M>::THREADS)
    ifft_w_radix_kernel(const TI* __restrict__ vr, const TI* __restrict__ vi,
                        TO* __restrict__ out, const float2* __restrict__ tw, int rows) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const int r0 = 2 * blockIdx.x;
  const size_t o0 = (size_t)r0 * M, o1 = o0 + M;
  if (r0 + 1 < rows)
    fft::ifft_two_rows<TI, M, TO>(vr + o0, vi + o0, vr + o1, vi + o1, out + o0, out + o1, tw, sm);
  else  // the last row of an odd count
    fft::ifft_two_rows<TI, M, TO, false>(vr + o0, vi + o0, vr + o0, vi + o0, out + o0, nullptr,
                                         tw, sm);
}

// The table: the split design's [r1f | r2f | r1i | r2i | Tf | Ti]
// (make_plan, no unpack factors), then the radix twiddles of length W.
template <typename TI, typename TO, int M>
static int run_radix(const void* vr, const void* vi, void* out, const float2* tab, int rows,
                     int n1, int n2, void* stream) {
  if (n2 != 128 || n1 != M / 128) return (int)cudaErrorInvalidValue;
  return launch(ifft_w_radix_kernel<TI, TO, M>, dim3((rows + 1) / 2),
                dim3(fft::Plan<M>::THREADS), fft::inv_smem_bytes(M), stream, (const TI*)vr,
                (const TI*)vi, (TO*)out, tab + 2 * (n1 + n2) + 2 * M, rows);
}

template <typename TI, typename TO>
static int dispatch(const void* vr, const void* vi, void* out, const float2* tab, int rows,
                    int n1, int n2, void* stream) {
  switch (n1 * n2) {
    case 512: return run_radix<TI, TO, 512>(vr, vi, out, tab, rows, n1, n2, stream);
    case 1024: return run_radix<TI, TO, 1024>(vr, vi, out, tab, rows, n1, n2, stream);
    case 2048: return run_radix<TI, TO, 2048>(vr, vi, out, tab, rows, n1, n2, stream);
    case 4096: return run_radix<TI, TO, 4096>(vr, vi, out, tab, rows, n1, n2, stream);
    case 8192: return run_radix<TI, TO, 8192>(vr, vi, out, tab, rows, n1, n2, stream);
    default: return run<TI, TO>(vr, vi, out, tab, rows, n1, n2, stream);
  }
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of vr and
// vi; out_code: that of the output (F32 or BF16).  The design is chosen by
// W alone (see the header note).
extern "C" int lpt_ifft_w(const void* vr, const void* vi, void* out, const float2* tab, int rows,
                          int n1, int n2, int io, int out_code, void* stream) {
  using bf = __nv_bfloat16;
  switch (io * 3 + out_code) {
    case F32 * 3 + F32: return dispatch<float, float>(vr, vi, out, tab, rows, n1, n2, stream);
    case F32 * 3 + BF16: return dispatch<float, bf>(vr, vi, out, tab, rows, n1, n2, stream);
    case BF16 * 3 + F32: return dispatch<bf, float>(vr, vi, out, tab, rows, n1, n2, stream);
    case BF16 * 3 + BF16: return dispatch<bf, bf>(vr, vi, out, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
