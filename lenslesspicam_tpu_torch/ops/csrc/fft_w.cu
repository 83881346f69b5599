// K12: full-width forward W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `fft_w` (:788; kernel
// `_w_fwd_kernel`, core `_w_fwd_core`).  (rows, W) real rows in natural
// order -> (rows, W) split-order spectrum, real and imaginary planes, both
// in the io type T (f32 or bf16); the transform runs in f32.
//
// Bound on the H100: bytes (one plane read, two written: 604.0 / 302.0 MB
// at 12 MP, f32 / bf16).  One block serves two rows: the transform of z =
// x0 + i s x1 (s the balancing power of two) gives both rows' spectra
// through the mirror, so the plane is read once and both spectra written
// once.  With an odd row count the last block's second row is zero and
// its spectra are not stored.
//
// Two designs, chosen by W alone in `lpt_fft_w` (kernels.fft_w_design;
// neither falls back on the other):
//
// radix (W a power of two from 512 to 8192; the 12 MP grid's 8192):
//   `fft::fft_two_real_rows` of lpt_fft.cuh, on K1's forward passes and
//   twiddle table.  One block of W/16 threads for each pair of rows, 16
//   points a thread in registers, 8192 = 16 * 16 * 16 * 2 in four passes;
//   pass 0 loads z straight from device memory and the balance is a block
//   max over those registers; one padded buffer of max(W + W/16, n1 (n2 +
//   1)) float2 (69.6 KB at 8192) holds the passes' exchanges and the
//   split-order spectrum the mirror store reads, and __launch_bounds__
//   (512, 2) keeps two blocks an SM at 64 registers.
// split (any other W, any factors n1 x n2; `general_form` in lpt_dft.cuh): the
//   two-stage DFT of lpt_dft.cuh.  One block of 512 threads holds z in one
//   padded shared row, balances it on shared memory (`balance_imag`),
//   transforms it (40 complex multiply-adds a point at 12 MP) and
//   separates the spectra (`store_two_spectra`); an 8192-point row and its
//   second buffer take 134 KB, one block per SM.  At 12 MP it took 0.743 /
//   0.572 ms, f32 / bf16 (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

using namespace lpt;

template <typename T, bool kGen>
__global__ void __launch_bounds__(FW_THREADS, 1)
    fft_w_kernel(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                 const float2* __restrict__ tab, int rows, int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int r0 = 2 * blockIdx.x, n = p.n;
  const bool two = r0 + 1 < rows;
  const size_t o0 = (size_t)r0 * n, o1 = o0 + n;
  load_two_rows<T, V>(x + o0, two ? x + o1 : nullptr, A, n);
  __syncthreads();
  const float sc = balance_imag(A, n);
  const float2* P = c_fwd_core<kGen>(A, B, p, R);
  store_two_spectra<T, V>(P, p, zr + o0, zi + o0, two ? zr + o1 : nullptr, two ? zi + o1 : nullptr,
                          1.f / sc);
}

template <typename T>
static int run(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1, int n2,
               void* stream) {
  auto kernel = general_form(n1, n2, n1 * n2, vec_len<T>()) ? fft_w_kernel<T, true>
                                                            : fft_w_kernel<T, false>;
  return launch(kernel, dim3((rows + 1) / 2), dim3(FW_THREADS), w_smem_bytes(n1, n2), stream,
                (const T*)x, (T*)zr, (T*)zi, tab, rows, n1, n2);
}

template <typename T, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, 1024 / fft::Plan<M>::THREADS)
    fft_w_radix_kernel(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                       const float2* __restrict__ tw, int rows) {
  extern __shared__ float2 sm[];
  const int r0 = 2 * blockIdx.x;
  const bool two = r0 + 1 < rows;
  const size_t o0 = (size_t)r0 * M, o1 = o0 + M;
  fft::fft_two_real_rows<T, M>(x + o0, two ? x + o1 : nullptr, zr + o0, zi + o0,
                               two ? zr + o1 : nullptr, two ? zi + o1 : nullptr, tw, sm);
}

// The table: the split design's [r1f | r2f | r1i | r2i | Tf | Ti]
// (make_plan, no unpack factors), then the radix twiddles of length W.
template <typename T, int M>
static int run_radix(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1,
                     int n2, void* stream) {
  if (n2 != 128 || n1 != M / 128) return (int)cudaErrorInvalidValue;
  return launch(fft_w_radix_kernel<T, M>, dim3((rows + 1) / 2), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const T*)x, (T*)zr, (T*)zi,
                tab + 2 * (n1 + n2) + 2 * M, rows);
}

template <typename T>
static int dispatch(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1,
                    int n2, void* stream) {
  switch (n1 * n2) {
    case 512: return run_radix<T, 512>(x, zr, zi, tab, rows, n1, n2, stream);
    case 1024: return run_radix<T, 1024>(x, zr, zi, tab, rows, n1, n2, stream);
    case 2048: return run_radix<T, 2048>(x, zr, zi, tab, rows, n1, n2, stream);
    case 4096: return run_radix<T, 4096>(x, zr, zi, tab, rows, n1, n2, stream);
    case 8192: return run_radix<T, 8192>(x, zr, zi, tab, rows, n1, n2, stream);
    default: return run<T>(x, zr, zi, tab, rows, n1, n2, stream);
  }
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of x, zr
// and zi (F32 or BF16).  The design is chosen by W alone (see the header
// note).
extern "C" int lpt_fft_w(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1,
                         int n2, int io, void* stream) {
  switch (io) {
    case F32: return dispatch<float>(x, zr, zi, tab, rows, n1, n2, stream);
    case BF16: return dispatch<__nv_bfloat16>(x, zr, zi, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
