// K12: full-width forward W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `fft_w` (kernel
// `_w_fwd_kernel`, core `_w_fwd_core`).  (rows, W) real rows in natural
// order -> (rows, W) split-order spectrum, real and imaginary planes, both
// in the io type T (f32 or bf16); the transform runs in f32.
//
// Bound on the H100: bytes (one plane read, two written; the split DFT
// stages do 40 complex multiply-adds per point of a 12 MP row, W = 8192 =
// 64 x 128, and one complex DFT serves two rows).  One block holds two
// rows as z = x0 + i x1 in one padded shared row, transforms it once and
// separates the two spectra through the mirror (`store_two_spectra`): the
// plane is read once and both spectra written once.  An 8192-point complex
// row and its second buffer take 134 KB of shared memory, so one block of
// 512 threads runs per SM.
#include "lpt_dft.cuh"

using namespace lpt;

template <typename T>
__global__ void __launch_bounds__(FW_THREADS, 1)
    fft_w_kernel(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                 const float2* __restrict__ tab, int rows, int n1, int n2) {
  constexpr int V = vec_len<T>();
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
  const float2* P = c_fwd_core(A, B, p, R);
  store_two_spectra<T, V>(P, p, zr + o0, zi + o0, two ? zr + o1 : nullptr, two ? zi + o1 : nullptr,
                          1.f / sc);
}

template <typename T>
static int run(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1, int n2,
               void* stream) {
  return launch(fft_w_kernel<T>, dim3((rows + 1) / 2), dim3(FW_THREADS), w_smem_bytes(n1, n2),
                stream, (const T*)x, (T*)zr, (T*)zi, tab, rows, n1, n2);
}

// rows: the rows of all planes; W = n1 * n2.  io: storage code of x, zr
// and zi (F32 or BF16).
extern "C" int lpt_fft_w(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1,
                         int n2, int io, void* stream) {
  switch (io) {
    case F32: return run<float>(x, zr, zi, tab, rows, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(x, zr, zi, tab, rows, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
