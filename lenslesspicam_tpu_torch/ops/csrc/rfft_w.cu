// K1: packed-real forward W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `rfft_w` (:1810; kernel
// `_w_rfwd_kernel` :1760, core `_w_rfwd_core` :1518).  (rows, N) real rows
// in the even/odd split lane layout -> (rows, N/2) half spectrum, real and
// imaginary planes, split order, Z[N/2] packed into Im of lane 0.  Input
// and output are stored in the io type T (f32 or bf16); the transform
// runs in f32.  Bound on the H100: bytes, 16 per packed point at f32 and
// 8 at bf16 (402.7 / 201.3 MB at 12 MP, M = 4096).
//
// Two designs, chosen by M = N/2 alone in `lpt_rfft_w` (kernels.rfft_w_design;
// neither falls back on the other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): the
//   register-resident radix FFT of lpt_fft.cuh.  One block of M/16 threads
//   per row, 16 points a thread in registers, radix-16 passes (4096 =
//   16^3) exchanging through one padded shared buffer, twiddles
//   from the host table.  A point costs about 47 flops (three radix-16
//   butterfly passes of 11.75 and two twiddle multiplies of 5.6) against
//   the split design's 36 complex multiply-adds (144 FFMA).  At M = 4096
//   the block has 256 threads and 34.8 KB of shared memory, and ptxas
//   fits it in 64 registers without spills (the cap that leaves four
//   resident rows an SM; a cap of 48 for five spilled and ran slower, as
//   did a persistent grid prefetching the next row with cp.async).
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh): the
//   two-stage DFT of lpt_dft.cuh.  One block per row keeps the packed
//   row, both stage outputs and the mirror unpack in shared memory; the
//   row's load, DFT passes and store run one after another, so latency
//   hides only across blocks.  At 12 MP (69 KB, three blocks an SM) it
//   took 0.465 / 0.429 ms, f32 / bf16 io, against the radix design's
//   0.149 / 0.130 (H100 80GB HBM3, 700 W).
#include "lpt_fft.cuh"

using namespace lpt;

template <typename T, bool kGen>
__global__ void __launch_bounds__(256, 3) rfft_w_kernel(const T* __restrict__ x,
                                                     T* __restrict__ zr, T* __restrict__ zi,
                                                     const float2* __restrict__ tab, int m,
                                                     int n1, int n2) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const size_t row = blockIdx.x;
  const T* xr = x + row * 2 * m;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int j0 = threadIdx.x * V; j0 < m; j0 += blockDim.x * V) {
    float ev[V], od[V];
    ldv<V>(xr + j0, ev);
    ldv<V>(xr + m + j0, od);
    rot(ev, s);
    rot(od, s);
#pragma unroll
    for (int k = 0; k < V; ++k) A[j0 + ((k + s) & (V - 1))] = make_float2(ev[k], od[k]);
  }
  __syncthreads();
  w_fwd_core<T, V, kGen>(A, B, p, R, zr + row * m, zi + row * m);
}

template <typename T>
static int run(const void* x, void* zr, void* zi, const float2* tab, int rows, int m, int n1,
               int n2, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<T>()) ? rfft_w_kernel<T, true>
                                                      : rfft_w_kernel<T, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream, (const T*)x,
                (T*)zr, (T*)zi, tab, m, n1, n2);
}

template <typename T, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? 4 : 1)
    rfft_w_radix_kernel(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                        const float2* __restrict__ e, const float2* __restrict__ tw, int n1,
                        int n2) {
  extern __shared__ float2 sm[];
  const size_t row = blockIdx.x;
  fft::rfft_row<T, M>(x + row * 2 * M, zr + row * M, zi + row * M, e, tw, n1, n2, sm);
}

// The table: the split design's [r1f | r2f | r1i | r2i | Tf | Ti | E]
// (make_plan), then the radix twiddles (and the natural-order unpack
// factors, which K1 does not read: fft::RTable).
template <int M>
static int run_radix(const void* x, void* zr, void* zi, const float2* tab, int rows, int n1,
                     int n2, int io, void* stream) {
  const float2* e = make_plan(tab, n1, n2).e;
  const float2* tw = e + M;
  const size_t smem = fft::smem_bytes(M, n1, n2);
  const dim3 block(fft::Plan<M>::THREADS);
  switch (io) {
    case F32:
      return launch(rfft_w_radix_kernel<float, M>, dim3(rows), block, smem, stream,
                    (const float*)x, (float*)zr, (float*)zi, e, tw, n1, n2);
    case BF16:
      return launch(rfft_w_radix_kernel<__nv_bfloat16, M>, dim3(rows), block, smem, stream,
                    (const __nv_bfloat16*)x, (__nv_bfloat16*)zr, (__nv_bfloat16*)zi, e, tw,
                    n1, n2);
    default: return (int)cudaErrorInvalidValue;
  }
}

// io: storage code of x, zr and zi (F32 or BF16).  The design is chosen by
// m alone (see the header note).
extern "C" int lpt_rfft_w(const void* x, void* zr, void* zi, const float2* tab, int rows, int m,
                          int n1, int n2, int io, void* stream) {
  switch (m) {
    case 64: return run_radix<64>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 128: return run_radix<128>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 256: return run_radix<256>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 512: return run_radix<512>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 1024: return run_radix<1024>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 2048: return run_radix<2048>(x, zr, zi, tab, rows, n1, n2, io, stream);
    case 4096: return run_radix<4096>(x, zr, zi, tab, rows, n1, n2, io, stream);
    default: break;
  }
  switch (io) {
    case F32: return run<float>(x, zr, zi, tab, rows, m, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(x, zr, zi, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
