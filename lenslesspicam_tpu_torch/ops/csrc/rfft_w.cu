// K1: packed-real forward W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `rfft_w` (kernel
// `_w_rfwd_kernel`, core `_w_rfwd_core`).  (rows, N) real rows in the
// even/odd split lane layout -> (rows, N/2) half spectrum, real and
// imaginary planes, split order, Z[N/2] packed into Im of lane 0.  Input
// and output are stored in the io type T (f32 or bf16); the transform
// runs in f32.
//
// Bound on the H100: bytes (16 per packed point at f32, 8 at bf16; the
// split DFT stages do 36 complex multiply-adds per point at 12 MP, about a
// quarter of the f32 byte bound's time at the f32 FFMA peak).  One block
// per row keeps the packed row, both stage outputs and the mirror unpack
// in shared memory: the plane is read once and the half spectrum written
// once.  The row's load, DFT passes and store run one after another, so
// the kernel hides latency only across blocks: registers are capped for
// three blocks per SM, which the 69 KB of shared memory per block allows.
#include "lpt_dft.cuh"

using namespace lpt;

template <typename T>
__global__ void __launch_bounds__(256, 3) rfft_w_kernel(const T* __restrict__ x,
                                                     T* __restrict__ zr, T* __restrict__ zi,
                                                     const float2* __restrict__ tab, int m,
                                                     int n1, int n2) {
  constexpr int V = vec_len<T>();
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
  w_fwd_core<T, V>(A, B, p, R, zr + row * m, zi + row * m);
}

template <typename T>
static int run(const void* x, void* zr, void* zi, const float2* tab, int rows, int m, int n1,
               int n2, void* stream) {
  return launch(rfft_w_kernel<T>, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const T*)x, (T*)zr, (T*)zi, tab, m, n1, n2);
}

// io: storage code of x, zr and zi (F32 or BF16).
extern "C" int lpt_rfft_w(const void* x, void* zr, void* zi, const float2* tab, int rows, int m,
                          int n1, int n2, int io, void* stream) {
  switch (io) {
    case F32: return run<float>(x, zr, zi, tab, rows, m, n1, n2, stream);
    case BF16: return run<__nv_bfloat16>(x, zr, zi, tab, rows, m, n1, n2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
