// K1: packed-real forward W transform.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `rfft_w` (kernel
// `_w_rfwd_kernel`, core `_w_rfwd_core`).  (rows, N) real rows in the
// even/odd split lane layout -> (rows, N/2) half spectrum, real and
// imaginary planes, split order, Z[N/2] packed into Im of lane 0.
//
// Bound on the H100: bytes (16 per packed point; the split DFT stages do
// 36 complex multiply-adds per point at 12 MP, about a quarter of the
// byte bound's time at the f32 FFMA peak).  One block per row keeps the
// packed row, both stage outputs and the mirror unpack in shared memory:
// the plane is read once and the half spectrum written once.  The row's
// load, DFT passes and store run one after another, so the kernel hides
// latency only across blocks: registers are capped for three blocks per
// SM, which the 69 KB of shared memory per block allows.
#include "lpt_dft.cuh"

using namespace lpt;

__global__ void __launch_bounds__(256, 3) rfft_w_kernel(const float* __restrict__ x,
                                                     float* __restrict__ zr,
                                                     float* __restrict__ zi,
                                                     const float2* __restrict__ tab, int m,
                                                     int n1, int n2) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const size_t row = blockIdx.x;
  const float* xr = x + row * 2 * m;
#pragma unroll 4
  for (int j = threadIdx.x; j < m; j += blockDim.x) A[j] = make_float2(xr[j], xr[m + j]);
  __syncthreads();
  w_fwd_core(A, B, p, R, zr + row * m, zi + row * m);
}

extern "C" int lpt_rfft_w(const float* x, float* zr, float* zi, const float2* tab, int rows,
                          int m, int n1, int n2, void* stream) {
  return launch(rfft_w_kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream, x, zr, zi,
                tab, m, n1, n2);
}
