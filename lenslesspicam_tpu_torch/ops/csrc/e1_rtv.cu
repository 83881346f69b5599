// K3: v3 pre-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `e1_rtv` (kernel
// `_e1rtv_kernel`) at f32 carries.  Per row r of the padded grid (planes
// in the even/odd split lane layout, periodic in both axes):
//   a0' = mu2 soft(psi0 + eta0/mu2, tau/mu2) - eta0, eta0 = mu2 psi0 - a0,
//         psi0 = img[r-1] - img[r]
//   a1' likewise along W, psi1 = roll(img, +1) - img
//   b'  = mu3 max(rho/mu3 + img, 0) - rho, rho = mu3 img - b
//   rk  = b' + (a0'[r+1] - a0'[r]) + (roll(a1', -1) - a1')
// then the forward packed-real W transform of rk (K1's core).  The halo
// rows (img r-1 and r+1, a0 r+1) are read straight from device memory, so
// no block depends on another; a0' of row r+1 is recomputed here.  The f32
// saturation channel is zero and is not computed.
//
// Bound on the H100: bytes (4 planes read, 3 planes and 2 half planes
// written).  The halo rows are read again by the neighbouring rows'
// blocks (mostly from L2), the price of blocks that do not depend on each
// other; rk stays in shared memory for the W core (see rfft_w.cu).
#include "lpt_dft.cuh"

using namespace lpt;

__device__ __forceinline__ float soft(float x, float thr) {
  return copysignf(fmaxf(fabsf(x) - thr, 0.f), x);
}

__global__ void __launch_bounds__(256, 3) e1_rtv_kernel(
    const float* __restrict__ img, const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ b, float* __restrict__ rkr, float* __restrict__ rki,
    float* __restrict__ a0o, float* __restrict__ a1o, float* __restrict__ bo,
    const float2* __restrict__ tab, int rows, int m, int n1, int n2, float mu2, float mu3,
    float tau) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int n = 2 * m;
  const int r = blockIdx.x;
  const size_t rc = (size_t)r * n, rp = (size_t)((r + rows - 1) % rows) * n,
               rn = (size_t)((r + 1) % rows) * n;
  const float thr = tau / mu2;
  float* a1s = reinterpret_cast<float*>(B);
#pragma unroll 4
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    // roll(+1) in split lanes: new_even[j] = odd[j-1], new_odd[j] = even[j]
    const int q1 = q < m ? m + (q ? q - 1 : m - 1) : q - m;
    const float x = img[rc + q];
    const float psi1 = img[rc + q1] - x;
    const float eta1 = mu2 * psi1 - a1[rc + q];
    const float a = mu2 * soft(psi1 + eta1 / mu2, thr) - eta1;
    a1o[rc + q] = a;
    a1s[q] = a;
  }
  __syncthreads();
  float* rk = reinterpret_cast<float*>(A);
#pragma unroll 4
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const float x = img[rc + q];
    const float psi_c = img[rp + q] - x;
    const float eta_c = mu2 * psi_c - a0[rc + q];
    const float a0c = mu2 * soft(psi_c + eta_c / mu2, thr) - eta_c;
    const float psi_n = x - img[rn + q];
    const float eta_n = mu2 * psi_n - a0[rn + q];
    const float a0n = mu2 * soft(psi_n + eta_n / mu2, thr) - eta_n;
    a0o[rc + q] = a0c;
    // roll(-1) in split lanes: new_even[j] = odd[j], new_odd[j] = even[j+1]
    const int q1 = q < m ? m + q : (q - m + 1 < m ? q - m + 1 : 0);
    const float adj1 = a1s[q1] - a1s[q];
    const float rho = mu3 * x - b[rc + q];
    const float w = fmaxf(rho / mu3 + x, 0.f);
    const float bn = mu3 * w - rho;
    bo[rc + q] = bn;
    rk[q < m ? 2 * q : 2 * (q - m) + 1] = bn + (a0n - a0c) + adj1;
  }
  __syncthreads();
  w_fwd_core(A, B, p, R, rkr + (size_t)r * m, rki + (size_t)r * m);
}

extern "C" int lpt_e1_rtv(const float* img, const float* a0, const float* a1, const float* b,
                          float* rkr, float* rki, float* a0o, float* a1o, float* bo,
                          const float2* tab, int rows, int m, int n1, int n2, float mu2,
                          float mu3, float tau, void* stream) {
  return launch(e1_rtv_kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream, img, a0, a1,
                b, rkr, rki, a0o, a1o, bo, tab, rows, m, n1, n2, mu2, mu3, tau);
}
