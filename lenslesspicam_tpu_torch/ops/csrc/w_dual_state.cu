// K6: v3 post-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `irfft_w_dual_state`
// (kernel `_w_rinv_dual_state_kernel`) at f32 carries, without the
// saturation channel (f32 carries cannot clip).  Per row:
//   lane 0 of the a0 / a1 half spectra <- the dc_patch values (p0*, p1*)
//   image = inverse packed-real W transform of a0 (stored)
//   fwd   = inverse packed-real W transform of a1 (never stored)
//   xi = mu1 fwd - v,  X = xdv (xi + mu1 fwd + dp),  v' = mu1 X - xi,
//   xdv = c_out + (c_in - c_out) mask
//   the forward packed-real W transform of v' (K1's core).
//
// Bound on the H100: bytes (4 half-plane and 3 full-plane reads, 2
// full-plane and 2 half-plane writes, each once; the three W cores of a
// row do 108 complex multiply-adds per point at 12 MP).  One block per
// row holds the row's spectra, fwd and v' in two shared buffers (about
// 69 KB at 12 MP, three blocks per SM): fwd is turned into v' in place and
// fed straight to the forward core.
#include "lpt_dft.cuh"

using namespace lpt;

__global__ void __launch_bounds__(256, 3) w_dual_state_kernel(
    const float* __restrict__ a0r, const float* __restrict__ a0i, const float* __restrict__ a1r,
    const float* __restrict__ a1i, const float* __restrict__ p0r, const float* __restrict__ p0i,
    const float* __restrict__ p1r, const float* __restrict__ p1i, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ dp, float* __restrict__ img,
    float* __restrict__ vo, float* __restrict__ vwr, float* __restrict__ vwi,
    const float2* __restrict__ tab, int m, int n1, int n2, float mu1, float c_out,
    float c_diff) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  __syncthreads();
  const int r = blockIdx.x, n = 2 * m;
  const size_t hr = (size_t)r * m, fr = (size_t)r * n;
  const float2* X = w_inv_core(a0r + hr, a0i + hr, make_float2(p0r[r], p0i[r]), A, B, p, R);
#pragma unroll 4
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float2 x = X[j];
    img[fr + j] = x.x;
    img[fr + m + j] = x.y;
  }
  __syncthreads();
  float2* F = w_inv_core(a1r + hr, a1i + hr, make_float2(p1r[r], p1i[r]), A, B, p, R);
  float* f = reinterpret_cast<float*>(F);
#pragma unroll 4
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int s = q < m ? 2 * q : 2 * (q - m) + 1;
    const float fw = f[s];
    const float xi = mu1 * fw - v[fr + q];
    const float xdv = c_out + c_diff * mask[fr + q];
    const float X = xdv * (xi + mu1 * fw + dp[fr + q]);
    const float vn = mu1 * X - xi;
    vo[fr + q] = vn;
    f[s] = vn;
  }
  __syncthreads();
  w_fwd_core(F, F == A ? B : A, p, R, vwr + hr, vwi + hr);
}

extern "C" int lpt_w_dual_state(const float* a0r, const float* a0i, const float* a1r,
                                const float* a1i, const float* p0r, const float* p0i,
                                const float* p1r, const float* p1i, const float* v,
                                const float* mask, const float* dp, float* img, float* vo,
                                float* vwr, float* vwi, const float2* tab, int rows, int m,
                                int n1, int n2, float mu1, float c_out, float c_diff,
                                void* stream) {
  return launch(w_dual_state_kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream, a0r,
                a0i, a1r, a1i, p0r, p0i, p1r, p1i, v, mask, dp, img, vo, vwr, vwi, tab, m, n1,
                n2, mu1, c_out, c_diff);
}
