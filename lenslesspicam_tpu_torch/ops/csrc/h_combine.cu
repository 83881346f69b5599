// K5: H-axis stage 2 of both ADMM planes, spectrum combine, and the
// inverse stage 2 of the combined spectrum and its H-filtered copy.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `_h_combine_dual_kernel`
// (the pallas_call inside `fft_h_combine_dual`).  Planes are viewed
// (n1, n2, W).  For each (k1, w):
//   a = F2 xa, b = F2 ya                       (forward stage 2 over j2)
//   F  = R (a + conj(H) b),  F1 = H F          (elementwise, f32)
//   a0 = F2inv F, a1 = F2inv F1                (inverse stage 2 over k2)
// F and F1 never leave the block.  R reaches 1/mu3 = 2.5e4 at the default
// mu; the combine is kept in f32 in the JAX kernel's order.
//
// Bound on the H100: bytes (44 per point; the four length-128 DFTs run as
// 8 x 16 split stages, 24 complex multiply-adds per point each).  A block
// takes one k1 and 32 consecutive lanes of W: loads and stores are runs of
// 32 contiguous floats; the three n2 x 32 tiles (96 KB at 12 MP) stay in
// shared memory.
#include "lpt_dft.cuh"

using namespace lpt;

constexpr int TW = 32;

__global__ void __launch_bounds__(256) h_combine_kernel(
    const float* __restrict__ xar, const float* __restrict__ xai, const float* __restrict__ yar,
    const float* __restrict__ yai, const float* __restrict__ hr, const float* __restrict__ hi,
    const float* __restrict__ rr, float* __restrict__ a0r, float* __restrict__ a0i,
    float* __restrict__ a1r, float* __restrict__ a1i, const float2* __restrict__ tab, int n1,
    int n2, int w) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const int tile = n2 * TW, cap = tile + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;  // r2f (n2) | r2i (n2)
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    R[i] = p.r2f[i];
    R[n2 + i] = p.r2i[i];
  }
  const int wtiles = w / TW;
  const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const size_t base = (size_t)k1 * n2 * w + w0;
#pragma unroll 4
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = base + (size_t)(i / TW) * w + (i % TW);
    S1[i] = make_float2(xar[g], xai[g]);
    S2[i] = make_float2(yar[g], yai[g]);
  }
  __syncthreads();
  // each stage leaves its result in one of the three tiles (see `dft`)
  float2* a = dft(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  float2* b = dft(S2, a == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  float2* t = (a != S1 && b != S1) ? S1 : ((a != S2 && b != S2) ? S2 : S3);
#pragma unroll 4
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = base + (size_t)(i / TW) * w + (i % TW);
    const float h_r = hr[g], h_i = hi[g], rv = rr[g];
    const float2 A = a[i], B = b[i];
    const float fr = rv * (A.x + h_r * B.x + h_i * B.y);
    const float fi = rv * (A.y + h_r * B.y - h_i * B.x);
    a[i] = make_float2(fr, fi);                                  // F
    b[i] = make_float2(fr * h_r - fi * h_i, fr * h_i + fi * h_r);  // H F
  }
  __syncthreads();
  const float2* g0 = dft(a, t, 1, TW, 1, TW, n2, TW, R + n2, nullptr, 0, 0, 1.f);  // inverse F
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = base + (size_t)(i / TW) * w + (i % TW);
    a0r[g] = g0[i].x;
    a0i[g] = g0[i].y;
  }
  // inverse H F, through the tile that is neither H F nor inverse F
  const float2* g1 = dft(b, g0 == a ? t : a, 1, TW, 1, TW, n2, TW, R + n2, nullptr, 0, 0, 1.f);
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const size_t g = base + (size_t)(i / TW) * w + (i % TW);
    a1r[g] = g1[i].x;
    a1i[g] = g1[i].y;
  }
}

extern "C" int lpt_h_combine_dual(const float* xar, const float* xai, const float* yar,
                                  const float* yai, const float* hr, const float* hi,
                                  const float* rr, float* a0r, float* a0i, float* a1r,
                                  float* a1i, const float2* tab, int n1, int n2, int w,
                                  void* stream) {
  const size_t smem = sizeof(float2) * (3 * ((size_t)n2 * TW + dft_slack(n2)) + 2 * n2);
  return launch(h_combine_kernel, dim3(n1 * (w / TW)), dim3(256), smem, stream, xar, xai, yar,
                yai, hr, hi, rr, a0r, a0i, a1r, a1i, tab, n1, n2, w);
}
