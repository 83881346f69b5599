// K4: H-axis stage 1 on two complex planes.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `h_passA_pair`
// (kernel `_h_passA_pair_kernel`).  Each plane (real and imaginary parts)
// is viewed (n1, n2, W) with h = j1*n2 + j2.  Forward: contract j1 with F1,
// then multiply by the twiddle T[k1, j2].  Inverse: twiddle first, contract
// with the inverse F1, scale 1/n.
//
// Bound on the H100: bytes (16 per point; the length-48 DFT runs as a
// 4 x 12 split stage, 16 complex multiply-adds per point).  The H axis is
// the strided column direction, so a block takes one j2 and 64
// consecutive lanes of W: its loads and stores are runs of 64 contiguous
// floats, and the n1 x 64 column tile sits in shared memory for the DFT.
// One launch covers both planes (grid.y).
#include "lpt_dft.cuh"

using namespace lpt;

constexpr int TW = 64;

__global__ void __launch_bounds__(256, 4) h_pass_a_kernel(
    const float* __restrict__ x1r, const float* __restrict__ x1i, const float* __restrict__ x2r,
    const float* __restrict__ x2i, float* __restrict__ o1r, float* __restrict__ o1i,
    float* __restrict__ o2r, float* __restrict__ o2i, const float2* __restrict__ tab, int n1,
    int n2, int w, int inverse) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const int cap = n1 * TW + dft_slack(n1);
  float2* S = sm;
  float2* D = S + cap;
  float2* R = D + cap;
  const float2* roots = inverse ? p.r1i : p.r1f;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) R[i] = roots[i];
  const int plane = blockIdx.y;
  const float* xr = plane ? x2r : x1r;
  const float* xi = plane ? x2i : x1i;
  float* orr = plane ? o2r : o1r;
  float* oi = plane ? o2i : o1i;
  const int wtiles = w / TW;
  const int j2 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
#pragma unroll 4
  for (int i = threadIdx.x; i < n1 * TW; i += blockDim.x) {
    const int j1 = i / TW, c = i - j1 * TW;
    const size_t g = ((size_t)j1 * n2 + j2) * w + w0 + c;
    float2 val = make_float2(xr[g], xi[g]);
    if (inverse) val = cmul(val, __ldg(p.ti + j1 * n2 + j2));
    S[i] = val;
  }
  __syncthreads();
  const float2* D1 = inverse ? dft(S, D, 1, TW, 1, TW, n1, TW, R, nullptr, 0, 0, 1.f / (float)p.n)
                             : dft(S, D, 1, TW, 1, TW, n1, TW, R, p.tf + j2, 0, n2, 1.f);
  __syncthreads();
#pragma unroll 4
  for (int i = threadIdx.x; i < n1 * TW; i += blockDim.x) {
    const int k1 = i / TW, c = i - k1 * TW;
    const size_t g = ((size_t)k1 * n2 + j2) * w + w0 + c;
    orr[g] = D1[i].x;
    oi[g] = D1[i].y;
  }
}

extern "C" int lpt_h_pass_a_pair(const float* x1r, const float* x1i, const float* x2r,
                                 const float* x2i, float* o1r, float* o1i, float* o2r,
                                 float* o2i, const float2* tab, int n1, int n2, int w,
                                 int inverse, void* stream) {
  const size_t smem = sizeof(float2) * (2 * ((size_t)n1 * TW + dft_slack(n1)) + n1);
  return launch(h_pass_a_kernel, dim3(n2 * (w / TW), 2), dim3(256), smem, stream, x1r, x1i, x2r,
                x2i, o1r, o1i, o2r, o2i, tab, n1, n2, w, inverse);
}
