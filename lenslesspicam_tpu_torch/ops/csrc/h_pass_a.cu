// K4: H-axis stage 1 on two complex planes, and K14 on one.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `h_passA_pair`
// (kernel `_h_passA_pair_kernel`) and `h_passA` (kernel `_h_passA_kernel`,
// the single-array form the pass-level split backend runs): one kernel,
// two C entries.  Each plane (real and imaginary parts)
// is viewed (n1, n2, W) with h = j1*n2 + j2.  Forward: contract j1 with F1,
// then multiply by the twiddle T[k1, j2].  Inverse: twiddle first, contract
// with the inverse F1, scale 1/n.  Planes are stored in the io type T (f32
// or bf16); the stage runs in f32.
//
// Bound on the H100: bytes (16 per point at f32, 8 at bf16; the length-48
// DFT runs as a 4 x 12 split stage, 16 complex multiply-adds per point).
// The H axis is the strided column direction, so a block takes one j2 and
// 64 consecutive lanes of W: its loads and stores are runs of 64
// contiguous elements, and the n1 x 64 column tile sits in shared memory
// for the DFT.  One launch covers both arrays of every plane of a stack
// of P planes (K4: grid.y = 2 P) or the one array of each (K14: grid.y =
// P, the second array's pointers unused); the two forms are two
// instantiations (kPair), so K4's code is the single-purpose one it was and
// a profile tells the two apart.
#include "lpt_dft.cuh"

using namespace lpt;

constexpr int TW = 64;

template <typename T, bool kPair, bool kGen>
__global__ void __launch_bounds__(256, 4) h_pass_a_kernel(
    const T* __restrict__ x1r, const T* __restrict__ x1i, const T* __restrict__ x2r,
    const T* __restrict__ x2i, T* __restrict__ o1r, T* __restrict__ o1i, T* __restrict__ o2r,
    T* __restrict__ o2i, const float2* __restrict__ tab, int n1, int n2, int w, int inverse) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const int cap = n1 * TW + dft_slack(n1);
  float2* S = sm;
  float2* D = S + cap;
  float2* R = D + cap;
  const float2* roots = inverse ? p.r1i : p.r1f;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) R[i] = roots[i];
  // kPair: blockIdx.y = 2 * (plane of the stack) + (first or second array);
  // otherwise blockIdx.y = plane
  const int second = kPair ? (int)(blockIdx.y & 1) : 0;
  const size_t po = (size_t)(kPair ? blockIdx.y >> 1 : blockIdx.y) * n1 * n2 * w;
  const T* xr = (second ? x2r : x1r) + po;
  const T* xi = (second ? x2i : x1i) + po;
  T* orr = (second ? o2r : o1r) + po;
  T* oi = (second ? o2i : o1i) + po;
  const int wtiles = tiles<kGen>(w, TW);
  const int j2 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < n1 * TW; i0 += blockDim.x * V) {
    const int j1 = i0 / TW, c = i0 - j1 * TW;
    const size_t g = ((size_t)j1 * n2 + j2) * w + w0 + c;
    float re[V] = {}, im[V] = {};
    if (!kGen || w0 + c < w) {  // the general form's last tile: lanes past w load 0
      ldv<V>(xr + g, re);
      ldv<V>(xi + g, im);
    }
    rot(re, s);
    rot(im, s);
    const float2 tw = inverse ? __ldg(p.ti + j1 * n2 + j2) : make_float2(1.f, 0.f);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float2 val = make_float2(re[k], im[k]);
      if (inverse) val = cmul(val, tw);
      S[i0 + ((k + s) & (V - 1))] = val;
    }
  }
  __syncthreads();
  const float2* D1 =
      inverse ? dft<kGen>(S, D, 1, TW, 1, TW, n1, TW, R, nullptr, 0, 0, 1.f / (float)p.n)
              : dft<kGen>(S, D, 1, TW, 1, TW, n1, TW, R, p.tf + j2, 0, n2, 1.f);
  __syncthreads();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < n1 * TW; i0 += blockDim.x * V) {
    const int k1 = i0 / TW, c = i0 - k1 * TW;
    const size_t g = ((size_t)k1 * n2 + j2) * w + w0 + c;
    if (kGen && w0 + c >= w) continue;
    float re[V], im[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 z = D1[i0 + ((k + s) & (V - 1))];
      re[k] = z.x;
      im[k] = z.y;
    }
    unrot(re, s);
    unrot(im, s);
    stv<V>(orr + g, re);
    stv<V>(oi + g, im);
  }
}

template <typename T>
static int run(const void* x1r, const void* x1i, const void* x2r, const void* x2i, void* o1r,
               void* o1i, void* o2r, void* o2i, const float2* tab, int planes, int n1, int n2,
               int w, int inverse, bool pair, void* stream) {
  const size_t smem = sizeof(float2) * (2 * ((size_t)n1 * TW + dft_slack(n1)) + n1);
  const bool gen = general_tile(n1, w, TW);
  auto kernel = pair ? (gen ? h_pass_a_kernel<T, true, true> : h_pass_a_kernel<T, true, false>)
                     : (gen ? h_pass_a_kernel<T, false, true> : h_pass_a_kernel<T, false, false>);
  return launch(kernel, dim3(n2 * ((w + TW - 1) / TW), (pair ? 2 : 1) * planes), dim3(256), smem,
                stream,
                (const T*)x1r, (const T*)x1i, (const T*)x2r, (const T*)x2i, (T*)o1r, (T*)o1i,
                (T*)o2r, (T*)o2i, tab, n1, n2, w, inverse);
}

// Each array is a stack of `planes` planes of (n1, n2, w).  io: storage
// code of all eight arrays (F32 or BF16).
extern "C" int lpt_h_pass_a_pair(const void* x1r, const void* x1i, const void* x2r,
                                 const void* x2i, void* o1r, void* o1i, void* o2r, void* o2i,
                                 const float2* tab, int planes, int n1, int n2, int w,
                                 int inverse, int io, void* stream) {
  switch (io) {
    case F32:
      return run<float>(x1r, x1i, x2r, x2i, o1r, o1i, o2r, o2i, tab, planes, n1, n2, w, inverse,
                        true, stream);
    case BF16:
      return run<__nv_bfloat16>(x1r, x1i, x2r, x2i, o1r, o1i, o2r, o2i, tab, planes, n1, n2, w,
                                inverse, true, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K14: one array (xr, xi) -> (or, oi), a stack of `planes` planes of
// (n1, n2, w).  io: storage code of all four arrays (F32 or BF16).
extern "C" int lpt_h_pass_a(const void* xr, const void* xi, void* orr, void* oi,
                            const float2* tab, int planes, int n1, int n2, int w, int inverse,
                            int io, void* stream) {
  switch (io) {
    case F32:
      return run<float>(xr, xi, xr, xi, orr, oi, orr, oi, tab, planes, n1, n2, w, inverse, false,
                        stream);
    case BF16:
      return run<__nv_bfloat16>(xr, xi, xr, xi, orr, oi, orr, oi, tab, planes, n1, n2, w,
                                inverse, false, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
