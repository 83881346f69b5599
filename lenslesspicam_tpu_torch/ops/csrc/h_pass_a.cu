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
// Two designs, chosen by n1 alone (kernels.h_pass_a_design): the radix
// design for n1 = 48 (the 12 MP grid's H = 48 x 128), any n2 and W, and
// the split design for any other n1.  Neither falls back on the other.
//
// Bound on the H100: bytes, 16 per point at f32, 8 at bf16.
//
// The radix design (h_pass_a_radix_kernel): the length-48 DFT as 3 x 16
// (lpt_fft.cuh: dft<16>, mul_w48, radix3; constant roots), three threads
// a column.  A block takes one j2 and RTW consecutive lanes; thread (l, g)
// = (threadIdx.x % RTW, threadIdx.x / RTW), so a warp is 32 consecutive
// lanes of one g and each of its device accesses is 32 consecutive
// elements of one row of the view (128 B at f32, 64 B at bf16).  Thread
// (l, g) issues the 32 loads of its positions j1 = 3 j' + g before the
// first butterfly (the inverse folds T_inv[j1, j2] and the conjugation
// that makes it a forward DFT into the load), runs dft<16> in registers,
// multiplies by exp(-2 pi i g k' / 48) and writes the buffer [16 g +
// k'][l]; after one barrier thread (l, c) forms its frequencies k1 = k' +
// 16 c from the three rows and stores them (the forward folds T[k1, j2]
// into the store, the inverse its conjugation and 1/n).  The form with
// one column a thread (all 48 points in registers, no buffer, no barrier)
// needs 128 registers and spills at 4 blocks of 128 an SM, and ran 2-6 %
// slower on the H100 at 12 MP (ab_kernels.py; PERF.md §6).  Two forms:
// kGen guards the lanes of a cut last tile, the fast form (W a multiple of
// RTW, every solver's 12 MP grid) has no guard; one always-guarded form
// ran 3-8 % slower forward at bf16 io and 7-19 % slower inverse there.
//
// The split design (h_pass_a_kernel, any n1): the length-n1 DFT as a x b
// direct passes through shared memory (4 x 12 at n1 = 48).  A block takes
// one j2 and 64 consecutive lanes of W: its loads and stores are runs of
// 64 contiguous elements, and the n1 x 64 column tile sits in shared
// memory for the DFT.
//
// Either design covers both arrays of every plane of a stack of P planes
// in one launch (K4: grid.y = 2 P) or the one array of each (K14: grid.y =
// P, the second array's pointers unused); the two forms are two
// instantiations (kPair), so K4's code is the single-purpose one it was and
// a profile tells the two apart.
#include "lpt_fft.cuh"

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

// ---------------------------------------------------------------------------
// The radix design: n1 = RN1, any n2 and W (the last lane tile cut where
// RTW does not divide W).
// ---------------------------------------------------------------------------

constexpr int RN1 = fft::N48;   // kernels.H_RADIX_N1
constexpr int RTW = 64;         // lanes a block; three threads a lane

template <typename T, bool kPair, bool kGen, bool kInv>
__global__ void __launch_bounds__(3 * RTW) h_pass_a_radix_kernel(
    const T* __restrict__ x1r, const T* __restrict__ x1i, const T* __restrict__ x2r,
    const T* __restrict__ x2i, T* __restrict__ o1r, T* __restrict__ o1i, T* __restrict__ o2r,
    T* __restrict__ o2i, const float2* __restrict__ tab, int n2, int w) {
  using fft::RADIX;
  __shared__ float2 sm[RN1 * RTW];  // [16 g + k'][lane]
  // thread (l, g): a warp is 32 consecutive lanes of one g
  const int l = threadIdx.x % RTW, g = threadIdx.x / RTW;
  const int wtiles = tiles<kGen>(w, RTW);
  const int j2 = blockIdx.x / wtiles, lane = (blockIdx.x % wtiles) * RTW + l;
  const bool live = !kGen || lane < w;  // the cut tile: lanes past w load 0, store nothing
  const Plan p = make_plan(tab, RN1, n2);
  const int second = kPair ? (int)(blockIdx.y & 1) : 0;
  const size_t rs = (size_t)n2 * w;  // from row j1 to row j1 + 1 of the view
  const size_t col = (size_t)(kPair ? blockIdx.y >> 1 : blockIdx.y) * RN1 * rs +
                     (size_t)j2 * w + lane;
  const T* xr = (second ? x2r : x1r) + col;
  const T* xi = (second ? x2i : x1i) + col;
  float2 v[RADIX];  // position j1 = 3 j' + g at v[j']
#pragma unroll
  for (int q = 0; q < RADIX; ++q) {
    const size_t o = (3 * q + g) * rs;
    v[q] = make_float2(0.f, 0.f);
    if (live) v[q] = make_float2(ld1(xr + o, Fix{}), ld1(xi + o, Fix{}));
  }
  if constexpr (kInv) {  // conj(T_inv x): the inverse DFT as the conjugate of a forward one
#pragma unroll
    for (int q = 0; q < RADIX; ++q) {
      const float2 z = cmul(v[q], __ldg(p.ti + (3 * q + g) * n2 + j2));
      v[q] = make_float2(z.x, -z.y);
    }
  }
  fft::dft<RADIX>(v, 0);
  // Y_g[k'] = exp(-2 pi i g k' / 48) DFT16; g is one value a warp
  if (g == 1) {
#pragma unroll
    for (int k = 1; k < RADIX; ++k) v[k] = fft::mul_w48(v[k], k);
  } else if (g == 2) {
#pragma unroll
    for (int k = 1; k < RADIX; ++k) v[k] = fft::mul_w48(v[k], 2 * k);
  }
#pragma unroll
  for (int k = 0; k < RADIX; ++k) sm[(RADIX * g + k) * RTW + l] = v[k];
  __syncthreads();
  if (!live) return;
  // thread (l, c), c = g: frequencies k1 = k' + 16 c from Y_0, Y_1, Y_2
  const int c = g;
  T* orr = (second ? o2r : o1r) + col;
  T* oi = (second ? o2i : o1i) + col;
  const float scale = 1.f / (float)p.n;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const int k1 = k + RADIX * c;
    float2 z = fft::radix3(sm[k * RTW + l], sm[(RADIX + k) * RTW + l],
                           sm[(2 * RADIX + k) * RTW + l], c);
    z = kInv ? make_float2(z.x * scale, -z.y * scale) : cmul(z, __ldg(p.tf + k1 * n2 + j2));
    st1(orr + k1 * rs, z.x, Fix{});
    st1(oi + k1 * rs, z.y, Fix{});
  }
}

template <typename T, bool kPair>
static int run_radix(const void* x1r, const void* x1i, const void* x2r, const void* x2i,
                     void* o1r, void* o1i, void* o2r, void* o2i, const float2* tab,
                     int planes, int n2, int w, int inverse, void* stream) {
  const bool gen = w % RTW;
  auto kernel = inverse ? (gen ? h_pass_a_radix_kernel<T, kPair, true, true>
                               : h_pass_a_radix_kernel<T, kPair, false, true>)
                        : (gen ? h_pass_a_radix_kernel<T, kPair, true, false>
                               : h_pass_a_radix_kernel<T, kPair, false, false>);
  return launch(kernel, dim3(n2 * ((w + RTW - 1) / RTW), (kPair ? 2 : 1) * planes),
                dim3(3 * RTW), 0, stream, (const T*)x1r, (const T*)x1i, (const T*)x2r,
                (const T*)x2i, (T*)o1r, (T*)o1i, (T*)o2r, (T*)o2i, tab, n2, w);
}

template <typename T>
static int run(const void* x1r, const void* x1i, const void* x2r, const void* x2i, void* o1r,
               void* o1i, void* o2r, void* o2i, const float2* tab, int planes, int n1, int n2,
               int w, int inverse, bool pair, void* stream) {
  if (n1 == RN1)
    return pair ? run_radix<T, true>(x1r, x1i, x2r, x2i, o1r, o1i, o2r, o2i, tab, planes, n2, w,
                                     inverse, stream)
                : run_radix<T, false>(x1r, x1i, x2r, x2i, o1r, o1i, o2r, o2i, tab, planes, n2,
                                      w, inverse, stream);
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
