// K15, K16, K17, K18: H-axis stage 2 (the n2 x n2 contraction over j2, or
// over k2 for the inverse) of the pass-level split backend.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py
//   K15 `h_passB` (kernel `_h_passB_kernel`): stage 2 of one complex plane,
//       forward or inverse (unscaled: the 1/n of the inverse lives in
//       stage 1, K14), with an optional filter multiply of the spectrum
//       before the contraction;
//   K16 `h_passB_combine` (kernel `_h_passB_combine_kernel`): forward stage
//       2 of y, b = F2 y, fused with F = R (a + conj(H) b), a read from
//       device memory;
//   K17 `h_passB_dual` (kernel `_h_passB_dual_kernel`): the inverse stage 2
//       of y and of H y from one read of y;
//   K18 `fft_h_combine2` (kernel `_h_passB_combine2_kernel`): K16 with its
//       spectrum a computed in the block, a = F2 x of the rk stage-1 plane
//       x, instead of read: the rk spectrum never reaches device memory.
// Planes are viewed (n1, n2, W) with h = k1 + n1 k2 in split order; all
// planes, the filter planes included, are stored in the io type T (f32 or
// bf16) and every product and contraction runs in f32 (FFMA).
//
// Bound on the H100: bytes (K15 16 bytes per point at f32, 24 with the
// filter; K16 and K18 36; K17 32; half at bf16).
//
// Every kernel has two designs, chosen by n2 alone (kernels.h_pass_b_design,
// K5's rule): the radix design for n2 = RN2 = 128 (the 12 MP grid's H = 48
// x 128, 768 = 6 x 128), any n1 and W, and the split design for any other
// n2.  Neither falls back on the other.
//
// The split design (any n2): a length-n2 DFT runs as an a x b split stage
// (8 x 16 at n2 = 128, 24 complex multiply-adds per point).  The
// contraction runs down the strided H columns, so a block takes one k1 and
// 32 consecutive lanes of W, as K5 does: loads and stores are runs of 32
// contiguous elements and the n2 x 32 tile stays in shared memory for the
// DFT (two tiles, 66 KB at 12 MP, three blocks per SM; K17 and K18 three
// tiles, 99 KB, two blocks); K16 and K18 combine after the transform, out
// of shared memory.
//
// The radix design (n2 = RN2): K5's column form of the radix FFT
// (lpt_fft.cuh), 16 + 8 points a column thread.  A block takes one k1 and
// RTW = 32 lanes, 8 threads a lane (256), and one 32 KB buffer
// [position][lane] for the transform's one exchange.  Each thread loads
// the 16 registers of its column straight from device memory (all loads
// before the first butterfly, each a warp's consecutive lanes of one row)
// and stores them straight back: the forward transform reads the natural
// rows j2 = t + 8 r and leaves register i R + c at frequency(t + 8 i, c)
// (digit order), which it stores to that row, so the output is in natural
// order with no second exchange; the inverse (the forward network
// transposed) reads each register from the row of the frequency it stands
// for and leaves the natural rows j2 = t + 8 r.  A filter (K15) or H (K17)
// is read at the same rows as y and multiplied in f32 on the loaded
// registers.  K16 and K18 combine on the registers as K5 does: at each
// register's frequency row they read a (K16), H and R, form F = R (a +
// conj(H) b) in f32 and store F to that row, so no tile but the
// transform's buffer lives in shared memory.  K15 and K16 keep one array
// a column live, K17 and K18 two (y, then H y; x, then y), each
// transformed through the same buffer behind a barrier.  K15 at bf16 io and an even W
// takes two adjacent columns a thread (64 lanes a block, one 4-byte load
// of a bf16 pair a row, a 64 KB buffer): its forward form ran 10-19 %
// faster than with one column a thread, whose warp accesses are 64 bytes
// (0.1409-0.1413 against 0.1566-0.1689 ms at 12 MP), and the pallas loop
// at bf16 io 0.3 % faster end to end; at f32 two columns a thread gained
// nothing.  K16 takes K15's rule: with two bf16 columns a thread it ran
// 5.5 % faster than with one (0.3242 against 0.3431 ms at 12 MP; in the
// pallas loop 0.323 against 0.346 ms, 0.3 % faster end to end), though it
// spills 52 bytes (88 on a stack); K18 takes one column.  Every radix
// kernel takes K5's launch bound, two blocks a multiprocessor: a bound of
// three or four (80 or 64 registers) ran K15 no faster (within 0.8 %;
// ab_kernels.py on an NVIDIA H100 80GB HBM3 at 700 W).
//
// The planes may be a stack of P (grid.y = P); the constant planes (filter,
// H, R) a stack of Pc, P % Pc == 0, plane p reading constant plane p % Pc.
// The radix design runs a single plane through an instantiation without
// the plane offsets (kStack false), as K5 does.
#include "lpt_fft.cuh"

using namespace lpt;

constexpr int TW = 32;
constexpr int THREADS = 256;

// The block's n2 x TW tile of a plane and of its constant plane: element i
// of the tile (row i / TW, lane i % TW) lies at base + row * w + lane.
// A block's tile: n2 rows of TW lanes from lane w0; `lanes` = w - w0 of
// them lie inside the plane (the general form's last tile has fewer than
// TW, and its lanes past w are neither loaded nor stored).
struct Tile {
  int w, size, lanes;
  size_t base, cbase;
};

template <bool kGen>
__device__ inline Tile make_tile(int n1, int n2, int w, int pc) {
  const int wtiles = tiles<kGen>(w, TW);
  const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const size_t plane = (size_t)n1 * n2 * w;
  const size_t tile0 = (size_t)k1 * n2 * w + w0;
  return Tile{w, n2 * TW, w - w0, blockIdx.y * plane + tile0, (blockIdx.y % pc) * plane + tile0};
}

__device__ __forceinline__ size_t tile_off(const Tile& t, int i) {
  return (size_t)(i / TW) * t.w + (i % TW);
}

// Whether element i of the tile lies inside the plane (always, but in the
// general form).
template <bool kGen>
__device__ __forceinline__ bool in_plane(const Tile& t, int i) {
  return !kGen || i % TW < t.lanes;
}

// S <- y (mr null), S <- m y (mr set, SM null), or S <- y and SM <- m y
// (both set), with the complex constant m = mr + i mi read at the tile's
// constant plane; the product in f32 in the JAX kernel's order.
template <typename T, bool kGen>
__device__ void load_tile(const Tile& t, const T* __restrict__ yr, const T* __restrict__ yi,
                          const T* __restrict__ mr, const T* __restrict__ mi, float2* S,
                          float2* SM) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    const size_t off = tile_off(t, i0);
    float re[V] = {}, im[V] = {}, hr[V] = {}, hi[V] = {};
    const bool in = in_plane<kGen>(t, i0);
    if (in) {
      ldv<V>(yr + t.base + off, re);
      ldv<V>(yi + t.base + off, im);
    }
    rot(re, s);
    rot(im, s);
    if (mr && in) {
      ldv<V>(mr + t.cbase + off, hr);
      ldv<V>(mi + t.cbase + off, hi);
      rot(hr, s);
      rot(hi, s);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      const float2 y = make_float2(re[k], im[k]);
      const float2 z = make_float2(re[k] * hr[k] - im[k] * hi[k], re[k] * hi[k] + im[k] * hr[k]);
      if (!mr) {
        S[i] = y;
      } else if (SM) {
        S[i] = y;
        SM[i] = z;
      } else {
        S[i] = z;
      }
    }
  }
}

// The tile G (shared, f32) stored to (outr, outi) as T.
template <typename T, bool kGen>
__device__ void store_tile(const Tile& t, const float2* G, T* __restrict__ outr,
                           T* __restrict__ outi) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t g = t.base + tile_off(t, i0);
    float re[V], im[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 z = G[i0 + ((k + s) & (V - 1))];
      re[k] = z.x;
      im[k] = z.y;
    }
    unrot(re, s);
    unrot(im, s);
    stv<V>(outr + g, re);
    stv<V>(outi + g, im);
  }
}

// Shared memory of a kernel holding `tiles` tiles and n2 roots.
__host__ inline size_t smem_bytes(int tiles, int n2) {
  return sizeof(float2) * (tiles * ((size_t)n2 * TW + dft_slack(n2)) + n2);
}

// K15: stage 2 of (yr, yi), forward or inverse, the spectrum multiplied by
// the filter (fr, fi; null: none) first.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ fr,
    const T* __restrict__ fi, T* __restrict__ outr, T* __restrict__ outi,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w, int inverse) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* R = S2 + cap;
  const float2* roots = inverse ? p.r2i : p.r2f;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = roots[i];
  load_tile<T, kGen>(t, yr, yi, fr, fi, S1, nullptr);
  __syncthreads();
  const float2* z = dft<kGen>(S1, S2, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, z, outr, outi);
}

// K16: b = forward stage 2 of (yr, yi); F = R (a + conj(H) b).
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_combine_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* R = S2 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2f[i];
  load_tile<T, kGen>(t, yr, yi, nullptr, nullptr, S1, nullptr);
  __syncthreads();
  const float2* b = dft<kGen>(S1, S2, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t off = tile_off(t, i0);
    float a_r[V], a_i[V], h_r[V], h_i[V], rv[V], o_r[V], o_i[V];
    ldv<V>(ar + t.base + off, a_r);
    ldv<V>(ai + t.base + off, a_i);
    ldv<V>(hr + t.cbase + off, h_r);
    ldv<V>(hi + t.cbase + off, h_i);
    ldv<V>(rr + t.cbase + off, rv);
    rot(a_r, s);
    rot(a_i, s);
    rot(h_r, s);
    rot(h_i, s);
    rot(rv, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 B = b[i0 + ((k + s) & (V - 1))];
      o_r[k] = rv[k] * (a_r[k] + h_r[k] * B.x + h_i[k] * B.y);
      o_i[k] = rv[k] * (a_i[k] + h_r[k] * B.y - h_i[k] * B.x);
    }
    unrot(o_r, s);
    unrot(o_i, s);
    stv<V>(fr_out + t.base + off, o_r);
    stv<V>(fi_out + t.base + off, o_i);
  }
}

// K17: a0 = inverse stage 2 of y, a1 = inverse stage 2 of H y.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_dual_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ hr,
    const T* __restrict__ hi, T* __restrict__ a0r, T* __restrict__ a0i, T* __restrict__ a1r,
    T* __restrict__ a1i, const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2i[i];
  load_tile<T, kGen>(t, yr, yi, hr, hi, S1, S2);
  __syncthreads();
  // each stage leaves its result in its source (split) or its spare (direct)
  const float2* g0 = dft<kGen>(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, g0, a0r, a0i);
  // H y, through the tile that holds neither H y nor the first result
  const float2* g1 = dft<kGen>(S2, g0 == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, g1, a1r, a1i);
}

// K18: a = forward stage 2 of (xr, xi), b = forward stage 2 of (yr, yi);
// F = R (a + conj(H) b).  Both contractions read F2 from the same roots.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_combine2_kernel(
    const T* __restrict__ xr, const T* __restrict__ xi, const T* __restrict__ yr,
    const T* __restrict__ yi, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2f[i];
  load_tile<T, kGen>(t, xr, xi, nullptr, nullptr, S1, nullptr);
  load_tile<T, kGen>(t, yr, yi, nullptr, nullptr, S2, nullptr);
  __syncthreads();
  // each stage leaves its result in its source (split) or its spare (direct)
  const float2* a = dft<kGen>(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  // y, through the tile that holds neither y nor a
  const float2* b = dft<kGen>(S2, a == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t off = tile_off(t, i0);
    float h_r[V], h_i[V], rv[V], o_r[V], o_i[V];
    ldv<V>(hr + t.cbase + off, h_r);
    ldv<V>(hi + t.cbase + off, h_i);
    ldv<V>(rr + t.cbase + off, rv);
    rot(h_r, s);
    rot(h_i, s);
    rot(rv, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      const float2 A = a[i], B = b[i];
      o_r[k] = rv[k] * (A.x + h_r[k] * B.x + h_i[k] * B.y);
      o_i[k] = rv[k] * (A.y + h_r[k] * B.y - h_i[k] * B.x);
    }
    unrot(o_r, s);
    unrot(o_i, s);
    stv<V>(fr_out + t.base + off, o_r);
    stv<V>(fi_out + t.base + off, o_i);
  }
}

// ---------------------------------------------------------------------------
// The radix design of K15-K18: n2 = RN2, any n1 and W (the last lane tile
// guarded where RTW does not divide W).
// ---------------------------------------------------------------------------

constexpr int RN2 = 128;                                     // kernels.H_RADIX_N2
constexpr int RTW = 32;                                      // lanes a block
constexpr int RTHREADS = fft::Plan<RN2>::THREADS * RTW;      // 8 a lane
constexpr int RNT = fft::Plan<RN2>::THREADS;
constexpr int RR = fft::Plan<RN2>::radix(fft::Plan<RN2>::PASSES - 1);  // the last pass's radix

// Thread (lane, t) of a radix block and its kL columns (k1, w0 + kL lane +
// e), e < kL, the block's tile kL RTW lanes: base and cbase offset the
// first column in the plane stack and in the constant stack.
template <bool kStack, bool kGen, int kL = 1>
struct RCol {
  int lane, t;
  // the guarded tile: lanes past w load 0 and store nothing (kL = 2 runs
  // an even w only, so a pair lies inside the plane or outside it whole)
  bool live;
  size_t base, cbase;
  __device__ RCol(int pc, int n1, int w) {
    lane = threadIdx.x % RTW;
    t = threadIdx.x / RTW;
    const int wtiles = tiles<kGen>(w, kL * RTW);
    const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * kL * RTW;
    live = !kGen || w0 + kL * lane < w;
    const size_t plane = (size_t)n1 * RN2 * w;
    const size_t col = (size_t)k1 * RN2 * w + w0 + kL * lane;
    base = (kStack ? blockIdx.y * plane : 0) + col;
    cbase = (kStack ? (blockIdx.y % pc) * plane : 0) + col;
  }
};

// Row of the column that register k of thread t stands for: the natural
// position j2 = t + T k, or the frequency k2 that register k holds in the
// transform's digit order (fft::frequency; k is a constant once the
// caller's loop unrolls).
__device__ __forceinline__ int natural_row(int t, int k) { return t + RNT * k; }
__device__ __forceinline__ int digit_row(int t, int k) {
  return fft::frequency<RN2>(t + RNT * (k / RR), k % RR);
}

// x[0..kL) <- p[0..kL), widened to f32, in one load (kL = 2: a 4-byte
// bf16 pair, p aligned to it).
template <int kL, typename T>
__device__ __forceinline__ void ld_lanes(const T* __restrict__ p, float (&x)[kL]) {
  if constexpr (kL == 1) {
    x[0] = ld1(p, Fix{});
  } else {
    static_assert(kL == 2 && sizeof(T) == 2, "pairs of 2-byte elements");
    unpack2(__ldg(reinterpret_cast<const unsigned int*>(p)), x, T{}, Fix{});
  }
}

// p[0..kL) <- x[0..kL), rounded to T, in one store.
template <int kL, typename T>
__device__ __forceinline__ void st_lanes(T* __restrict__ p, const float (&x)[kL]) {
  if constexpr (kL == 1) {
    st1(p, x[0], Fix{});
  } else {
    static_assert(kL == 2 && sizeof(T) == 2, "pairs of 2-byte elements");
    *reinterpret_cast<uint32_t*>(p) = bits(x[0], T{}, Fix{}) | (bits(x[1], T{}, Fix{}) << 16);
  }
}

// Columns a thread of the radix K15 and K16 take where W is even, by io
// type: two at bf16 (one column a thread makes a warp access of 64 bytes),
// one at f32 (two, as float2, ran within 2.4 % either way of one).
template <typename T>
constexpr int k15_lanes() { return sizeof(T) == 2 ? 2 : 1; }

// K15, radix design: stage 2 of (yr, yi), forward (kInv false) or inverse,
// the spectrum multiplied by the filter (fr, fi) first (kFilt); kL
// columns a thread, each through its own RTW-lane part of the buffer.
template <typename T, int kL, bool kStack, bool kGen, bool kInv, bool kFilt>
__global__ void __launch_bounds__(RTHREADS, 2) h_pass_b_radix_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ fr,
    const T* __restrict__ fi, T* __restrict__ outr, T* __restrict__ outi,
    const float2* __restrict__ tw, int pc, int n1, int w) {
  using namespace fft;
  extern __shared__ float2 sm[];  // RN2 x kL RTW, [position][lane]
  const RCol<kStack, kGen, kL> c(pc, n1, w);
  float2 v[kL][RADIX];
  float f_r[kL][RADIX], f_i[kL][RADIX];
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = (size_t)(kInv ? digit_row(c.t, k) : natural_row(c.t, k)) * w;
    float re[kL] = {}, im[kL] = {}, hr[kL] = {}, hi[kL] = {};
    if (c.live) {
      ld_lanes<kL>(yr + c.base + g, re);
      ld_lanes<kL>(yi + c.base + g, im);
      if (kFilt) {
        ld_lanes<kL>(fr + c.cbase + g, hr);
        ld_lanes<kL>(fi + c.cbase + g, hi);
      }
    }
#pragma unroll
    for (int e = 0; e < kL; ++e) {
      v[e][k] = make_float2(re[e], im[e]);
      f_r[e][k] = hr[e];
      f_i[e][k] = hi[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kL; ++e) {
    if constexpr (kFilt) {
#pragma unroll
      for (int k = 0; k < RADIX; ++k) {  // in f32, in the JAX kernel's order
        const float2 y = v[e][k];
        v[e][k] = make_float2(y.x * f_r[e][k] - y.y * f_i[e][k], y.x * f_i[e][k] + y.y * f_r[e][k]);
      }
    }
    if constexpr (kInv) {
      col_ifft<RN2, kL * RTW>(v[e], sm, tw, c.t, e * RTW + c.lane);
    } else {
      col_fft<RN2, kL * RTW>(v[e], sm, tw, c.t, e * RTW + c.lane);
    }
  }
  if (!c.live) return;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = c.base + (size_t)(kInv ? natural_row(c.t, k) : digit_row(c.t, k)) * w;
    float re[kL], im[kL];
#pragma unroll
    for (int e = 0; e < kL; ++e) {
      re[e] = v[e][k].x;
      im[e] = v[e][k].y;
    }
    st_lanes<kL>(outr + g, re);
    st_lanes<kL>(outi + g, im);
  }
}

// K17, radix design: a0 = inverse stage 2 of y, a1 = inverse stage 2 of H y.
template <typename T, bool kStack, bool kGen>
__global__ void __launch_bounds__(RTHREADS, 2) h_pass_b_dual_radix_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ hr,
    const T* __restrict__ hi, T* __restrict__ a0r, T* __restrict__ a0i, T* __restrict__ a1r,
    T* __restrict__ a1i, const float2* __restrict__ tw, int pc, int n1, int w) {
  using namespace fft;
  extern __shared__ float2 sm[];  // RN2 x RTW, [position][lane]
  const RCol<kStack, kGen> c(pc, n1, w);
  float2 a[RADIX], b[RADIX];
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = (size_t)digit_row(c.t, k) * w;
    a[k] = b[k] = make_float2(0.f, 0.f);
    if (c.live) {
      a[k] = make_float2(ld1(yr + c.base + g, Fix{}), ld1(yi + c.base + g, Fix{}));
      b[k] = make_float2(ld1(hr + c.cbase + g, Fix{}), ld1(hi + c.cbase + g, Fix{}));
    }
  }
#pragma unroll
  for (int k = 0; k < RADIX; ++k)  // H y in f32, in the JAX kernel's order
    b[k] = make_float2(a[k].x * b[k].x - a[k].y * b[k].y, a[k].x * b[k].y + a[k].y * b[k].x);
  auto store = [&](const float2(&v)[RADIX], T* outr, T* outi) {
    if (!c.live) return;
#pragma unroll
    for (int k = 0; k < RADIX; ++k) {
      const size_t g = c.base + (size_t)natural_row(c.t, k) * w;
      st1(outr + g, v[k].x, Fix{});
      st1(outi + g, v[k].y, Fix{});
    }
  };
  col_ifft<RN2, RTW>(a, sm, tw, c.t, c.lane);
  store(a, a0r, a0i);
  __syncthreads();  // every read of a's exchange is done: the buffer is free
  col_ifft<RN2, RTW>(b, sm, tw, c.t, c.lane);
  store(b, a1r, a1i);
}

// K16, radix design: b = forward stage 2 of (yr, yi) on the registers, then
// F = R (a + conj(H) b) at each register's frequency row, a, H and R read
// there (one register at a time, to keep few live) and F stored there; kL
// columns a thread, each through its own RTW-lane part of the buffer.
template <typename T, int kL, bool kStack, bool kGen>
__global__ void __launch_bounds__(RTHREADS, 2) h_pass_b_combine_radix_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tw, int pc, int n1, int w) {
  using namespace fft;
  extern __shared__ float2 sm[];  // RN2 x kL RTW, [position][lane]
  const RCol<kStack, kGen, kL> c(pc, n1, w);
  float2 v[kL][RADIX];
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = c.base + (size_t)natural_row(c.t, k) * w;
    float re[kL] = {}, im[kL] = {};
    if (c.live) {
      ld_lanes<kL>(yr + g, re);
      ld_lanes<kL>(yi + g, im);
    }
#pragma unroll
    for (int e = 0; e < kL; ++e) v[e][k] = make_float2(re[e], im[e]);
  }
#pragma unroll
  for (int e = 0; e < kL; ++e) col_fft<RN2, kL * RTW>(v[e], sm, tw, c.t, e * RTW + c.lane);
  if (!c.live) return;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = (size_t)digit_row(c.t, k) * w;
    float a_r[kL], a_i[kL], h_r[kL], h_i[kL], rv[kL], o_r[kL], o_i[kL];
    ld_lanes<kL>(ar + c.base + g, a_r);
    ld_lanes<kL>(ai + c.base + g, a_i);
    ld_lanes<kL>(hr + c.cbase + g, h_r);
    ld_lanes<kL>(hi + c.cbase + g, h_i);
    ld_lanes<kL>(rr + c.cbase + g, rv);
#pragma unroll
    for (int e = 0; e < kL; ++e) {  // in f32, in the JAX kernel's order
      const float2 b = v[e][k];
      o_r[e] = rv[e] * (a_r[e] + h_r[e] * b.x + h_i[e] * b.y);
      o_i[e] = rv[e] * (a_i[e] + h_r[e] * b.y - h_i[e] * b.x);
    }
    st_lanes<kL>(fr_out + c.base + g, o_r);
    st_lanes<kL>(fi_out + c.base + g, o_i);
  }
}

// K18, radix design: a = forward stage 2 of (xr, xi), b = forward stage 2
// of (yr, yi), both on the registers (K5's first half); F = R (a + conj(H)
// b) at each register's frequency row, H and R read there and F stored
// there.  One column a thread: two would hold four column arrays.
template <typename T, bool kStack, bool kGen>
__global__ void __launch_bounds__(RTHREADS, 2) h_pass_b_combine2_radix_kernel(
    const T* __restrict__ xr, const T* __restrict__ xi, const T* __restrict__ yr,
    const T* __restrict__ yi, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tw, int pc, int n1, int w) {
  using namespace fft;
  extern __shared__ float2 sm[];  // RN2 x RTW, [position][lane]
  const RCol<kStack, kGen> c(pc, n1, w);
  float2 a[RADIX], b[RADIX];
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = c.base + (size_t)natural_row(c.t, k) * w;
    a[k] = b[k] = make_float2(0.f, 0.f);
    if (c.live) {
      a[k] = make_float2(ld1(xr + g, Fix{}), ld1(xi + g, Fix{}));
      b[k] = make_float2(ld1(yr + g, Fix{}), ld1(yi + g, Fix{}));
    }
  }
  col_fft<RN2, RTW>(a, sm, tw, c.t, c.lane);
  __syncthreads();  // every read of a's exchange is done: the buffer is free
  col_fft<RN2, RTW>(b, sm, tw, c.t, c.lane);
  if (!c.live) return;
#pragma unroll
  for (int k = 0; k < RADIX; ++k) {
    const size_t g = (size_t)digit_row(c.t, k) * w;
    const float h_r = ld1(hr + c.cbase + g, Fix{}), h_i = ld1(hi + c.cbase + g, Fix{});
    const float rv = ld1(rr + c.cbase + g, Fix{});
    st1(fr_out + c.base + g, rv * (a[k].x + h_r * b[k].x + h_i * b[k].y), Fix{});
    st1(fi_out + c.base + g, rv * (a[k].y + h_r * b[k].y - h_i * b[k].x), Fix{});
  }
}

// The radix launches.  The twiddles follow the split design's table
// (kernels._design_table), read at make_plan(tab, n1, RN2).e as K5 reads them.
static dim3 radix_grid(int planes, int n1, int w, int lanes) {
  return dim3(n1 * ((w + lanes - 1) / lanes), planes);
}

template <typename T, int kL, bool kStack, bool kGen>
static auto radix_b_kernel(bool inverse, bool filt) {
  return inverse ? (filt ? h_pass_b_radix_kernel<T, kL, kStack, kGen, true, true>
                         : h_pass_b_radix_kernel<T, kL, kStack, kGen, true, false>)
                 : (filt ? h_pass_b_radix_kernel<T, kL, kStack, kGen, false, true>
                         : h_pass_b_radix_kernel<T, kL, kStack, kGen, false, false>);
}

template <typename T, int kL>
static int run_radix_b_lanes(const void* yr, const void* yi, const void* fr, const void* fi,
                             void* outr, void* outi, const float2* tab, int planes, int pc,
                             int n1, int w, int inverse, void* stream) {
  const bool gen = w % (kL * RTW), inv = inverse, filt = fr != nullptr;
  auto kernel = planes == 1 ? (gen ? radix_b_kernel<T, kL, false, true>(inv, filt)
                                   : radix_b_kernel<T, kL, false, false>(inv, filt))
                            : (gen ? radix_b_kernel<T, kL, true, true>(inv, filt)
                                   : radix_b_kernel<T, kL, true, false>(inv, filt));
  return launch(kernel, radix_grid(planes, n1, w, kL * RTW), dim3(RTHREADS),
                sizeof(float2) * RN2 * kL * RTW, stream, (const T*)yr, (const T*)yi,
                (const T*)fr, (const T*)fi, (T*)outr, (T*)outi, make_plan(tab, n1, RN2).e, pc,
                n1, w);
}

// K15's radix design: k15_lanes<T>() columns a thread where W is even, one
// where it is odd (a pair's load would be unaligned).
template <typename T>
static int run_radix_b(const void* yr, const void* yi, const void* fr, const void* fi,
                       void* outr, void* outi, const float2* tab, int planes, int pc, int n1,
                       int w, int inverse, void* stream) {
  if constexpr (k15_lanes<T>() == 2)
    if (w % 2 == 0)
      return run_radix_b_lanes<T, 2>(yr, yi, fr, fi, outr, outi, tab, planes, pc, n1, w,
                                     inverse, stream);
  return run_radix_b_lanes<T, 1>(yr, yi, fr, fi, outr, outi, tab, planes, pc, n1, w, inverse,
                                 stream);
}

template <typename T>
static int run_radix_dual(const void* yr, const void* yi, const void* hr, const void* hi,
                          void* a0r, void* a0i, void* a1r, void* a1i, const float2* tab,
                          int planes, int pc, int n1, int w, void* stream) {
  const bool gen = w % RTW;
  auto kernel = planes == 1 ? (gen ? h_pass_b_dual_radix_kernel<T, false, true>
                                   : h_pass_b_dual_radix_kernel<T, false, false>)
                            : (gen ? h_pass_b_dual_radix_kernel<T, true, true>
                                   : h_pass_b_dual_radix_kernel<T, true, false>);
  return launch(kernel, radix_grid(planes, n1, w, RTW), dim3(RTHREADS),
                sizeof(float2) * RN2 * RTW, stream, (const T*)yr, (const T*)yi, (const T*)hr,
                (const T*)hi, (T*)a0r, (T*)a0i, (T*)a1r, (T*)a1i, make_plan(tab, n1, RN2).e, pc,
                n1, w);
}

// K16 (kTwo false) and K18 (kTwo true) take seven inputs (K16: y, a, H,
// R; K18: x, y, H, R; each complex array as its r and i planes) and give F
// as fr, fi.
template <typename T, bool kTwo, int kL, bool kStack, bool kGen>
static auto combine_radix_kernel() {
  if constexpr (kTwo) return h_pass_b_combine2_radix_kernel<T, kStack, kGen>;
  else return h_pass_b_combine_radix_kernel<T, kL, kStack, kGen>;
}

template <typename T, bool kTwo, int kL>
static int run_radix_combine_lanes(const void* const* in, void* fr, void* fi,
                                   const float2* tab, int planes, int pc, int n1, int w,
                                   void* stream) {
  const bool gen = w % (kL * RTW);
  auto kernel = planes == 1 ? (gen ? combine_radix_kernel<T, kTwo, kL, false, true>()
                                   : combine_radix_kernel<T, kTwo, kL, false, false>())
                            : (gen ? combine_radix_kernel<T, kTwo, kL, true, true>()
                                   : combine_radix_kernel<T, kTwo, kL, true, false>());
  return launch(kernel, radix_grid(planes, n1, w, kL * RTW), dim3(RTHREADS),
                sizeof(float2) * RN2 * kL * RTW, stream, (const T*)in[0], (const T*)in[1],
                (const T*)in[2], (const T*)in[3], (const T*)in[4], (const T*)in[5],
                (const T*)in[6], (T*)fr, (T*)fi, make_plan(tab, n1, RN2).e, pc, n1, w);
}

// K16 takes K15's columns a thread (k15_lanes<T>()) where W is even, one
// where it is odd; K18 one.
template <typename T, bool kTwo>
static int run_radix_combine(const void* const* in, void* fr, void* fi, const float2* tab,
                             int planes, int pc, int n1, int w, void* stream) {
  if constexpr (!kTwo && k15_lanes<T>() == 2)
    if (w % 2 == 0)
      return run_radix_combine_lanes<T, kTwo, 2>(in, fr, fi, tab, planes, pc, n1, w, stream);
  return run_radix_combine_lanes<T, kTwo, 1>(in, fr, fi, tab, planes, pc, n1, w, stream);
}

static dim3 grid_of(int planes, int n1, int w) { return dim3(n1 * ((w + TW - 1) / TW), planes); }

// Every array is a stack of `planes` planes of (n1, n2, w) but the constant
// ones (filter, H, R), stacks of pc.  io: storage code of all arrays (F32
// or BF16).

// K15-K18 of io type T: the radix design for n2 = RN2, else the split design.
template <typename T>
static int run_b(const void* yr, const void* yi, const void* fr, const void* fi, void* outr,
                 void* outi, const float2* tab, int planes, int pc, int n1, int n2, int w,
                 int inverse, void* stream) {
  if (n2 == RN2) return run_radix_b<T>(yr, yi, fr, fi, outr, outi, tab, planes, pc, n1, w,
                                       inverse, stream);
  return launch(general_tile(n2, w, TW) ? h_pass_b_kernel<T, true> : h_pass_b_kernel<T, false>,
                grid_of(planes, n1, w), dim3(THREADS), smem_bytes(2, n2), stream,
                (const T*)yr, (const T*)yi, (const T*)fr, (const T*)fi, (T*)outr, (T*)outi, tab,
                pc, n1, n2, w, inverse);
}

template <typename T>
static int run_dual(const void* yr, const void* yi, const void* hr, const void* hi, void* a0r,
                    void* a0i, void* a1r, void* a1i, const float2* tab, int planes, int pc,
                    int n1, int n2, int w, void* stream) {
  if (n2 == RN2) return run_radix_dual<T>(yr, yi, hr, hi, a0r, a0i, a1r, a1i, tab, planes, pc,
                                          n1, w, stream);
  return launch(general_tile(n2, w, TW) ? h_pass_b_dual_kernel<T, true>
                                        : h_pass_b_dual_kernel<T, false>,
                grid_of(planes, n1, w), dim3(THREADS), smem_bytes(3, n2), stream, (const T*)yr,
                (const T*)yi, (const T*)hr, (const T*)hi, (T*)a0r, (T*)a0i, (T*)a1r, (T*)a1i,
                tab, pc, n1, n2, w);
}

template <typename T, bool kTwo>
static int run_combine(const void* const* in, void* fr, void* fi, const float2* tab,
                       int planes, int pc, int n1, int n2, int w, void* stream) {
  if (n2 == RN2) return run_radix_combine<T, kTwo>(in, fr, fi, tab, planes, pc, n1, w, stream);
  const bool gen = general_tile(n2, w, TW);
  auto kernel = kTwo ? (gen ? h_pass_b_combine2_kernel<T, true>
                            : h_pass_b_combine2_kernel<T, false>)
                     : (gen ? h_pass_b_combine_kernel<T, true> : h_pass_b_combine_kernel<T, false>);
  return launch(kernel, grid_of(planes, n1, w), dim3(THREADS), smem_bytes(kTwo ? 3 : 2, n2),
                stream, (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3],
                (const T*)in[4], (const T*)in[5], (const T*)in[6], (T*)fr, (T*)fi, tab, pc, n1,
                n2, w);
}

// K15.  fr, fi null: no filter.  n2 = RN2 runs the radix design (tab: the
// split table, then the radix twiddles of RN2), any other n2 the split
// design (tab: the split table); K16, K17 and K18 alike.
extern "C" int lpt_h_pass_b(const void* yr, const void* yi, const void* fr, const void* fi,
                            void* outr, void* outi, const float2* tab, int planes, int pc, int n1,
                            int n2, int w, int inverse, int io, void* stream) {
  switch (io) {
    case F32:
      return run_b<float>(yr, yi, fr, fi, outr, outi, tab, planes, pc, n1, n2, w, inverse,
                          stream);
    case BF16:
      return run_b<__nv_bfloat16>(yr, yi, fr, fi, outr, outi, tab, planes, pc, n1, n2, w,
                                  inverse, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K16.
extern "C" int lpt_h_pass_b_combine(const void* yr, const void* yi, const void* ar,
                                    const void* ai, const void* hr, const void* hi,
                                    const void* rr, void* fr, void* fi, const float2* tab,
                                    int planes, int pc, int n1, int n2, int w, int io,
                                    void* stream) {
  const void* in[7] = {yr, yi, ar, ai, hr, hi, rr};
  switch (io) {
    case F32:
      return run_combine<float, false>(in, fr, fi, tab, planes, pc, n1, n2, w, stream);
    case BF16:
      return run_combine<__nv_bfloat16, false>(in, fr, fi, tab, planes, pc, n1, n2, w,
                                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K17.
extern "C" int lpt_h_pass_b_dual(const void* yr, const void* yi, const void* hr, const void* hi,
                                 void* a0r, void* a0i, void* a1r, void* a1i, const float2* tab,
                                 int planes, int pc, int n1, int n2, int w, int io,
                                 void* stream) {
  switch (io) {
    case F32:
      return run_dual<float>(yr, yi, hr, hi, a0r, a0i, a1r, a1i, tab, planes, pc, n1, n2, w,
                             stream);
    case BF16:
      return run_dual<__nv_bfloat16>(yr, yi, hr, hi, a0r, a0i, a1r, a1i, tab, planes, pc, n1,
                                     n2, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K18.
extern "C" int lpt_h_pass_b_combine2(const void* xr, const void* xi, const void* yr,
                                     const void* yi, const void* hr, const void* hi,
                                     const void* rr, void* fr, void* fi, const float2* tab,
                                     int planes, int pc, int n1, int n2, int w, int io,
                                     void* stream) {
  const void* in[7] = {xr, xi, yr, yi, hr, hi, rr};
  switch (io) {
    case F32:
      return run_combine<float, true>(in, fr, fi, tab, planes, pc, n1, n2, w, stream);
    case BF16:
      return run_combine<__nv_bfloat16, true>(in, fr, fi, tab, planes, pc, n1, n2, w,
                                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
