// Register-resident radix FFT of one complex row of length M = 2^e per
// block (64 <= M <= 4096), and the packed-real forward W transform built
// on it (K1's radix design).
//
// Schedule (decimation in frequency, in place).  Pass s has radix R_s =
// 16, except the last, which takes the rest (2, 4, 8 or 16), and input
// length L_s = M / 16^s.  The block has T = M / 16 threads; each keeps 16
// points in registers and runs 16 / R_s butterflies a pass.  Butterfly
// b = t + T i of thread t is group g = b / (L/R), offset u = b % (L/R); it
// reads the positions g L + u + (L/R) r (r < R) of the row, takes their
// length-R DFT in registers (radix 2, constant roots), multiplies output
// c by the twiddle exp(-2 pi i u c / L) (not in the last pass, where u =
// 0) and writes output c back to g L + u + (L/R) c.  Pass 0 reads the row
// straight from device memory (j = t + T r: one coalesced access per r,
// all 2 * 16 loads of the even and odd planes issued before the first
// butterfly); later passes exchange through one padded shared buffer.
// After the last pass storage index i holds frequency f = digit reversal
// of i (pass 0's digit is f's least significant); the block writes it to
// split position (f % n1, f / n1) of the epilogue's layout [q1 (n2+1) +
// q2], which w_fwd_core's store loop reads (lpt_dft.cuh).
//
// The twiddles come from an f32 table built on the host in float64
// (kernels._radix_twiddles_np): for each pass but the last, entry (c - 1)
// (L/R) + u, so a warp's loads of one c are consecutive.  It follows the
// split design's table (lpt_dft.cuh's Plan), whose unpack factors E the
// epilogue reads.
#pragma once
#include "lpt_dft.cuh"

namespace lpt {
namespace fft {

constexpr int RADIX = 16;  // radix of every pass but the last; points a thread

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// The lengths of the radix design: powers of two from 64 to 4096.
__host__ __device__ constexpr bool radix_length(int m) {
  return m >= 64 && m <= 4096 && (m & (m - 1)) == 0;
}

template <int M>
struct Plan {
  static_assert(radix_length(M), "M is a power of two from 64 to 4096");
  static constexpr int PASSES = (ilog2(M) + 3) / 4;
  static constexpr int THREADS = M / RADIX;
  // radix and input length of pass s
  __host__ __device__ static constexpr int radix(int s) {
    return s < PASSES - 1 ? RADIX : M >> (4 * (PASSES - 1));
  }
  __host__ __device__ static constexpr int len(int s) { return M >> (4 * s); }
  // offset of pass s's twiddles in the radix table
  __host__ __device__ static constexpr int tw_off(int s) {
    int off = 0;
    for (int p = 0; p < s; ++p) off += (RADIX - 1) * (len(p) / RADIX);
    return off;
  }
};

// Shared index of row position i: one pad slot after every 16 (the last
// pass reads 16 consecutive positions a thread).
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Shared float2 slots of one row: the padded passes' buffer or the
// epilogue's split layout, whichever is larger.
__host__ inline size_t smem_bytes(int m, int n1, int n2) {
  const int a = m + m / 16, b = n1 * (n2 + 1);
  return sizeof(float2) * (size_t)(a > b ? a : b);
}

// x * exp(-2 pi i k / 16); k is a constant once the caller's loops unroll,
// so the switch folds and the roots 1, -i, -1, i cost no multiply.
__device__ __forceinline__ float2 mul_w16(float2 x, int k) {
  constexpr float C = 0.92387953251128674f, S = 0.38268343236508980f,
                  H = 0.70710678118654752f;
  switch (k & 15) {
    case 0: return x;
    case 1: return cmul(x, make_float2(C, -S));
    case 2: return cmul(x, make_float2(H, -H));
    case 3: return cmul(x, make_float2(S, -C));
    case 4: return make_float2(x.y, -x.x);
    case 5: return cmul(x, make_float2(-S, -C));
    case 6: return cmul(x, make_float2(-H, -H));
    case 7: return cmul(x, make_float2(-C, -S));
    case 8: return make_float2(-x.x, -x.y);
    case 9: return cmul(x, make_float2(-C, S));
    case 10: return cmul(x, make_float2(-H, H));
    case 11: return cmul(x, make_float2(-S, C));
    case 12: return make_float2(-x.y, x.x);
    case 13: return cmul(x, make_float2(S, C));
    case 14: return cmul(x, make_float2(H, H));
    default: return cmul(x, make_float2(C, S));
  }
}

// Length-R DFT of v[o .. o+R) in place, natural order in and out: radix-2
// decimation in frequency, then the bit reversal as a register renaming.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[RADIX], int o) {
#pragma unroll
  for (int st = 1; st < R; st <<= 1) {
    const int h = R / (2 * st);
#pragma unroll
    for (int base = 0; base < R; base += 2 * h) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float2 a = v[o + base + i], b = v[o + base + i + h];
        v[o + base + i] = make_float2(a.x + b.x, a.y + b.y);
        v[o + base + i + h] = mul_w16(make_float2(a.x - b.x, a.y - b.y), i * 8 / h);
      }
    }
  }
  float2 w[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int r = 0;
#pragma unroll
    for (int b = 1; b < R; b <<= 1) r = (r << 1) | ((k & b) ? 1 : 0);
    w[k] = v[o + r];
  }
#pragma unroll
  for (int k = 0; k < R; ++k) v[o + k] = w[k];
}

// Pass s's butterflies on the thread's registers (their inputs in v),
// twiddled unless s is the last pass.
template <int M, int s>
__device__ __forceinline__ void butterflies(float2 (&v)[RADIX], const float2* __restrict__ tw,
                                            int t) {
  using P = Plan<M>;
  constexpr int R = P::radix(s), Q = P::len(s) / R;
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i) {
    dft<R>(v, i * R);
    if constexpr (s < P::PASSES - 1) {
      const int u = (t + P::THREADS * i) & (Q - 1);
#pragma unroll
      for (int c = 1; c < R; ++c)
        v[i * R + c] = cmul(v[i * R + c], __ldg(tw + P::tw_off(s) + (c - 1) * Q + u));
    }
  }
}

// Shared index of element r of the thread's butterfly i in pass s.
template <int M, int s>
__device__ __forceinline__ int slot(int t, int i, int r) {
  using P = Plan<M>;
  constexpr int L = P::len(s), Q = L / P::radix(s);
  const int b = t + P::THREADS * i;
  return pad((b / Q) * L + (b & (Q - 1)) + Q * r);
}

template <int M, int s>
__device__ __forceinline__ void to_shared(const float2 (&v)[RADIX], float2* sm, int t) {
  constexpr int R = Plan<M>::radix(s);
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) sm[slot<M, s>(t, i, r)] = v[i * R + r];
}

template <int M, int s>
__device__ __forceinline__ void from_shared(float2 (&v)[RADIX], const float2* sm, int t) {
  constexpr int R = Plan<M>::radix(s);
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) v[i * R + r] = sm[slot<M, s>(t, i, r)];
}

// Passes s.. of the transform: each reads its inputs from shared memory,
// runs its butterflies and, but for the last, writes them back in place
// (its own butterflies' positions: no barrier between read and write).
template <int M, int s>
__device__ __forceinline__ void passes(float2 (&v)[RADIX], float2* sm,
                                       const float2* __restrict__ tw, int t) {
  if constexpr (s < Plan<M>::PASSES) {
    from_shared<M, s>(v, sm, t);
    butterflies<M, s>(v, tw, t);
    if constexpr (s < Plan<M>::PASSES - 1) {
      to_shared<M, s>(v, sm, t);
      __syncthreads();
    }
    passes<M, s + 1>(v, sm, tw, t);
  }
}

// Frequency held at storage index b R + c after the last pass (R its
// radix): the base-16 digits of b, pass 0's first, reversed below c.
template <int M>
__device__ __forceinline__ int frequency(int b, int c) {
  using P = Plan<M>;
  int f = c << (4 * (P::PASSES - 1));
#pragma unroll
  for (int p = 0; p < P::PASSES - 1; ++p) f |= ((b >> (4 * (P::PASSES - 2 - p))) & 15) << (4 * p);
  return f;
}

// Forward packed-real W transform of one row, T = M / 16 threads: the row
// x (even plane at x, odd at x + M, io type T) -> half spectrum (zr, zi),
// split order, Z[M] in Im of lane 0.  `e` is the unpack table at split
// positions, `tw` the radix twiddles; n1 * n2 = M are the split factors.
template <typename T, int M>
__device__ void rfft_row(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                         const float2* __restrict__ e, const float2* __restrict__ tw, int n1,
                         int n2, float2* sm) {
  using P = Plan<M>;
  constexpr int NT = P::THREADS, V = vec_len<T>();
  const int t = threadIdx.x;
  float2 v[RADIX];
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    v[r].x = ld1(x + t + NT * r, Fix{});
    v[r].y = ld1(x + M + t + NT * r, Fix{});
  }
  butterflies<M, 0>(v, tw, t);
  if constexpr (P::PASSES > 1) {
    to_shared<M, 0>(v, sm, t);
    __syncthreads();
    passes<M, 1>(v, sm, tw, t);
  }
  __syncthreads();  // every read of the last pass is done: the buffer is free
  constexpr int R = P::radix(P::PASSES - 1);
  const int l1 = __ffs(n1) - 1, l2 = __ffs(n2) - 1;
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int f = frequency<M>(t + NT * i, c);
      sm[(f & (n1 - 1)) * (n2 + 1) + (f >> l1)] = v[i * R + c];
    }
  __syncthreads();
  // w_fwd_core's store loop: Z[k] = (S + e D) / 2 from P[k] and the mirror
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = t * V; p0 < M; p0 += NT * V) {
    float outr[V], outi[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      const int k1 = pos >> l2, k2 = pos & (n2 - 1);
      const int mp = mirror_pos(k1, k2, n1, n2);
      const int m1 = mp >> l2, m2 = mp & (n2 - 1);
      const float2 Pk = sm[k1 * (n2 + 1) + k2], Rm = sm[m1 * (n2 + 1) + m2];
      const float2 w = __ldg(e + pos);
      const float Sr = Pk.x + Rm.x, Si = Pk.y - Rm.y;
      const float Dr = Pk.x - Rm.x, Di = Pk.y + Rm.y;
      outr[k] = 0.5f * (Sr + w.x * Di + w.y * Dr);
      outi[k] = pos ? 0.5f * (Si - (w.x * Dr - w.y * Di)) : Pk.x - Pk.y;
    }
    unrot(outr, s);
    unrot(outi, s);
    stv<V>(zr + p0, outr);
    stv<V>(zi + p0, outi);
  }
}

}  // namespace fft
}  // namespace lpt
