// Register-resident radix FFT of one complex row of length M = 2^e per
// block (64 <= M <= 8192), the packed-real forward and inverse W
// transforms built on it (the radix designs of K1, K2, K3 and K6, M <=
// 4096), the inverse of two full-width spectra
// (the radix designs of K11 and K13, 512 <= M <= 8192), the forward
// transform of two real rows (the radix designs of K12 and K10, 512 <= M
// <= 8192) and
// the column form: one transform down each lane of a tile of columns
// (K5's radix design, M = 128), and the pieces of a length-48 = 3 x 16
// transform (K4's and K14's radix design, the end of this file).
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

// The lengths of the radix FFT: powers of two from 64 to 8192 (at most
// 512 threads a row).
__host__ __device__ constexpr bool radix_length(int m) {
  return m >= 64 && m <= 8192 && (m & (m - 1)) == 0;
}

template <int M>
struct Plan {
  static_assert(radix_length(M), "M is a power of two from 64 to 8192");
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

// Position in the transform of element r of the thread's butterfly i in
// pass s.
template <int M, int s>
__device__ __forceinline__ int position(int t, int i, int r) {
  using P = Plan<M>;
  constexpr int L = P::len(s), Q = L / P::radix(s);
  const int b = t + P::THREADS * i;
  return (b / Q) * L + (b & (Q - 1)) + Q * r;
}

// Shared index of element r of the thread's butterfly i in pass s.
template <int M, int s>
__device__ __forceinline__ int slot(int t, int i, int r) {
  return pad(position<M, s>(t, i, r));
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

// Forward packed-real W transform of one row, T = M / 16 threads, from the
// thread's pass-0 registers v[r] = x_even[j] + i x_odd[j] at j = t + T r
// -> half spectrum (zr, zi), split order, Z[M] in Im of lane 0.  `e` is
// the unpack table at split positions, `tw` the radix twiddles; n1 * n2 =
// M are the split factors.  Starts with the buffer sm free.
template <typename T, int M>
__device__ __forceinline__ void rfft_core(float2 (&v)[RADIX], T* __restrict__ zr,
                                          T* __restrict__ zi, const float2* __restrict__ e,
                                          const float2* __restrict__ tw, int n1, int n2,
                                          float2* sm) {
  using P = Plan<M>;
  constexpr int NT = P::THREADS, V = vec_len<T>();
  const int t = threadIdx.x;
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

// Forward packed-real W transform of one row (K1's radix design): the row
// x (even plane at x, odd at x + M, io type T) loaded straight into
// rfft_core's pass-0 registers (one coalesced access per r, all 2 * 16
// loads issued before the first butterfly).
template <typename T, int M>
__device__ void rfft_row(const T* __restrict__ x, T* __restrict__ zr, T* __restrict__ zi,
                         const float2* __restrict__ e, const float2* __restrict__ tw, int n1,
                         int n2, float2* sm) {
  constexpr int NT = Plan<M>::THREADS;
  const int t = threadIdx.x;
  float2 v[RADIX];
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    v[r].x = ld1(x + t + NT * r, Fix{});
    v[r].y = ld1(x + M + t + NT * r, Fix{});
  }
  rfft_core<T, M>(v, zr, zi, e, tw, n1, n2, sm);
}

// ---------------------------------------------------------------------------
// Inverse packed-real W transform of one row (the radix designs of K2 and
// K6): rfft_core run backwards.
//
//   1. the half spectrum (split order, 16-byte loads, lane 0 replaced by
//      the caller's z0) into the split layout [k1 (n2+1) + k2] of the
//      buffer;
//   2. thread t gathers its pass-0 frequencies f = t + T r with their
//      mirrors M - f from there and undoes the packed-real unpack as
//      w_inv_core does: P[f] = E[f] + i O[f], E = (Z[f] + conj Z[M-f]) /
//      2, O = conj(w^f) (Z[f] - conj Z[M-f]) / 2 (f = 0: Z[0] and Z[M],
//      packed in lane 0); the factors w^f come from the table's natural-order
//      unpack section, so a warp's loads are consecutive;
//   3. the M-point inverse by conjugation, p = conj(fft(conj P)) / M,
//      through the forward passes and twiddles;
//   4. one exchange from the last pass's digit order into natural order
//      (slot pad(j): the writes of a warp fall on distinct bank pairs),
//      read back at j = t + T r.
// The result, p[j] = x_even[j] + i x_odd[j], stays in the thread's
// registers at j = t + T r: K2 stores it (store_split_row), K6 updates it
// in place and hands it to rfft_core.
// ---------------------------------------------------------------------------

// v[r] <- x_even[j] + i x_odd[j] at j = t + T r of the row whose half
// spectrum is (zr, zi) (io type T, lane 0 replaced by z0), T = M / 16
// threads; `en` the unpack factors w^f at natural f, `tw` the radix
// twiddles, n1 * n2 = M the split factors, sm the buffer of
// smem_bytes(M, n1, n2).  Starts with sm free; the caller synchronises
// before it next writes sm.
template <typename T, int M>
__device__ __forceinline__ void irfft_row(const T* __restrict__ zr, const T* __restrict__ zi,
                                          float2 z0, const float2* __restrict__ en,
                                          const float2* __restrict__ tw, int n1, int n2,
                                          float2* sm, float2 (&v)[RADIX]) {
  using P = Plan<M>;
  constexpr int NT = P::THREADS, R = P::radix(P::PASSES - 1), V = vec_len<T>();
  const int t = threadIdx.x;
  const int l1 = __ffs(n1) - 1, l2 = __ffs(n2) - 1;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = t * V; p0 < M; p0 += NT * V) {
    float re[V], im[V];
    ldv<V>(zr + p0, re);
    ldv<V>(zi + p0, im);
    rot(re, s);
    rot(im, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      sm[(pos >> l2) * (n2 + 1) + (pos & (n2 - 1))] = pos ? make_float2(re[k], im[k]) : z0;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    const int f = t + NT * r, fm = (M - f) & (M - 1);
    const float2 z = sm[(f & (n1 - 1)) * (n2 + 1) + (f >> l1)];
    const float2 q = sm[(fm & (n1 - 1)) * (n2 + 1) + (fm >> l1)];
    const float2 w = __ldg(en + f);
    float Er, Ei, Or, Oi;
    if (f == 0) {
      Er = 0.5f * (z.x + z.y);
      Ei = 0.f;
      Or = 0.5f * (z.x - z.y);
      Oi = 0.f;
    } else {
      const float wr = w.x, wi = -w.y;
      Er = 0.5f * (z.x + q.x);
      Ei = 0.5f * (z.y - q.y);
      const float Dr = 0.5f * (z.x - q.x), Di = 0.5f * (z.y + q.y);
      Or = wr * Dr - wi * Di;
      Oi = wr * Di + wi * Dr;
    }
    v[r] = make_float2(Er - Oi, -(Ei + Or));  // conj P[f]
  }
  butterflies<M, 0>(v, tw, t);
  __syncthreads();  // every gather read is done: the buffer takes pass 0's outputs
  to_shared<M, 0>(v, sm, t);
  __syncthreads();
  passes<M, 1>(v, sm, tw, t);
  __syncthreads();  // every read of the last pass is done
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) sm[pad(frequency<M>(t + NT * i, c))] = v[i * R + c];
  __syncthreads();
  constexpr float sc = 1.f / M;
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    const float2 x = sm[pad(t + NT * r)];
    v[r] = make_float2(x.x * sc, -x.y * sc);
  }
}

// Stores v[r] = x_even[j] + i x_odd[j] (j = t + T r, T = M / 16 threads) to
// the split layout [x_even | x_odd] of a row at `out`, as T (one coalesced
// access per r and plane).
template <typename T, int M>
__device__ __forceinline__ void store_split_row(const float2 (&v)[RADIX], T* __restrict__ out,
                                                Fix f = {}) {
  constexpr int NT = Plan<M>::THREADS;
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    st1(out + t + NT * r, v[r].x, f);
    st1(out + M + t + NT * r, v[r].y, f);
  }
}

// The radix table of a packed-real length M (kernels._design_table): the
// split design's [r1f | r2f | r1i | r2i | Tf | Ti | E] (make_plan), the
// radix twiddles, then the unpack factors at natural frequencies.
template <int M>
struct RTable {
  const float2 *e, *tw, *en;
  __host__ __device__ RTable(const float2* tab, int n1, int n2)
      : e(make_plan(tab, n1, n2).e), tw(e + M), en(tw + Plan<M>::tw_off(Plan<M>::PASSES - 1)) {}
};


// ---------------------------------------------------------------------------
// Inverse of two full-width split-order spectra (the radix designs of K11,
// one row's two spectra, and K13, two rows' spectra).
//
// image = Re ifft(a0) and fwd = Re ifft(a1) for any spectra a0, a1 of a
// row of W = M = n1 n2 points (n2 = 128, n1 = M / 128), through the one
// complex inverse of C = herm(a0) + i s herm(a1) (lpt_dft.cuh's
// full-width note; s the balancing power of two).  Taken by conjugation,
// ifft(C) = conj(fft(conj C)) / M, so the forward passes and twiddle
// table above serve as they are.  Every phase exchanges through one
// padded buffer of M + M/16 float2:
//   1. mirror pairs.  Split position (k1, k2) holds frequency f = k1 +
//      n1 k2; its mirror M - f sits at (n1 - k1, n2 - 1 - k2) for k1 != 0,
//      so a thread loads a vector of V = 16 / sizeof(T) positions of row
//      k1 (1 <= k1 < n1/2, and k1 = n1/2 for k2 < n2/2) and its mirror
//      vector of row n1 - k1, both aligned 16-byte loads, the mirror read
//      backwards.  Row 0 (f = n1 k2 against n1 (n2 - k2)) goes by scalar
//      loads.  For each pair it writes the Hermitian parts 2 herm(a0) and
//      2 herm(a1) at q = min(f, M - f) as one float4 (the half spectra,
//      q <= M/2) and takes the block max of the raw values.
//   2. gather.  Thread t reads conj(2 C) at its pass-0 positions f = t + T
//      r from the half spectra (herm(a)[M - q] = conj(herm(a)[q])).
//   3. the forward passes; then one exchange puts the row in natural
//      order j (slot j + j / 256: the last pass's writes lie 256 apart
//      across a warp), and the stores write Re / 2M to image and
//      -Im / (2 M s) to fwd, V' = vec_len<TO>() outputs a thread a trip
//      (TO the output type).
// Units of phase 1 go to threads so that lanes l and l + 8 read the two
// halves of one 32-byte sector and the eight lanes of a 16-byte shared
// access write eight consecutive q.
// ---------------------------------------------------------------------------

// The lengths of the full-width radix designs, K11's, K12's and K13's
// (n1 = M / 128 >= 4).
__host__ __device__ constexpr bool inv_length(int m) {
  return radix_length(m) && m >= 512;
}

// Shared bytes of the inverse row: the padded passes' buffer, which also
// holds the half spectra (M/2 + 1 float4) and the natural-order exchange.
__host__ inline size_t inv_smem_bytes(int m) { return sizeof(float2) * (size_t)(m + m / 16); }

// Slot of natural index j in the output exchange.
__device__ __forceinline__ int out_slot(int j) { return j + (j >> 8); }

// Split position (k1, first k2) of phase 1's unit u: units u < NR NKV pair
// row k1 = 1 + p % NR with row n1 - k1, at vector 2 (p / NR) + lo, where p
// and lo split u as (u >> 4) << 3 | (u & 7) and bit 3 of u; the NKV / 2
// after them pair the first half of row n1/2 with its second half.
template <int M, int V>
__device__ __forceinline__ void unit_pos(int u, int& k1, int& k2) {
  constexpr int N2 = 128, N1 = M / N2, NR = N1 / 2 - 1, NKV = N2 / V;
  if (u < NR * NKV) {
    const int p = ((u >> 4) << 3) | (u & 7);
    k1 = 1 + p % NR;
    k2 = (2 * (p / NR) + ((u >> 3) & 1)) * V;
  } else {
    k1 = N1 / 2;
    k2 = (u - NR * NKV) * V;
  }
}

// Phase 1 (see above) for the row's planes a0 (r, i) and a1 (r, i): the
// half spectra into h; returns the balancing power of two.  Ends
// synchronised.
template <typename T, int M>
__device__ float load_half_spectra(const T* __restrict__ a0r, const T* __restrict__ a0i,
                                   const T* __restrict__ a1r, const T* __restrict__ a1i,
                                   float4* h) {
  constexpr int NT = Plan<M>::THREADS, N2 = 128, N1 = M / N2, V = 16 / sizeof(T);
  constexpr int NU = (N1 / 2 - 1) * (N2 / V) + N2 / V / 2;
  static_assert(inv_length(M) && N2 % (2 * V) == 0, "K11's radix lengths");
  const T* __restrict__ pl[4] = {a0r, a0i, a1r, a1i};
  const int t = threadIdx.x;
  float m0 = 0.f, m1 = 0.f;
#pragma unroll 1
  for (int u = t; u < NU; u += NT) {
    int k1, k2;
    unit_pos<M, V>(u, k1, k2);
    const int p = k1 * N2 + k2, pm = (N1 - k1) * N2 + N2 - V - k2;
    float x[4][V], y[4][V];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ldv<V>(pl[c] + p, x[c]);
      ldv<V>(pl[c] + pm, y[c]);
    }
    const bool lower = k2 < N2 / 2;  // f < M/2 over the whole vector
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int f = k1 + N1 * (k2 + e), em = V - 1 - e;
      // a[f] = x[.][e], a[M - f] = y[.][em]; 2 herm(a) at q = min(f, M - f)
      const float s0 = x[0][e] + y[0][em], d0 = x[1][e] - y[1][em];
      const float s1 = x[2][e] + y[2][em], d1 = x[3][e] - y[3][em];
      h[lower ? f : M - f] = lower ? make_float4(s0, d0, s1, d1) : make_float4(s0, -d0, s1, -d1);
      m0 = fmaxf(m0, fmaxf(fmaxf(fabsf(x[0][e]), fabsf(x[1][e])),
                           fmaxf(fabsf(y[0][em]), fabsf(y[1][em]))));
      m1 = fmaxf(m1, fmaxf(fmaxf(fabsf(x[2][e]), fabsf(x[3][e])),
                           fmaxf(fabsf(y[2][em]), fabsf(y[3][em]))));
    }
  }
  // row 0: f = n1 k2 pairs with n1 (n2 - k2) mod M; k2 = 0 and n2/2 with themselves
  for (int k2 = t; k2 <= N2 / 2; k2 += NT) {
    const int km = (N2 - k2) & (N2 - 1);
    float x[4], y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = ld1(pl[c] + k2, Fix{});
      y[c] = ld1(pl[c] + km, Fix{});
    }
    h[N1 * k2] = make_float4(x[0] + y[0], x[1] - y[1], x[2] + y[2], x[3] - y[3]);
    m0 = fmaxf(m0, fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(y[0]), fabsf(y[1]))));
    m1 = fmaxf(m1, fmaxf(fmaxf(fabsf(x[2]), fabsf(x[3])), fmaxf(fabsf(y[2]), fabsf(y[3]))));
  }
  return pow2_balance(block_max2<NT>(m0, m1));
}

// Image = Re and fwd = Im of the natural-order row in the output exchange,
// times sc0 and sc1, as T (TWO false: image alone, o1 unused).
template <typename T, int M, bool TWO = true>
__device__ __forceinline__ void store_two(const float2* sm, T* __restrict__ o0,
                                          T* __restrict__ o1, float sc0, float sc1) {
  constexpr int NT = Plan<M>::THREADS, V = vec_len<T>();
  const int s = lane_rot<V, 1>();
#pragma unroll
  for (int j0 = threadIdx.x * V; j0 < M; j0 += NT * V) {
    float re[V], im[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 x = sm[out_slot(j0 + ((k + s) & (V - 1)))];
      re[k] = x.x * sc0;
      im[k] = x.y * sc1;
    }
    unrot(re, s);
    if constexpr (TWO) unrot(im, s);
    stv<V>(o0 + j0, re);
    if constexpr (TWO) stv<V>(o1 + j0, im);
  }
}

// image = Re ifft(a0), fwd = Re ifft(a1) of one row (split-order spectra,
// io type T, natural-order outputs stored as TO), T = M / 16 threads; `tw`
// the radix twiddles, sm the buffer of inv_smem_bytes(M), 16-byte aligned.
// TWO false: image alone is stored (fwd unused).
template <typename T, int M, typename TO = T, bool TWO = true>
__device__ void ifft_two_rows(const T* __restrict__ a0r, const T* __restrict__ a0i,
                              const T* __restrict__ a1r, const T* __restrict__ a1i,
                              TO* __restrict__ img, TO* __restrict__ fwd,
                              const float2* __restrict__ tw, float2* sm) {
  using P = Plan<M>;
  constexpr int NT = P::THREADS, R = P::radix(P::PASSES - 1);
  const int t = threadIdx.x;
  float4* h = reinterpret_cast<float4*>(sm);
  const float sc = load_half_spectra<T, M>(a0r, a0i, a1r, a1i, h);
  // conj(2 C) at f = t + NT r: f < M/2 for r < 8, f >= M/2 from r = 8
  float2 v[RADIX];
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    const int f = t + NT * r;
    if (r < RADIX / 2) {
      const float4 g = h[f];
      v[r] = make_float2(g.x - sc * g.w, -(g.y + sc * g.z));
    } else {
      const float4 g = h[M - f];
      v[r] = make_float2(g.x + sc * g.w, g.y - sc * g.z);
    }
  }
  butterflies<M, 0>(v, tw, t);
  __syncthreads();  // every gather read is done: the buffer takes pass 0's outputs
  to_shared<M, 0>(v, sm, t);
  __syncthreads();
  passes<M, 1>(v, sm, tw, t);
  __syncthreads();  // every read of the last pass is done
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) sm[out_slot(frequency<M>(t + NT * i, c))] = v[i * R + c];
  __syncthreads();
  store_two<TO, M, TWO>(sm, img, fwd, 0.5f / M, -0.5f / (M * sc));
}


// ---------------------------------------------------------------------------
// Forward transform of two real rows (K12's radix design).
//
// X0 = fft(x0) and X1 = fft(x1) of two real rows of W = M = n1 n2 points
// (n2 = 128, n1 = M / 128), split order, from the one complex forward
// transform of z = x0 + i s x1 (lpt_dft.cuh's full-width note; s the
// balancing power of two).  Pass 0 loads z straight from device memory as
// rfft_row loads a row, and the block max of |x0| and |x1| is taken on
// those registers before the first butterfly (the power of two
// balance_imag gives).  After the passes one exchange puts frequency f at
// split position (f % n1, f / n1) of the layout [k1 (n2+1) + k2], and the
// store separates the two spectra through the mirror as
// store_two_spectra does: X0[k] = (Z[k] + conj Z[-k]) / 2, X1[k] = (Z[k] -
// conj Z[-k]) / 2i s, V = vec_len<T>() positions a thread a trip.
// ---------------------------------------------------------------------------

// The transform of z from the thread's pass-0 registers v[r] = x0[j] + i
// s x1[j] at j = t + T r (s the balancing power of two, already applied)
// -> X0 into (x0r, x0i) and, with `two`, X1 into (x1r, x1i), stored as T;
// T = M / 16 threads, `tw` the radix twiddles, sm the buffer of
// smem_bytes(M, M / 128, 128), free at the start.  K12 loads v
// (fft_two_real_rows), K10's radix design computes it (e1_carry.cu).
template <typename T, int M>
__device__ __forceinline__ void fft_two_real_core(float2 (&v)[RADIX], float sc,
                                                  T* __restrict__ x0r, T* __restrict__ x0i,
                                                  T* __restrict__ x1r, T* __restrict__ x1i,
                                                  const float2* __restrict__ tw, float2* sm,
                                                  bool two) {
  using P = Plan<M>;
  constexpr int NT = P::THREADS, R = P::radix(P::PASSES - 1), V = vec_len<T>();
  constexpr int N2 = 128, N1 = M / N2, L1 = ilog2(N1), L2 = ilog2(N2);
  static_assert(inv_length(M), "K12's radix lengths");
  const int t = threadIdx.x;
  butterflies<M, 0>(v, tw, t);
  to_shared<M, 0>(v, sm, t);
  __syncthreads();
  passes<M, 1>(v, sm, tw, t);
  __syncthreads();  // every read of the last pass is done: the buffer is free
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int f = frequency<M>(t + NT * i, c);
      sm[(f & (N1 - 1)) * (N2 + 1) + (f >> L1)] = v[i * R + c];
    }
  __syncthreads();
  const float inv_s = 1.f / sc;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = t * V; p0 < M; p0 += NT * V) {
    float ar[V], ai[V], br[V], bi[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      const int k1 = pos >> L2, k2 = pos & (N2 - 1);
      const int mp = mirror_pos(k1, k2, N1, N2);
      const float2 z = sm[k1 * (N2 + 1) + k2], q = sm[(mp >> L2) * (N2 + 1) + (mp & (N2 - 1))];
      ar[k] = 0.5f * (z.x + q.x);
      ai[k] = 0.5f * (z.y - q.y);
      br[k] = 0.5f * (z.y + q.y) * inv_s;
      bi[k] = 0.5f * (q.x - z.x) * inv_s;
    }
    unrot(ar, s);
    unrot(ai, s);
    stv<V>(x0r + p0, ar);
    stv<V>(x0i + p0, ai);
    if (two) {
      unrot(br, s);
      unrot(bi, s);
      stv<V>(x1r + p0, br);
      stv<V>(x1i + p0, bi);
    }
  }
}

// X0 and X1 of the rows x0 and x1 (io type T; x1 null: a row of zeros,
// and x1r, x1i unused), T = M / 16 threads; `tw` the radix twiddles, sm
// the buffer of smem_bytes(M, M / 128, 128).
template <typename T, int M>
__device__ void fft_two_real_rows(const T* __restrict__ x0, const T* __restrict__ x1,
                                  T* __restrict__ x0r, T* __restrict__ x0i,
                                  T* __restrict__ x1r, T* __restrict__ x1i,
                                  const float2* __restrict__ tw, float2* sm) {
  constexpr int NT = Plan<M>::THREADS;
  const int t = threadIdx.x;
  const bool two = x1 != nullptr;
  float2 v[RADIX];
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    v[r].x = ld1(x0 + t + NT * r, Fix{});
    v[r].y = two ? ld1(x1 + t + NT * r, Fix{}) : 0.f;
    m0 = fmaxf(m0, fabsf(v[r].x));
    m1 = fmaxf(m1, fabsf(v[r].y));
  }
  const float sc = pow2_balance(block_max2<NT>(m0, m1));
#pragma unroll
  for (int r = 0; r < RADIX; ++r) v[r].y *= sc;
  fft_two_real_core<T, M>(v, sc, x0r, x0i, x1r, x1i, tw, sm, two);
}

// ---------------------------------------------------------------------------
// Column form (K5's radix design): the transforms of length M down the
// columns of a tile of TW lanes, one column a lane, M / 16 threads a
// column.  Thread (lane, t) = threadIdx.x as lane + TW t, so a warp is 32
// consecutive lanes of one t: every device access of a warp is 32
// consecutive elements of one row of the (n1, n2, W) view, and every
// shared access 32 consecutive float2 of the buffer laid out
// [position][lane] (sm[p TW + lane], M TW float2), which needs no pad.
//
// Forward (col_fft): the thread's pass-0 registers v[r] at column
// position j = t + T r, as the caller loads them; the passes of the row
// FFT above, each exchange through the buffer at the positions of the
// pass that wrote and of the pass that reads; after the last pass v[i R +
// c] holds frequency(t + T i, c) (digit order).
//
// Inverse (col_ifft): the forward network transposed, which takes that
// digit order in and gives natural order out.  Each pass of the forward
// network maps its butterflies' inputs to outputs by D (DFT_R x) with D
// the twiddles and DFT_R symmetric; the transposed network runs the
// passes from the last, each as DFT_R (D x) on the same positions, and so
// computes the DFT of the natural-order vector whose digit-order
// registers it was given.  On conj(F) that is conj of the unscaled inverse
// of F.  One exchange a pass boundary, as the forward takes: the
// alternative, an exchange into natural order and then the forward passes
// by conjugation (K11's way), needs two.  After pass 0 v[r] holds
// position j = t + T r, which the caller stores to its own row.
// ---------------------------------------------------------------------------

// v <-> the buffer at the positions of pass s, in the column of `lane`.
template <int M, int s, int TW>
__device__ __forceinline__ void col_to_shared(const float2 (&v)[RADIX], float2* sm, int t,
                                              int lane) {
  constexpr int R = Plan<M>::radix(s);
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) sm[position<M, s>(t, i, r) * TW + lane] = v[i * R + r];
}

template <int M, int s, int TW>
__device__ __forceinline__ void col_from_shared(float2 (&v)[RADIX], const float2* sm, int t,
                                                int lane) {
  constexpr int R = Plan<M>::radix(s);
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) v[i * R + r] = sm[position<M, s>(t, i, r) * TW + lane];
}

// Passes s.. of the forward column transform: pass s - 1's outputs go to
// the buffer at its positions and come back at pass s's.  The first write
// needs the buffer free (the caller's barrier); a later one goes to the
// positions the thread itself read.
template <int M, int s, int TW>
__device__ __forceinline__ void col_passes(float2 (&v)[RADIX], float2* sm,
                                           const float2* __restrict__ tw, int t, int lane) {
  if constexpr (s < Plan<M>::PASSES) {
    col_to_shared<M, s - 1, TW>(v, sm, t, lane);
    __syncthreads();
    col_from_shared<M, s, TW>(v, sm, t, lane);
    butterflies<M, s>(v, tw, t);
    col_passes<M, s + 1, TW>(v, sm, tw, t, lane);
  }
}

// Forward transform of the thread's column (see above).  Starts with the
// buffer free.
template <int M, int TW>
__device__ __forceinline__ void col_fft(float2 (&v)[RADIX], float2* sm,
                                        const float2* __restrict__ tw, int t, int lane) {
  butterflies<M, 0>(v, tw, t);
  col_passes<M, 1, TW>(v, sm, tw, t, lane);
}

// Pass s of the transposed network on the thread's registers: pass s's
// twiddles (none in the last pass), then its DFTs.
template <int M, int s>
__device__ __forceinline__ void butterflies_t(float2 (&v)[RADIX], const float2* __restrict__ tw,
                                              int t) {
  using P = Plan<M>;
  constexpr int R = P::radix(s), Q = P::len(s) / R;
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i) {
    if constexpr (s < P::PASSES - 1) {
      const int u = (t + P::THREADS * i) & (Q - 1);
#pragma unroll
      for (int c = 1; c < R; ++c)
        v[i * R + c] = cmul(v[i * R + c], __ldg(tw + P::tw_off(s) + (c - 1) * Q + u));
    }
    dft<R>(v, i * R);
  }
}

// Passes s, s - 1, .., 0 of the transposed network: after pass s the
// registers go to the buffer at its positions and come back at pass
// s - 1's.  The first write needs the buffer free (the caller's barrier).
template <int M, int s, int TW>
__device__ __forceinline__ void col_passes_t(float2 (&v)[RADIX], float2* sm,
                                             const float2* __restrict__ tw, int t, int lane) {
  butterflies_t<M, s>(v, tw, t);
  if constexpr (s > 0) {
    col_to_shared<M, s, TW>(v, sm, t, lane);
    __syncthreads();
    col_from_shared<M, s - 1, TW>(v, sm, t, lane);
    col_passes_t<M, s - 1, TW>(v, sm, tw, t, lane);
  }
}

// v (digit order, as col_fft leaves it) <- the unscaled inverse of the
// spectrum F it holds, at j = t + T r.  Starts with the buffer free.
template <int M, int TW>
__device__ __forceinline__ void col_ifft(float2 (&v)[RADIX], float2* sm,
                                         const float2* __restrict__ tw, int t, int lane) {
#pragma unroll
  for (int r = 0; r < RADIX; ++r) v[r].y = -v[r].y;
  col_passes_t<M, Plan<M>::PASSES - 1, TW>(v, sm, tw, t, lane);
#pragma unroll
  for (int r = 0; r < RADIX; ++r) v[r].y = -v[r].y;
}

// ---------------------------------------------------------------------------
// Length 48 = 3 x 16 (the radix design of K4 and K14, the H axis's stage 1
// at n1 = 48), decimation in time: with j = 3 j' + g and k = k' + 16 c,
//   X[k] = sum_g exp(-2 pi i g c / 3) Y_g[k'],
//   Y_g[k'] = exp(-2 pi i g k' / 48) sum_j' x[3 j' + g] exp(-2 pi i j' k' / 16),
// three length-16 DFTs (dft<16>), their twiddles, then 16 radix-3
// butterflies.  Every root is a constant once the caller's loops unroll:
// the roots are immediates of the multiplies, no table.
// ---------------------------------------------------------------------------

constexpr int N48 = 48;

// cos(2 pi q / 48), q = 0 .. 12, from float64 values rounded to f32.
__device__ __forceinline__ float cos48(int q) {
  switch (q) {
    case 0: return 1.f;
    case 1: return 0.99144486137381038f;
    case 2: return 0.96592582628906829f;
    case 3: return 0.92387953251128674f;
    case 4: return 0.86602540378443865f;
    case 5: return 0.79335334029123517f;
    case 6: return 0.70710678118654752f;
    case 7: return 0.60876142900872066f;
    case 8: return 0.5f;
    case 9: return 0.38268343236508980f;
    case 10: return 0.25881904510252074f;
    case 11: return 0.13052619222005159f;
    default: return 0.f;
  }
}

// x * exp(-2 pi i m / 48), m >= 0 a constant once the caller's loops
// unroll: a multiple of 3 is a root of 16 (mul_w16: 1, -i, -1, i cost no
// multiply); any other is exp(-2 pi i q / 48) (q = m mod 12) turned by m /
// 12 quarter turns, each (a, b) -> (b, -a).
__device__ __forceinline__ float2 mul_w48(float2 x, int m) {
  m %= N48;
  if (m % 3 == 0) return mul_w16(x, m / 3);
  const int q = m % 12;
  float2 w = make_float2(cos48(q), -cos48(12 - q));
#pragma unroll
  for (int t = 0; t < m / 12; ++t) w = make_float2(w.y, -w.x);
  return cmul(x, w);
}

// Output c (0, 1 or 2) of the length-3 DFT of (a, b, d): a + b + d, or
// m -/+ i sin(2 pi / 3) t with m = a - (b + d) / 2, t = b - d.
__device__ __forceinline__ float2 radix3(float2 a, float2 b, float2 d, int c) {
  constexpr float H3 = 0.86602540378443865f;  // sin(2 pi / 3)
  const float2 s = make_float2(b.x + d.x, b.y + d.y);
  if (c == 0) return make_float2(a.x + s.x, a.y + s.y);
  const float2 t = make_float2(b.x - d.x, b.y - d.y);
  const float2 m = make_float2(a.x - 0.5f * s.x, a.y - 0.5f * s.y);
  const float h = c == 1 ? H3 : -H3;
  return make_float2(m.x + h * t.y, m.y - h * t.x);
}

}  // namespace fft
}  // namespace lpt
