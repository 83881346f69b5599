// Shared device code of the port's kernels: the batched DFT stages on
// shared memory, the packed-real W-axis cores (half-spectrum solver) and
// the complex full-width W cores (full-width solver).
//
// A length-n axis is factored n = n1 * n2.  The forward two-stage DFT
// contracts j1 with F1[k1, j1] = r1[(k1 j1) mod n1], multiplies by the
// twiddle T[k1, j2], then contracts j2 with F2[j2, k2] = r2[(j2 k2) mod n2];
// frequency k1 + n1 k2 lands at split position (k1, k2).  The inverse runs
// the stages in reverse with the conjugate roots and scales by 1/n.  The
// roots, twiddles and unpack factors come from one f32 table per length
// (built on the host in float64, as the JAX package builds its plans):
//   [r1f (n1) | r2f (n2) | r1i (n1) | r2i (n2) | Tf (n) | Ti (n) | E (n)]
//
// Each stage is a DFT in FFMA.  A stage of length L >= 16 runs as two
// direct passes of lengths a and b (L = a*b, Cooley-Tukey, `dft`), so a
// point costs a + b complex multiply-adds instead of L: 36 instead of 160
// for a 12 MP half-width W core (32 = 4*8, 128 = 8*16), 40 instead of 192
// for the full-width one (64 = 8*8, 128 = 8*16), 16 instead of 48 along H.
// The design keeps every intermediate of a row or column tile in shared
// memory (one HBM read and write per plane) and register-tiles each pass
// 4 outputs x 4 vectors per thread, so one shared load feeds four complex
// multiply-adds.  Shared layouts are padded to odd strides where a pass's
// threads would otherwise hit one bank.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "storage.cuh"

namespace lpt {

struct Plan {
  const float2 *r1f, *r2f, *r1i, *r2i, *tf, *ti, *e;
  int n1, n2, n;
};

__host__ __device__ inline Plan make_plan(const float2* tab, int n1, int n2) {
  Plan p;
  p.n1 = n1;
  p.n2 = n2;
  p.n = n1 * n2;
  p.r1f = tab;
  p.r2f = tab + n1;
  p.r1i = tab + n1 + n2;
  p.r2i = tab + 2 * n1 + n2;
  p.tf = tab + 2 * (n1 + n2);
  p.ti = p.tf + p.n;
  p.e = p.ti + p.n;
  return p;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Copy the four root tables (2 (n1 + n2) entries) of a plan to shared memory.
__device__ __forceinline__ void load_roots(float2* dst, const Plan& p) {
  for (int i = threadIdx.x; i < 2 * (p.n1 + p.n2); i += blockDim.x) dst[i] = p.r1f[i];
}

constexpr int KT = 4;  // outputs per thread tile
constexpr int VT = 4;  // vectors per thread tile

// One batched direct DFT pass.  Vector g < nvec splits as g1 = g % ninner,
// g2 = g / ninner; for k < L:
//   out[g1*os1 + g2*os2 + k*oks] = scale * tw * sum_{j<L} in[g1*is1 + g2*is2 + j*iks]
//                                               * roots[((j*k) mod L) * rs]
// with tw = tg[g1*ts1 + g2*ts2 + k*tks] (global table, if tg) times
// roots[(g2*k) mod (L*rs)] (if ct).  L and nvec are multiples of 4, or,
// in the tail form (kTail), any lengths >= 1: the tile counts round up, and
// a tile's outputs k >= L and vectors g >= nvec are computed on clamped
// indices (k = L - 1, g = nvec - 1) and not stored, so every (k, g) pair is
// written once (L = 1 is the identity stage of a one-factor split).
// Threads of a warp take consecutive vectors of one k tile, so a root load
// is a broadcast and unit-stride vectors load without bank conflicts.
struct Pass {
  const float2* in;
  int is1, is2, iks;
  float2* out;
  int os1, os2, oks;
  int ninner, nvec, L, rs;
  const float2* roots;
  const float2* tg;
  int ts1, ts2, tks;
  bool ct;
  float scale;
};

// Tiles of KT (VT) along a length n: n / KT, or rounded up in the tail form.
template <bool kTail>
__device__ __forceinline__ int tiles(int n, int t) {
  return kTail ? (n + t - 1) / t : n / t;
}

template <bool kTail = false>
__device__ __forceinline__ void dft_pass(const Pass& q) {
  const int ktiles = tiles<kTail>(q.L, KT), vtiles = tiles<kTail>(q.nvec, VT),
            mod = q.L * q.rs;
  for (int t = threadIdx.x; t < ktiles * vtiles; t += blockDim.x) {
    const int tv = t % vtiles, k0 = (t / vtiles) * KT;
    int off[VT];
#pragma unroll
    for (int b = 0; b < VT; ++b) {
      const int g = kTail ? min(tv + b * vtiles, q.nvec - 1) : tv + b * vtiles;
      off[b] = (g % q.ninner) * q.is1 + (g / q.ninner) * q.is2;
    }
    float2 acc[KT][VT];
    int idx[KT];
#pragma unroll
    for (int a = 0; a < KT; ++a) {
      idx[a] = 0;
#pragma unroll
      for (int b = 0; b < VT; ++b) acc[a][b] = make_float2(0.f, 0.f);
    }
    for (int j = 0; j < q.L; ++j) {
      float2 x[VT];
#pragma unroll
      for (int b = 0; b < VT; ++b) x[b] = q.in[off[b] + j * q.iks];
#pragma unroll
      for (int a = 0; a < KT; ++a) {
        const float2 w = q.roots[idx[a]];
#pragma unroll
        for (int b = 0; b < VT; ++b) {
          acc[a][b].x = fmaf(x[b].x, w.x, fmaf(-x[b].y, w.y, acc[a][b].x));
          acc[a][b].y = fmaf(x[b].x, w.y, fmaf(x[b].y, w.x, acc[a][b].y));
        }
        idx[a] += (kTail ? min(k0 + a, q.L - 1) : k0 + a) * q.rs;
        if (idx[a] >= mod) idx[a] -= mod;
      }
    }
#pragma unroll
    for (int a = 0; a < KT; ++a) {
      const int k = k0 + a;
#pragma unroll
      for (int b = 0; b < VT; ++b) {
        const int g = tv + b * vtiles, g1 = g % q.ninner, g2 = g / q.ninner;
        if (kTail && (k >= q.L || g >= q.nvec)) continue;
        float2 r = make_float2(acc[a][b].x * q.scale, acc[a][b].y * q.scale);
        if (q.tg) r = cmul(r, __ldg(q.tg + g1 * q.ts1 + g2 * q.ts2 + k * q.tks));
        if (q.ct) r = cmul(r, q.roots[(g2 * k) % mod]);
        q.out[g1 * q.os1 + g2 * q.os2 + k * q.oks] = r;
      }
    }
  }
}

// Split of a DFT length into two passes, L = a * b with a, b multiples of
// 4 and a + b least; 0 when L is too short to gain (direct pass).
__host__ __device__ inline int dft_split(int L) {
  int best = 0;
  for (int a = 4; a * a <= L; a += 4)
    if (L % a == 0 && (L / a) % 4 == 0) best = a;
  return best;
}

// Whether a split-design row of n = n1 * n2 points, moved v elements a
// trip, takes the general form of its kernel: the tail form of the DFT
// passes (a factor not a multiple of 4, or n1 = 1) and one element a trip
// (a row length not a multiple of v, whose rows are not 16-byte aligned).
// The kernels' fast form keeps the 4 x 4 tiles and v-element trips.
__host__ inline bool general_form(int n1, int n2, int n, int v) {
  return n1 % 4 || n2 % 4 || n % v;
}

// The same for an H-axis kernel's tile of tw lanes running a length-L
// stage: L not a multiple of 4, or a lane width w not a multiple of tw
// (the last tile's lanes past w are neither loaded nor stored).
__host__ inline bool general_tile(int L, int w, int tw) { return L % 4 || w % tw; }

// Scratch a split stage needs beyond L * nvec in the buffer it borrows.
__host__ __device__ inline int dft_slack(int L) {
  const int a = dft_split(L);
  return a ? L / a : 0;
}

// A DFT stage of length L over nvec vectors (vector v at in + v*ivs,
// element j at j*iks), written as out[v*ovs + k*oks] = scale * tw[v*tw_vs
// + k*tw_ks] * sum_j in[..j..] * roots[(j*k) mod L], roots (shared) holding
// exp(-+2 pi i m / L).  `src` holds the input; `spare` is a second buffer
// of the same capacity.  A direct stage writes the result into `spare`;
// a split stage (L = a*b, Cooley-Tukey: length-a DFTs over j_a, the twiddle
// roots[j_b*k_a], length-b DFTs over j_b, k = k_a + a*k_b) runs its first
// pass into `spare` and its second back into `src`.  Returns the buffer
// holding the result; the caller synchronises before reading it.  kTail:
// the passes' tail form (any L and nvec).
template <bool kTail = false>
__device__ float2* dft(float2* src, float2* spare, int ivs, int iks, int ovs, int oks, int L,
                       int nvec, const float2* roots, const float2* tw, int tw_vs, int tw_ks,
                       float scale) {
  const int a = dft_split(L);
  if (!a) {
    dft_pass<kTail>(Pass{src, ivs, 0, iks, spare, ovs, 0, oks, nvec, nvec, L, 1, roots, tw,
                         tw_vs, 0, tw_ks, false, scale});
    return spare;
  }
  const int b = L / a, sb = a * nvec + 1;
  // pass 1: vectors (v, j_b), length a over j_a; out spare[j_b*sb + k_a*nvec + v]
  dft_pass<kTail>(Pass{src, ivs, iks, b * iks, spare, 1, sb, nvec, nvec, nvec * b, a, b, roots,
                       nullptr, 0, 0, 0, true, 1.f});
  __syncthreads();
  // pass 2: vectors (v, k_a), length b over j_b; out src[v*ovs + (k_a + a*k_b)*oks]
  dft_pass<kTail>(Pass{spare, 1, nvec, sb, src, ovs, oks, a * oks, nvec, nvec * a, b, a, roots,
                       tw, tw_vs, tw_ks, a * tw_ks, false, scale});
  return src;
}

// Shared memory of one W-core row: two padded buffers and the roots.
__host__ __device__ inline int w_buf_len(int n1, int n2) { return (n1 + 1) * (n2 + 1); }
__host__ inline size_t w_smem_bytes(int n1, int n2) {
  return sizeof(float2) * (2 * (size_t)w_buf_len(n1, n2) + 2 * (n1 + n2));
}

// Split position of frequency (n - k) mod n for the frequency k at split
// position (k1, k2) of a length-n = n1 * n2 transform.
__device__ __forceinline__ int mirror_pos(int k1, int k2, int n1, int n2) {
  const int s1 = k1 ? n1 - k1 : 0;
  const int s2 = k1 ? n2 - 1 - k2 : (k2 ? n2 - k2 : 0);
  return s1 * n2 + s2;
}

// Complex forward two-stage transform of the row A[j] (natural j = j1*n2 +
// j2 < n) through the second buffer B.  Returns the buffer that holds the
// split-order spectrum at [k1*(n2+1) + k2].  kTail: the tail form (any n1,
// n2; see dft_pass).
template <bool kTail = false>
__device__ inline const float2* c_fwd_core(float2* A, float2* B, const Plan& p, const float2* R) {
  const int n1 = p.n1, n2 = p.n2;
  // stage 1: vectors j2, contract j1 -> [j2*(n1+1) + k1], twiddle Tf[k1, j2]
  float2* Y = dft<kTail>(A, B, 1, n2, n1 + 1, 1, n1, n2, R, p.tf, 1, n2, 1.f);
  __syncthreads();
  // stage 2: vectors k1, contract j2 -> [k1*(n2+1) + k2]
  const float2* P = dft<kTail>(Y, Y == A ? B : A, 1, n1 + 1, n2 + 1, 1, n2, n1, R + n1, nullptr,
                               0, 0, 1.f);
  __syncthreads();
  return P;
}

// Complex inverse two-stage transform of the split-order spectrum held in A
// at [k2*(n1+1) + k1], through B.  Returns the buffer that holds the row at
// natural j = j1*n2 + j2, times `scale`.  kTail as for c_fwd_core.
template <bool kTail = false>
__device__ inline float2* c_inv_core(float2* A, float2* B, const Plan& p, const float2* R,
                                     float scale) {
  const int n1 = p.n1, n2 = p.n2;
  // inner: vectors k1, contract k2 -> [k1*(n2+1) + j2], twiddle Ti[k1, j2]
  float2* Y = dft<kTail>(A, B, 1, n1 + 1, n2 + 1, 1, n2, n1, R + 2 * n1 + n2, p.ti, n2, 1, 1.f);
  __syncthreads();
  // outer: vectors j2, contract k1 -> [j1*n2 + j2]
  float2* X = dft<kTail>(Y, Y == A ? B : A, 1, n2 + 1, 1, n2, n1, n2, R + n1 + n2, nullptr, 0, 0,
                         scale);
  __syncthreads();
  return X;
}

// Forward packed-real W core.  On entry A[j] = x_even[j] + i x_odd[j] for
// natural j = j1*n2 + j2 (j < m); B is the second row buffer; R the shared
// roots.  Writes the half spectrum of the row, split order, Z[m] in Im of
// lane 0, as T, V positions per thread per trip (storage.cuh).  kTail: the
// tail form of the DFT (any n1, n2), with V = 1.
template <typename T, int V, bool kTail = false>
__device__ void w_fwd_core(float2* A, float2* B, const Plan& p, const float2* R, T* zr, T* zi) {
  const int n1 = p.n1, n2 = p.n2, m = p.n;
  const float2* P = c_fwd_core<kTail>(A, B, p, R);
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = threadIdx.x * V; p0 < m; p0 += blockDim.x * V) {
    float outr[V], outi[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      const int k1 = pos / n2, k2 = pos - k1 * n2;
      const int mp = mirror_pos(k1, k2, n1, n2);
      const int m1 = mp / n2, m2 = mp - m1 * n2;
      const float2 Pk = P[k1 * (n2 + 1) + k2], Rm = P[m1 * (n2 + 1) + m2];
      const float2 e = __ldg(p.e + pos);
      const float Sr = Pk.x + Rm.x, Si = Pk.y - Rm.y;
      const float Dr = Pk.x - Rm.x, Di = Pk.y + Rm.y;
      outr[k] = 0.5f * (Sr + e.x * Di + e.y * Dr);
      outi[k] = pos ? 0.5f * (Si - (e.x * Dr - e.y * Di)) : Pk.x - Pk.y;
    }
    unrot(outr, s);
    unrot(outi, s);
    stv<V>(zr + p0, outr);
    stv<V>(zi + p0, outi);
  }
  __syncthreads();
}

// Inverse packed-real W core.  Reads the row's half spectrum (T; lane 0
// replaced by z0) into the row buffers A and B and returns the one that
// holds x_even[j] + i x_odd[j] at natural j = j1*n2 + j2, scaled by 1/m.
// kTail as for w_fwd_core.
template <typename T, int V, bool kTail = false>
__device__ float2* w_inv_core(const T* zr, const T* zi, float2 z0, float2* A, float2* B,
                              const Plan& p, const float2* R) {
  const int n1 = p.n1, n2 = p.n2, m = p.n;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = threadIdx.x * V; p0 < m; p0 += blockDim.x * V) {
    float re[V], im[V];
    ldv<V>(zr + p0, re);
    ldv<V>(zi + p0, im);
    rot(re, s);
    rot(im, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      B[pos] = pos ? make_float2(re[k], im[k]) : z0;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int pos = threadIdx.x; pos < m; pos += blockDim.x) {
    const int k1 = pos / n2, k2 = pos - k1 * n2;
    const float2 z = B[pos];
    float Er, Ei, Or, Oi;
    if (pos == 0) {
      Er = 0.5f * (z.x + z.y);
      Ei = 0.f;
      Or = 0.5f * (z.x - z.y);
      Oi = 0.f;
    } else {
      const float2 r = B[mirror_pos(k1, k2, n1, n2)];
      const float2 e = __ldg(p.e + pos);
      const float wr = e.x, wi = -e.y;
      Er = 0.5f * (z.x + r.x);
      Ei = 0.5f * (z.y - r.y);
      const float Dr = 0.5f * (z.x - r.x), Di = 0.5f * (z.y + r.y);
      Or = wr * Dr - wi * Di;
      Oi = wr * Di + wi * Dr;
    }
    A[k2 * (n1 + 1) + k1] = make_float2(Er - Oi, Ei + Or);
  }
  __syncthreads();
  return c_inv_core<kTail>(A, B, p, R, 1.f / (float)m);
}

// ---------------------------------------------------------------------------
// Full-width W rows (K10-K13): a row of n = n1 * n2 complex values, two real
// rows at once.  The forward transform of z = x0 + i x1 gives both real
// rows' spectra through the mirror, X0[k] = (Z[k] + conj(Z[-k])) / 2 and
// X1[k] = (Z[k] - conj(Z[-k])) / 2i; the inverse of C = herm(a0) + i
// herm(a1), herm(a)[k] = (a[k] + conj(a[-k])) / 2, is Re ifft(a0) + i Re
// ifft(a1) for any spectra a0, a1.  One DFT serves two rows, exactly in
// the kernels' contract.  The rounding of a shared DFT is relative to the
// larger row, so the second row is first scaled by a power of two (exact)
// into the binade of the first and its outputs scaled back: in the solver
// v (order mu1) rides beside rk (order tau), 100 times larger.  The
// full-width kernels run FW_THREADS threads a block.
// ---------------------------------------------------------------------------

constexpr int FW_THREADS = 512;

// (max a, max b) over the block's NT threads (a power of two), by a
// shared-memory tree; every thread gets it.  Ends synchronised.
template <int NT = FW_THREADS>
__device__ inline float2 block_max2(float a, float b) {
  __shared__ float2 red[NT];
  const int t = threadIdx.x;
  red[t] = make_float2(a, b);
  __syncthreads();
  for (int h = NT / 2; h > 0; h >>= 1) {
    if (t < h) red[t] = make_float2(fmaxf(red[t].x, red[t + h].x), fmaxf(red[t].y, red[t + h].y));
    __syncthreads();
  }
  const float2 r = red[0];
  __syncthreads();
  return r;
}

// The power of two 2^k that brings a row of max |x| = m1 into the binade of
// a row of max |x| = m0 (1 if either is 0 or not finite), |k| <= 100.
__device__ inline float pow2_balance(float2 m) {
  if (!(m.x > 0.f && m.y > 0.f && m.x < INFINITY && m.y < INFINITY)) return 1.f;
  int k = ilogbf(m.x) - ilogbf(m.y);
  k = k > 100 ? 100 : (k < -100 ? -100 : k);
  return ldexpf(1.f, k);
}

// Scales the imaginary parts of the complex row A[j] (j < n) by the power
// of two that balances them against the real parts; returns it.  Starts
// and ends synchronised.
__device__ inline float balance_imag(float2* A, int n) {
  float m0 = 0.f, m1 = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    m0 = fmaxf(m0, fabsf(A[j].x));
    m1 = fmaxf(m1, fabsf(A[j].y));
  }
  const float s = pow2_balance(block_max2(m0, m1));
  for (int j = threadIdx.x; j < n; j += blockDim.x) A[j].y *= s;
  __syncthreads();
  return s;
}

// A[j] <- x0[j] + i x1[j] for j < n (x1 null: 0), widened from T.
template <typename T, int V>
__device__ void load_two_rows(const T* x0, const T* x1, float2* A, int n) {
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int j0 = threadIdx.x * V; j0 < n; j0 += blockDim.x * V) {
    float re[V], im[V] = {};
    ldv<V>(x0 + j0, re);
    if (x1) ldv<V>(x1 + j0, im);
    rot(re, s);
    rot(im, s);
#pragma unroll
    for (int k = 0; k < V; ++k) A[j0 + ((k + s) & (V - 1))] = make_float2(re[k], im[k]);
  }
}

// From the split-order spectrum P of z = x0 + i x1 s at [k1*(n2+1) + k2]
// (c_fwd_core), the split-order spectra of x0 and x1 (times inv_s = 1/s)
// as T (x1r null: x0's only).
template <typename T, int V>
__device__ void store_two_spectra(const float2* P, const Plan& p, T* x0r, T* x0i, T* x1r, T* x1i,
                                  float inv_s) {
  const int n1 = p.n1, n2 = p.n2, n = p.n;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = threadIdx.x * V; p0 < n; p0 += blockDim.x * V) {
    float ar[V], ai[V], br[V], bi[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      const int k1 = pos / n2, k2 = pos - k1 * n2;
      const int mp = mirror_pos(k1, k2, n1, n2);
      const int m1 = mp / n2, m2 = mp - m1 * n2;
      const float2 z = P[k1 * (n2 + 1) + k2], q = P[m1 * (n2 + 1) + m2];
      ar[k] = 0.5f * (z.x + q.x);
      ai[k] = 0.5f * (z.y - q.y);
      br[k] = 0.5f * (z.y + q.y) * inv_s;
      bi[k] = 0.5f * (q.x - z.x) * inv_s;
    }
    unrot(ar, s);
    unrot(ai, s);
    stv<V>(x0r + p0, ar);
    stv<V>(x0i + p0, ai);
    if (x1r) {
      unrot(br, s);
      unrot(bi, s);
      stv<V>(x1r + p0, br);
      stv<V>(x1i + p0, bi);
    }
  }
}

// Loads the split-order spectra a0, a1 (T) of one row and leaves C =
// herm(a0) + i herm(a1) s in A at c_inv_core's layout [k2*(n1+1) + k1],
// s the balancing power of two, which it returns; B is scratch.  a1r
// null: a1 = 0.  Ends synchronised.
template <typename T, int V>
__device__ float load_two_spectra(const T* a0r, const T* a0i, const T* a1r, const T* a1i,
                                  float2* A, float2* B, const Plan& p) {
  const int n1 = p.n1, n2 = p.n2, n = p.n;
  const int s = lane_rot<V, 1>();
  float m0 = 0.f, m1 = 0.f;
#pragma unroll(V == 1 ? 4 : 1)
  for (int p0 = threadIdx.x * V; p0 < n; p0 += blockDim.x * V) {
    float re[V], im[V], br[V] = {}, bi[V] = {};
    ldv<V>(a0r + p0, re);
    ldv<V>(a0i + p0, im);
    if (a1r) {
      ldv<V>(a1r + p0, br);
      ldv<V>(a1i + p0, bi);
    }
    rot(re, s);
    rot(im, s);
    rot(br, s);
    rot(bi, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int pos = p0 + ((k + s) & (V - 1));
      const int k1 = pos / n2, k2 = pos - k1 * n2;
      A[k2 * (n1 + 1) + k1] = make_float2(re[k], im[k]);
      B[k2 * (n1 + 1) + k1] = make_float2(br[k], bi[k]);
      m0 = fmaxf(m0, fmaxf(fabsf(re[k]), fabsf(im[k])));
      m1 = fmaxf(m1, fmaxf(fabsf(br[k]), fabsf(bi[k])));
    }
  }
  const float sc = pow2_balance(block_max2(m0, m1)), hs = 0.5f * sc;
  // each mirror pair {k, -k} by one thread, in place; frequency f = k1 + n1 k2
  for (int pos = threadIdx.x; pos < n; pos += blockDim.x) {
    const int k1 = pos / n2, k2 = pos - k1 * n2;
    const int f = k1 + n1 * k2;
    if (f > (f ? n - f : 0)) continue;
    const int mp = mirror_pos(k1, k2, n1, n2);
    const int m1 = mp / n2, m2 = mp - m1 * n2;
    const int i = k2 * (n1 + 1) + k1, j = m2 * (n1 + 1) + m1;
    const float2 a = A[i], am = A[j], b = B[i], bm = B[j];
    const float h0r = 0.5f * (a.x + am.x), h0i = 0.5f * (a.y - am.y);
    const float h1r = hs * (b.x + bm.x), h1i = hs * (b.y - bm.y);
    A[i] = make_float2(h0r - h1i, h0i + h1r);
    if (j != i) A[j] = make_float2(h0r + h1i, h1r - h0i);
  }
  __syncthreads();
  return sc;
}

// Store the row X[j] (j < n) as its real part to o0 and its imaginary part
// times inv_s to o1 (null: dropped), as T.
template <typename T, int V>
__device__ void store_two_rows(const float2* X, int n, T* o0, T* o1, float inv_s) {
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int j0 = threadIdx.x * V; j0 < n; j0 += blockDim.x * V) {
    float re[V], im[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 x = X[j0 + ((k + s) & (V - 1))];
      re[k] = x.x;
      im[k] = x.y * inv_s;
    }
    unrot(re, s);
    stv<V>(o0 + j0, re);
    if (o1) {
      unrot(im, s);
      stv<V>(o1 + j0, im);
    }
  }
}

// Store a row held as X[j] = x_even[j] + i x_odd[j] (j < m) to its split
// layout [x_even | x_odd] in device memory, as T.
template <typename T, int V>
__device__ void store_row(const float2* X, T* out, int m) {
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int j0 = threadIdx.x * V; j0 < m; j0 += blockDim.x * V) {
    float ev[V], od[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 x = X[j0 + ((k + s) & (V - 1))];
      ev[k] = x.x;
      od[k] = x.y;
    }
    unrot(ev, s);
    unrot(od, s);
    stv<V>(out + j0, ev);
    stv<V>(out + m + j0, od);
  }
}

// Launch helper: opt in to the dynamic shared memory, launch, report.
template <typename K, typename... Args>
inline int launch(K kernel, dim3 grid, dim3 block, size_t smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace lpt
