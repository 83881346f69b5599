// Shared device code of the ADMM state kernels: the TV / non-negativity
// step of one row (K3 `e1_rtv`, K8 `e1_rcarry` in the even/odd split lane
// layout, K10 `e1_carry` in natural lane order), through a shared row in
// the split designs (`tv_row`) and at a thread's pass-0 positions of the
// radix FFT in the radix designs of K3, K8 and K10 (`tv_pass0`), and the
// X / v update (K6 `irfft_w_dual_state`, K8, K10; at the pass-0 positions
// in K8's radix design, `xv_pass0`).
//
// Planes may carry a leading plane axis: a kernel sees P * ph rows, row r
// of plane r / ph.  The H axis is periodic within a plane, so the halo
// rows wrap at the plane's edges (`plane_rows`).  A per-PSF constant plane
// (the support mask) is stacked Pc deep with P % Pc == 0, and plane p
// reads constant plane p % Pc (`const_row`): the constants are broadcast
// over the batch, never copied P times.
#pragma once
#include "lpt_fft.cuh"

namespace lpt {

__device__ __forceinline__ float soft(float x, float thr) {
  return copysignf(fmaxf(fabsf(x) - thr, 0.f), x);
}

// Element offsets of row r (n elements a row) and of its previous and next
// row in the same plane of ph rows.
struct RowOffs {
  size_t c, p, n;
};

__device__ __forceinline__ RowOffs plane_rows(int r, int ph, int n) {
  const int lr = r % ph;
  const size_t base = (size_t)(r - lr);
  return {(base + lr) * n, (base + (lr + ph - 1) % ph) * n, (base + (lr + 1) % ph) * n};
}

// Element offset of the constant row that row r reads: row r % ph of
// constant plane (r / ph) % pc.
__device__ __forceinline__ size_t const_row(int r, int ph, int pc, int n) {
  const int pl = r / ph;
  return ((size_t)(pl % pc) * ph + (r - pl * ph)) * n;
}

// Write x[0..V) (natural positions q0 + k of a row of n = 2m elements in
// the even/odd split lane layout) into the packed row buffer f (float
// view of x_even[j] + i x_odd[j]) in the lane-rotated order s; x is
// rotated in place.
template <int V>
__device__ __forceinline__ void put_packed(float* f, float (&x)[V], int q0, int m, int s) {
  rot(x, s);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int q = q0 + ((k + s) & (V - 1));
    f[q < m ? 2 * q : 2 * (q - m) + 1] = x[k];
  }
}

// Write x[0..V) (natural positions q0 + k of a row) into part `part` (0:
// real, 1: imaginary) of the complex row buffer f (float view), in the
// lane-rotated order s; x is rotated in place.
template <int V>
__device__ __forceinline__ void put_part(float* f, float (&x)[V], int q0, int part, int s) {
  rot(x, s);
#pragma unroll
  for (int k = 0; k < V; ++k) f[2 * (q0 + ((k + s) & (V - 1))) + part] = x[k];
}

// The X / v update of one element: xi = mu1 fwd - v,
// X = xdv (xi + mu1 fwd + dp), v' = mu1 X - xi, xdv = c_out + c_diff mask.
__device__ __forceinline__ float xv_update(float fw, float v, float mk, float d, float mu1,
                                           float c_out, float c_diff) {
  const float xi = mu1 * fw - v;
  const float xdv = c_out + c_diff * mk;
  const float X = xdv * (xi + mu1 * fw + d);
  return mu1 * X - xi;
}

// TV / non-negativity step of one row (the JAX kernels' algebra, planes
// periodic in both axes, in the split lane layout or, with kNat, in
// natural lane order):
//   a0' = mu2 soft(psi0 + eta0/mu2, tau/mu2) - eta0, eta0 = mu2 psi0 - a0,
//         psi0 = img[r-1] - img[r]
//   a1' likewise along W, psi1 = roll(img, +1) - img
//   b'  = mu3 max(rho/mu3 + img, 0) - rho, rho = mu3 img - b
//   rk  = b' + (a0'[r+1] - a0'[r]) + (roll(a1', -1) - a1')
// a0', a1', b' are stored (type TC, factors fa / fb); rk is written packed
// into `rk` (float view of the first W-core buffer; with kNat into its real
// parts, rk[2q]), a1' goes through the scratch row `a1s` (float view of the
// second).  A row holds n = 2m elements.  The halo rows (img r-1
// and r+1, a0 r+1) are read straight from device memory and a0' of row
// r+1 is recomputed, so no block depends on another.  With kSat, amax and
// bmax collect max |a0'|, |a1'| and max |b'| before quantization.  Ends
// with the row's values written; the caller synchronises before reading
// `rk`.
template <typename TI, typename TC, int V, bool kSat, bool kNat = false>
__device__ __forceinline__ void tv_row(const TI* __restrict__ img, const TC* __restrict__ a0,
                                       const TC* __restrict__ a1, const TC* __restrict__ b,
                                       TC* __restrict__ a0o, TC* __restrict__ a1o,
                                       TC* __restrict__ bo, RowOffs o, int m, float mu2,
                                       float mu3, float tau, Fix fa, Fix fb, float* rk,
                                       float* a1s, float& amax, float& bmax) {
  const int n = 2 * m;
  const float thr = tau / mu2;
  const int s1 = lane_rot<V, 1>(), s2 = lane_rot<V, 2>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int q0 = threadIdx.x * V; q0 < n; q0 += blockDim.x * V) {
    float x[V], nb[V], ao[V], a[V];
    ldv<V>(img + o.c + q0, x);
    if constexpr (kNat) {
      // roll(+1) in natural lanes: new[q] = x[q-1]
#pragma unroll
      for (int k = 1; k < V; ++k) nb[k] = x[k - 1];
      nb[0] = ld1(img + o.c + (q0 ? q0 - 1 : n - 1), Fix{});
    } else if (q0 >= m) {
      // roll(+1) in split lanes: new_even[j] = odd[j-1], new_odd[j] = even[j]
      ldv<V>(img + o.c + q0 - m, nb);
    } else {
      if constexpr (V > 1) {
        float y[V];
        ldv<V>(img + o.c + m + q0, y);
#pragma unroll
        for (int k = 1; k < V; ++k) nb[k] = y[k - 1];
      }
      nb[0] = ld1(img + o.c + m + (q0 ? q0 - 1 : m - 1), Fix{});
    }
    ldv<V>(a1 + o.c + q0, ao, fa);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float psi1 = nb[k] - x[k];
      const float eta1 = mu2 * psi1 - ao[k];
      a[k] = mu2 * soft(psi1 + eta1 / mu2, thr) - eta1;
      if constexpr (kSat) amax = fmaxf(amax, fabsf(a[k]));
    }
    stv<V>(a1o + o.c + q0, a, fa);
    rot(a, s2);
#pragma unroll
    for (int k = 0; k < V; ++k) a1s[q0 + ((k + s2) & (V - 1))] = a[k];
  }
  __syncthreads();
#pragma unroll(V == 1 ? 4 : 1)
  for (int q0 = threadIdx.x * V; q0 < n; q0 += blockDim.x * V) {
    float x[V], ip[V], in[V], ac[V], an[V], bb[V], adj1[V];
    ldv<V>(img + o.c + q0, x);
    ldv<V>(img + o.p + q0, ip);
    ldv<V>(img + o.n + q0, in);
    ldv<V>(a0 + o.c + q0, ac, fa);
    ldv<V>(a0 + o.n + q0, an, fa);
    ldv<V>(b + o.c + q0, bb, fb);
    // roll(-1): natural new[q] = a1'[q+1]; in split lanes new_even[j] =
    // odd[j], new_odd[j] = even[j+1]
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = q0 + ((k + s2) & (V - 1));
      const int q1 = kNat ? (q + 1 < n ? q + 1 : 0)
                          : (q < m ? m + q : (q - m + 1 < m ? q - m + 1 : 0));
      adj1[k] = a1s[q1] - a1s[q];
    }
    unrot(adj1, s2);
    float a0c[V], bn[V], rkv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float psi_c = ip[k] - x[k];
      const float eta_c = mu2 * psi_c - ac[k];
      a0c[k] = mu2 * soft(psi_c + eta_c / mu2, thr) - eta_c;
      const float psi_n = x[k] - in[k];
      const float eta_n = mu2 * psi_n - an[k];
      const float a0n = mu2 * soft(psi_n + eta_n / mu2, thr) - eta_n;
      const float rho = mu3 * x[k] - bb[k];
      const float w = fmaxf(rho / mu3 + x[k], 0.f);
      bn[k] = mu3 * w - rho;
      rkv[k] = bn[k] + (a0n - a0c[k]) + adj1[k];
      if constexpr (kSat) {
        amax = fmaxf(amax, fabsf(a0c[k]));
        bmax = fmaxf(bmax, fabsf(bn[k]));
      }
    }
    stv<V>(a0o + o.c + q0, a0c, fa);
    stv<V>(bo + o.c + q0, bn, fb);
    if constexpr (kNat) {
      put_part<V>(rk, rkv, q0, 0, s1);
    } else {
      put_packed<V>(rk, rkv, q0, m, s1);
    }
  }
}

// The TV / non-negativity step of one row at the thread's pass-0
// positions j = t + T r (r < 16, T = M / 16 threads) of the radix FFT
// (the radix designs of K3, K8 and K10), tv_row's algebra without its
// shared row or barrier:
//   split lanes (K3, K8; the row holds 2M elements, even plane at j, odd at
//     M + j): v[r] = rk_even[j] + i rk_odd[j], rfft_core's pass-0 input.
//     roll(+1) takes odd[j-1] for the even element (odd[M-1] at j = 0)
//     and even[j] for the odd one; roll(-1) of a1' takes a1'_odd[j] for
//     the even element and a1'_even[j+1] for the odd one (a1'_even[0] at
//     j = M-1), recomputed here from its own three loads (image even[j+1],
//     odd[j], a1 even[j+1]).
//   natural lanes (kNat, K10; a row of M elements): v[r].x = rk[j], the
//     real part of fft_two_real_rows' pass-0 input (v[r].y untouched).
//     roll(+1) takes image j-1, roll(-1) of a1' takes a1'[j+1], recomputed
//     from image j, j+1 and a1 j+1 (wrapping at the row's end).
// a0', a1', b' are stored at j (one coalesced access per r and plane, type
// TC, factors fa / fb); the halo rows (image r-1 and r+1, a0 r+1) are read
// from device memory through o (plane_rows), so no block depends on
// another; a0' of row r+1 is recomputed, as tv_row does.  With kSat, amax
// and bmax collect max |a0'|, |a1'| and max |b'| before quantization.  No
// shared memory, no barrier.
//
// The positions go in batches of RB: every load of a batch is issued
// before its first use and its first store (a store of one position would
// otherwise hold the next position's loads back: one memory latency a
// position), so RB positions' loads are in flight at once.  The W
// neighbours are loaded, not shuffled from the next lane: a form that
// took image j - 1 and a1'[j + 1] by __shfl_up/down_sync and loaded them
// at the warp's edges alone ran within 1 % of this one (H100 80GB HBM3,
// 700 W, ab_kernels.py).
template <bool kNat>
struct TvIn {
  // natural: image j, j-1, j+1; a1 j, j+1; then tv_h_load's five at j.
  // split: image even j, odd j, odd j-1, even j+1; a1 even j, odd j, even
  // j+1; then tv_h_load's five at j and at M + j.
  static constexpr int W = kNat ? 5 : 7, N = W + (kNat ? 5 : 10);
  float u[N];
};

// a' of one TV direction (tv_row's algebra): mu2 soft(psi + eta/mu2, thr)
// - eta, eta = mu2 psi - a.
__device__ __forceinline__ float tv_dual(float psi, float a, float mu2, float thr) {
  const float eta = mu2 * psi - a;
  return mu2 * soft(psi + eta / mu2, thr) - eta;
}

// The loads of the H part at element q: image r-1 and r+1, a0 r and r+1, b.
template <typename TI, typename TC>
__device__ __forceinline__ void tv_h_load(const TI* __restrict__ img, const TC* __restrict__ a0,
                                          const TC* __restrict__ b, RowOffs o, size_t q, Fix fa,
                                          Fix fb, float* u) {
  u[0] = ld1(img + o.p + q, Fix{});
  u[1] = ld1(img + o.n + q, Fix{});
  u[2] = ld1(a0 + o.c + q, fa);
  u[3] = ld1(a0 + o.n + q, fa);
  u[4] = ld1(b + o.c + q, fb);
}

// The H-axis and non-negativity part at element q, image value x there,
// from tv_h_load's u: a0' and b' stored (with kSat their maxima taken),
// b' + (a0'[r+1] - a0'[r]) returned.
template <typename TC, bool kSat>
__device__ __forceinline__ float tv_h(const float* u, float x, TC* __restrict__ a0o,
                                      TC* __restrict__ bo, RowOffs o, size_t q, float mu2,
                                      float mu3, float thr, Fix fa, Fix fb, float& amax,
                                      float& bmax) {
  const float a0c = tv_dual(u[0] - x, u[2], mu2, thr);
  const float a0n = tv_dual(x - u[1], u[3], mu2, thr);
  const float rho = mu3 * x - u[4];
  const float bn = mu3 * fmaxf(rho / mu3 + x, 0.f) - rho;
  st1(a0o + o.c + q, a0c, fa);
  st1(bo + o.c + q, bn, fb);
  if constexpr (kSat) {
    amax = fmaxf(amax, fabsf(a0c));
    bmax = fmaxf(bmax, fabsf(bn));
  }
  return bn + (a0n - a0c);
}

template <typename TI, typename TC, int M, bool kNat>
__device__ __forceinline__ void tv_load(const TI* __restrict__ img, const TC* __restrict__ a0,
                                        const TC* __restrict__ a1, const TC* __restrict__ b,
                                        RowOffs o, int j, Fix fa, Fix fb, TvIn<kNat>& in) {
  const int jm = j ? j - 1 : M - 1, jp = j + 1 < M ? j + 1 : 0;
  float* u = in.u;
  if constexpr (kNat) {
    u[0] = ld1(img + o.c + j, Fix{});
    u[1] = ld1(img + o.c + jm, Fix{});
    u[2] = ld1(img + o.c + jp, Fix{});
    u[3] = ld1(a1 + o.c + j, fa);
    u[4] = ld1(a1 + o.c + jp, fa);
    tv_h_load(img, a0, b, o, j, fa, fb, u + TvIn<kNat>::W);
  } else {
    u[0] = ld1(img + o.c + j, Fix{});
    u[1] = ld1(img + o.c + M + j, Fix{});
    u[2] = ld1(img + o.c + M + jm, Fix{});
    u[3] = ld1(img + o.c + jp, Fix{});
    u[4] = ld1(a1 + o.c + j, fa);
    u[5] = ld1(a1 + o.c + M + j, fa);
    u[6] = ld1(a1 + o.c + jp, fa);
    tv_h_load(img, a0, b, o, j, fa, fb, u + TvIn<kNat>::W);
    tv_h_load(img, a0, b, o, M + j, fa, fb, u + TvIn<kNat>::W + 5);
  }
}

template <typename TC, int M, bool kSat, bool kNat>
__device__ __forceinline__ void tv_point(const TvIn<kNat>& in, TC* __restrict__ a0o,
                                         TC* __restrict__ a1o, TC* __restrict__ bo, RowOffs o,
                                         int j, float mu2, float mu3, float thr, Fix fa, Fix fb,
                                         float2& v, float& amax, float& bmax) {
  const float* u = in.u;
  const float* h = u + TvIn<kNat>::W;
  if constexpr (kNat) {
    const float a1c = tv_dual(u[1] - u[0], u[3], mu2, thr);
    const float a1n = tv_dual(u[0] - u[2], u[4], mu2, thr);
    st1(a1o + o.c + j, a1c, fa);
    if constexpr (kSat) amax = fmaxf(amax, fabsf(a1c));
    v.x = tv_h<TC, kSat>(h, u[0], a0o, bo, o, j, mu2, mu3, thr, fa, fb, amax, bmax) +
          (a1n - a1c);
  } else {
    const float ae = tv_dual(u[2] - u[0], u[4], mu2, thr);
    const float ao = tv_dual(u[0] - u[1], u[5], mu2, thr);
    const float an = tv_dual(u[1] - u[3], u[6], mu2, thr);
    st1(a1o + o.c + j, ae, fa);
    st1(a1o + o.c + M + j, ao, fa);
    if constexpr (kSat) amax = fmaxf(amax, fmaxf(fabsf(ae), fabsf(ao)));
    v.x = tv_h<TC, kSat>(h, u[0], a0o, bo, o, j, mu2, mu3, thr, fa, fb, amax, bmax) + (ao - ae);
    v.y = tv_h<TC, kSat>(h + 5, u[1], a0o, bo, o, M + j, mu2, mu3, thr, fa, fb, amax, bmax) +
          (an - ao);
  }
}

template <typename TI, typename TC, int M, bool kSat, bool kNat, int RB>
__device__ __forceinline__ void tv_pass0(const TI* __restrict__ img, const TC* __restrict__ a0,
                                         const TC* __restrict__ a1, const TC* __restrict__ b,
                                         TC* __restrict__ a0o, TC* __restrict__ a1o,
                                         TC* __restrict__ bo, RowOffs o, float mu2, float mu3,
                                         float tau, Fix fa, Fix fb, float2 (&v)[fft::RADIX],
                                         float& amax, float& bmax) {
  static_assert(fft::RADIX % RB == 0, "whole batches");
  constexpr int NT = fft::Plan<M>::THREADS;
  const float thr = tau / mu2;
  const int t = threadIdx.x;
#pragma unroll
  for (int r0 = 0; r0 < fft::RADIX; r0 += RB) {
    TvIn<kNat> in[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i)
      tv_load<TI, TC, M, kNat>(img, a0, a1, b, o, t + NT * (r0 + i), fa, fb, in[i]);
#pragma unroll
    for (int i = 0; i < RB; ++i)
      tv_point<TC, M, kSat, kNat>(in[i], a0o, a1o, bo, o, t + NT * (r0 + i), mu2, mu3, thr, fa,
                                  fb, v[r0 + i], amax, bmax);
  }
}

// The X / v update of one row at the thread's pass-0 positions j = t + T r
// (r < 16, T = M / 16 threads) of the radix FFT, split lanes (K8's radix
// design; the row holds 2M elements, even plane at j, odd at M + j): fwd,
// v, the mask row and dp loaded at j and M + j, v' = xv_update stored at
// the v carry type TV (factors fv) and left, before quantization, in
// x[r] = v'_even[j] + i v'_odd[j], rfft_core's pass-0 input.  fr is the
// row's element offset, mr its mask row's (const_row).  The positions go
// in batches of RB as in tv_pass0: every load of a batch is issued before
// its first store.  No shared memory, no barrier.
template <typename TI, typename TV, int M, int RB>
__device__ __forceinline__ void xv_pass0(const TI* __restrict__ fwd, const TV* __restrict__ v,
                                         const TI* __restrict__ mask, const TI* __restrict__ dp,
                                         TV* __restrict__ vo, size_t fr, size_t mr, float mu1,
                                         float c_out, float c_diff, Fix fv,
                                         float2 (&x)[fft::RADIX]) {
  static_assert(fft::RADIX % RB == 0, "whole batches");
  constexpr int NT = fft::Plan<M>::THREADS;
  const int t = threadIdx.x;
#pragma unroll
  for (int r0 = 0; r0 < fft::RADIX; r0 += RB) {
    float u[RB][8];  // fwd, v, mask, dp; even then odd
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t j = t + NT * (r0 + i) + (size_t)h * M;
        u[i][h] = ld1(fwd + fr + j, Fix{});
        u[i][2 + h] = ld1(v + fr + j, fv);
        u[i][4 + h] = ld1(mask + mr + j, Fix{});
        u[i][6 + h] = ld1(dp + fr + j, Fix{});
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const size_t j = t + NT * (r0 + i);
      const float ne = xv_update(u[i][0], u[i][2], u[i][4], u[i][6], mu1, c_out, c_diff);
      const float no = xv_update(u[i][1], u[i][3], u[i][5], u[i][7], mu1, c_out, c_diff);
      st1(vo + fr + j, ne, fv);
      st1(vo + fr + M + j, no, fv);
      x[r0 + i] = make_float2(ne, no);
    }
  }
}

}  // namespace lpt
