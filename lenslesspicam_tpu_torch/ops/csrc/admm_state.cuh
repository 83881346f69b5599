// Shared device code of the ADMM state kernels: the TV / non-negativity
// step of one row (K3 `e1_rtv`, K8 `e1_rcarry` in the even/odd split lane
// layout, K10 `e1_carry` in natural lane order) and the X / v update (K6
// `irfft_w_dual_state`, K8, K10).
//
// Planes may carry a leading plane axis: a kernel sees P * ph rows, row r
// of plane r / ph.  The H axis is periodic within a plane, so the halo
// rows wrap at the plane's edges (`plane_rows`).  A per-PSF constant plane
// (the support mask) is stacked Pc deep with P % Pc == 0, and plane p
// reads constant plane p % Pc (`const_row`): the constants are broadcast
// over the batch, never copied P times.
#pragma once
#include "lpt_dft.cuh"

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

}  // namespace lpt
