// K6: v3 post-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `irfft_w_dual_state`
// (kernel `_w_rinv_dual_state_kernel`).  Per row:
//   lane 0 of the a0 / a1 half spectra <- the dc_patch values (p0*, p1*)
//   image = inverse packed-real W transform of a0 (stored)
//   fwd   = inverse packed-real W transform of a1 (never stored)
//   xi = mu1 fwd - v,  X = xdv (xi + mu1 fwd + dp),  v' = mu1 X - xi,
//   xdv = c_out + (c_in - c_out) mask
//   the forward packed-real W transform of v' (K1's core).
//
// The X / v update is `xv_update` (admm_state.cuh), shared with K8.  The
// planes may be a stack of P planes of ph rows (grid P * ph): the mask is
// a stack of Pc planes, P % Pc == 0, and plane p reads mask plane p % Pc.
//
// Storage: the spectra, image, mask and dp in the io type TI (f32 or
// bf16); the patch columns in f32; v and v' in the v carry type TV (f32,
// bf16 or int16 fixed point at full scale 256 mu1, factors fv).  With a
// non-null `sat` (the JAX `with_sat` form, int16 v only) the block also
// reports max |v'| * iv over the pre-quantization f32 values, iv =
// 1/(256 mu1), by one atomicMax into *sat.
//
// Bound on the H100: bytes (4 half-plane and 3 full-plane reads, 2
// full-plane and 2 half-plane writes, each once; the three W cores of a
// row do 108 complex multiply-adds per point at 12 MP).  One block per
// row holds the row's spectra, fwd and v' in two shared buffers (about
// 69 KB at 12 MP, three blocks per SM): fwd is turned into v' in place and
// fed straight to the forward core.
#include <type_traits>

#include "admm_state.cuh"

using namespace lpt;

template <typename TI, typename TV>
__global__ void __launch_bounds__(256, 3) w_dual_state_kernel(
    const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
    const TI* __restrict__ a1i, const float* __restrict__ p0r, const float* __restrict__ p0i,
    const float* __restrict__ p1r, const float* __restrict__ p1i, const TV* __restrict__ v,
    const TI* __restrict__ mask, const TI* __restrict__ dp, TI* __restrict__ img,
    TV* __restrict__ vo, TI* __restrict__ vwr, TI* __restrict__ vwi,
    const float2* __restrict__ tab, int ph, int pc, int m, int n1, int n2, float mu1, float c_out,
    float c_diff, Fix fv, float iv, float* __restrict__ sat) {
  constexpr int V = vec_len<TI, TV>();
  constexpr bool kSat = std::is_same<TV, int16_t>::value;
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  __syncthreads();
  const int r = blockIdx.x, n = 2 * m;
  const size_t hr = (size_t)r * m, fr = (size_t)r * n, mr = const_row(r, ph, pc, n);
  const float2* X = w_inv_core<TI, V>(a0r + hr, a0i + hr, make_float2(p0r[r], p0i[r]), A, B, p, R);
  store_row<TI, V>(X, img + fr, m);
  __syncthreads();
  float2* F = w_inv_core<TI, V>(a1r + hr, a1i + hr, make_float2(p1r[r], p1i[r]), A, B, p, R);
  float* f = reinterpret_cast<float*>(F);
  const int s = lane_rot<V, 1>();
  float vmax = 0.f;
#pragma unroll(V == 1 ? 4 : 1)
  for (int q0 = threadIdx.x * V; q0 < n; q0 += blockDim.x * V) {
    float fw[V], vv[V], mk[V], d[V], vn[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int q = q0 + ((k + s) & (V - 1));
      fw[k] = f[q < m ? 2 * q : 2 * (q - m) + 1];
    }
    unrot(fw, s);
    ldv<V>(v + fr + q0, vv, fv);
    ldv<V>(mask + mr + q0, mk);
    ldv<V>(dp + fr + q0, d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      vn[k] = xv_update(fw[k], vv[k], mk[k], d[k], mu1, c_out, c_diff);
      if constexpr (kSat) vmax = fmaxf(vmax, fabsf(vn[k]));
    }
    stv<V>(vo + fr + q0, vn, fv);
    put_packed<V>(f, vn, q0, m, s);
  }
  if constexpr (kSat) {
    if (sat) block_max_to(vmax * iv, sat);
  }
  __syncthreads();
  w_fwd_core<TI, V>(F, F == A ? B : A, p, R, vwr + hr, vwi + hr);
}

template <typename TI, typename TV>
static int run(const void* const* in, const float* const* cols, void* const* out,
               const float2* tab, int rows, int ph, int pc, int m, int n1, int n2, float mu1,
               float c_out, float c_diff, Fix fv, float iv, float* sat, void* stream) {
  return launch(w_dual_state_kernel<TI, TV>, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TI*)in[2], (const TI*)in[3], cols[0],
                cols[1], cols[2], cols[3], (const TV*)in[4], (const TI*)in[5], (const TI*)in[6],
                (TI*)out[0], (TV*)out[1], (TI*)out[2], (TI*)out[3], tab, ph, pc, m, n1, n2, mu1,
                c_out, c_diff, fv, iv, sat);
}

// rows: P * ph, the rows of all planes; ph: the rows of one plane; pc:
// the planes of the mask.  io: storage code of the spectra, image, mask
// and dp (F32 or BF16); vt: that of v and v' (F32, BF16 or I16).
// ld_v/st_v: the int16 factors of v; iv: its inverse full scale; sat: a
// zeroed f32 scalar or null.
extern "C" int lpt_w_dual_state(const void* a0r, const void* a0i, const void* a1r,
                                const void* a1i, const float* p0r, const float* p0i,
                                const float* p1r, const float* p1i, const void* v,
                                const void* mask, const void* dp, void* img, void* vo, void* vwr,
                                void* vwi, const float2* tab, int rows, int ph, int pc, int m,
                                int n1, int n2, float mu1, float c_out, float c_diff, float ld_v,
                                float st_v, float iv, float* sat, int io, int vt,
                                void* stream) {
  using bf = __nv_bfloat16;
  const void* in[7] = {a0r, a0i, a1r, a1i, v, mask, dp};
  const float* cols[4] = {p0r, p0i, p1r, p1i};
  void* out[4] = {img, vo, vwr, vwi};
  const Fix fv{ld_v, st_v};
#define LPT_W6(TI, TV) \
  return run<TI, TV>(in, cols, out, tab, rows, ph, pc, m, n1, n2, mu1, c_out, c_diff, fv, iv, sat, \
                     stream)
  switch (io * 3 + vt) {
    case F32 * 3 + F32: LPT_W6(float, float);
    case F32 * 3 + BF16: LPT_W6(float, bf);
    case F32 * 3 + I16: LPT_W6(float, int16_t);
    case BF16 * 3 + F32: LPT_W6(bf, float);
    case BF16 * 3 + BF16: LPT_W6(bf, bf);
    case BF16 * 3 + I16: LPT_W6(bf, int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LPT_W6
}
