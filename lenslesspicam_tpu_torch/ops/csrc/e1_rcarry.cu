// K8: v2 pre-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `e1_rcarry` (kernel
// `_e1cr_kernel`).  Per row r of the padded grid (planes in the even/odd
// split lane layout, periodic in both axes):
//   the TV / non-negativity step of K3 (`tv_row`, admm_state.cuh): a0',
//   a1', b' and rk = b' + Psi^T a'
//   xi = mu1 fwd - v, X = xdv (xi + mu1 fwd + dp), v' = mu1 X - xi from
//   the carried forward plane fwd (`xv_update`, shared with K6)
//   the forward packed-real W transforms of rk and of the f32 v' (before
//   v' is quantized), K1's core run twice.
// The JAX kernel fetches whole neighbour row blocks for its H-axis halo
// and uses one row of each, a TPU tiling artefact; here the two halo rows
// are read straight from device memory, periodic within the plane, as in
// K3.  Rows may be those of a stack of P planes of ph rows; the mask is a
// stack of Pc planes, P % Pc == 0, and plane p reads mask plane p % Pc.
// v2 has no in-kernel saturation channel: the solver scans the stored
// int16 carries with K7.
//
// Storage: img, fwd, mask, dp and both spectra in the io type TI (f32 or
// bf16); a0, a1, b and their updates in the TV carry type TC and v, v' in
// the v carry type TV (f32, bf16 or int16 fixed point at full scales
// 8 tau, 32 mu3 and 256 mu1, factors fa, fb, fv).
//
// Bound on the H100: bytes (8 planes read, 4 planes and 4 half planes
// written; the two W cores of a row do 72 complex multiply-adds per point
// at 12 MP).  One block per row: rk is packed into the first shared row
// buffer and transformed, then v' is packed into the same buffer and
// transformed, so the kernel needs K3's 69 KB of shared memory at 12 MP.
#include "admm_state.cuh"

using namespace lpt;

template <typename TI, typename TC, typename TV, bool kGen>
__global__ void __launch_bounds__(256, 3) e1_rcarry_kernel(
    const TI* __restrict__ img, const TI* __restrict__ fwd, const TV* __restrict__ v,
    const TC* __restrict__ b, const TC* __restrict__ a0, const TC* __restrict__ a1,
    const TI* __restrict__ mask, const TI* __restrict__ dp, TI* __restrict__ rkr,
    TI* __restrict__ rki, TI* __restrict__ vwr, TI* __restrict__ vwi, TV* __restrict__ vo,
    TC* __restrict__ a0o, TC* __restrict__ a1o, TC* __restrict__ bo,
    const float2* __restrict__ tab, int ph, int pc, int m, int n1, int n2, float mu1, float mu2,
    float mu3, float tau, float c_out, float c_diff, Fix fa, Fix fb, Fix fv) {
  constexpr int V = kGen ? 1 : vec_len<TI, TC, TV>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int r = blockIdx.x, n = 2 * m;
  const size_t hr = (size_t)r * m, fr = (size_t)r * n, mr = const_row(r, ph, pc, n);
  float* f = reinterpret_cast<float*>(A);
  float amax = 0.f, bmax = 0.f;  // unused: no saturation channel
  tv_row<TI, TC, V, false>(img, a0, a1, b, a0o, a1o, bo, plane_rows(r, ph, n), m, mu2, mu3, tau,
                           fa, fb, f, reinterpret_cast<float*>(B), amax, bmax);
  __syncthreads();
  w_fwd_core<TI, V, kGen>(A, B, p, R, rkr + hr, rki + hr);
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int q0 = threadIdx.x * V; q0 < n; q0 += blockDim.x * V) {
    float fw[V], vv[V], mk[V], d[V], vn[V];
    ldv<V>(fwd + fr + q0, fw);
    ldv<V>(v + fr + q0, vv, fv);
    ldv<V>(mask + mr + q0, mk);
    ldv<V>(dp + fr + q0, d);
#pragma unroll
    for (int k = 0; k < V; ++k) vn[k] = xv_update(fw[k], vv[k], mk[k], d[k], mu1, c_out, c_diff);
    stv<V>(vo + fr + q0, vn, fv);
    put_packed<V>(f, vn, q0, m, s);
  }
  __syncthreads();
  w_fwd_core<TI, V, kGen>(A, B, p, R, vwr + hr, vwi + hr);
}

template <typename TI, typename TC, typename TV>
static int run(const void* const* in, void* const* out, const float2* tab, int rows, int ph,
               int pc, int m, int n1, int n2, float mu1, float mu2, float mu3, float tau,
               float c_out, float c_diff, Fix fa, Fix fb, Fix fv, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<TI, TC, TV>())
                    ? e1_rcarry_kernel<TI, TC, TV, true>
                    : e1_rcarry_kernel<TI, TC, TV, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TV*)in[2], (const TC*)in[3],
                (const TC*)in[4], (const TC*)in[5], (const TI*)in[6], (const TI*)in[7],
                (TI*)out[0], (TI*)out[1], (TI*)out[2], (TI*)out[3], (TV*)out[4], (TC*)out[5],
                (TC*)out[6], (TC*)out[7], tab, ph, pc, m, n1, n2, mu1, mu2, mu3, tau, c_out,
                c_diff, fa, fb, fv);
}

template <typename TI>
static int dispatch(int tv, int vt, const void* const* in, void* const* out, const float2* tab,
                    int rows, int ph, int pc, int m, int n1, int n2, float mu1, float mu2,
                    float mu3, float tau, float c_out, float c_diff, Fix fa, Fix fb, Fix fv,
                    void* stream) {
  using bf = __nv_bfloat16;
#define LPT_E8(TC, TV)                                                                     \
  return run<TI, TC, TV>(in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2, mu3, tau, c_out, \
                         c_diff, fa, fb, fv, stream)
  switch (tv * 3 + vt) {
    case F32 * 3 + F32: LPT_E8(float, float);
    case F32 * 3 + BF16: LPT_E8(float, bf);
    case F32 * 3 + I16: LPT_E8(float, int16_t);
    case BF16 * 3 + F32: LPT_E8(bf, float);
    case BF16 * 3 + BF16: LPT_E8(bf, bf);
    case BF16 * 3 + I16: LPT_E8(bf, int16_t);
    case I16 * 3 + F32: LPT_E8(int16_t, float);
    case I16 * 3 + BF16: LPT_E8(int16_t, bf);
    case I16 * 3 + I16: LPT_E8(int16_t, int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LPT_E8
}

// rows: P * ph, the rows of all planes; ph: the rows of one plane; pc:
// the planes of the mask.  io: storage code of img, fwd, mask, dp and the
// spectra (F32 or BF16);
// tv: that of a0, a1, b and their updates; vt: that of v and v' (F32,
// BF16 or I16).  lda/sta, ldb/stb, ld_v/st_v: the int16 factors of the a,
// b and v carries.
extern "C" int lpt_e1_rcarry(const void* img, const void* fwd, const void* v, const void* b,
                             const void* a0, const void* a1, const void* mask, const void* dp,
                             void* rkr, void* rki, void* vwr, void* vwi, void* vo, void* a0o,
                             void* a1o, void* bo, const float2* tab, int rows, int ph, int pc,
                             int m, int n1, int n2, float mu1, float mu2, float mu3, float tau,
                             float c_out, float c_diff, float lda, float sta, float ldb,
                             float stb, float ld_v, float st_v, int io, int tv, int vt,
                             void* stream) {
  const void* in[8] = {img, fwd, v, b, a0, a1, mask, dp};
  void* out[8] = {rkr, rki, vwr, vwi, vo, a0o, a1o, bo};
  const Fix fa{lda, sta}, fb{ldb, stb}, fv{ld_v, st_v};
  switch (io) {
    case F32:
      return dispatch<float>(tv, vt, in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2, mu3, tau,
                             c_out, c_diff, fa, fb, fv, stream);
    case BF16:
      return dispatch<__nv_bfloat16>(tv, vt, in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2,
                                     mu3, tau, c_out, c_diff, fa, fb, fv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
