// K8: v2 pre-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `e1_rcarry` (kernel
// `_e1cr_kernel`).  Per row r of the padded grid (planes in the even/odd
// split lane layout, periodic in both axes):
//   the TV / non-negativity step of K3: a0', a1', b' and rk = b' + Psi^T a'
//   xi = mu1 fwd - v, X = xdv (xi + mu1 fwd + dp), v' = mu1 X - xi from
//   the carried forward plane fwd (`xv_update`, shared with K6)
//   the forward packed-real W transforms of rk and of the f32 v' (before
//   v' is quantized), K1's transform run twice.
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
// written, each once).  Two designs, chosen by M = N/2 alone in
// `k8::entry` with K1's rule (kernels.e1_rcarry_design =
// rfft_w_design; neither falls back on the other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): the row's two
//   halves share no data, so each runs in a block of its own, M/16 threads
//   (grid rows x 2).  blockIdx.y = 0 is K3's radix design without its
//   saturation channel: `tv_pass0` (admm_state.cuh) computes the TV step
//   at the thread's pass-0 positions j = t + T r of K1's radix FFT, stores
//   a0', a1', b' and leaves rk in the registers for `fft::rfft_core`.
//   blockIdx.y = 1 is K6's tail: `xv_pass0` loads fwd, v, the mask row and
//   dp at j and M + j, stores v' and leaves the f32 v' in the registers for
//   `rfft_core`.  Neither rk nor v' passes through shared memory; one
//   padded buffer of fft::smem_bytes (34.8 KB at M = 4096) a block.
//   1.0231 / 0.7495 ms at 12 MP, f32 / headline (bf16 io, int16
//   carries).  One block a row running both halves, TV first, ran 1.0017
//   / 0.9875 ms: 2 % faster at f32, 32 % slower in the headline mode (the
//   same call; one form is kept for both); in earlier calls that form with
//   the X / v half first ran 1.07 / 1.23 ms, with the other io type's
//   (blocks, batch) choice 1.05 / 1.02, with X / v batches of 4 or 8
//   positions 0.98 (headline).  This design at two blocks an SM and
//   batches of 4 for 2-byte io (128 registers, no spill) ran the headline
//   mode in 0.7684 (H100 80GB HBM3, 700 W, ab_kernels.py).
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   `tv_row` packs rk into the first shared row buffer, the two-stage DFT
//   of lpt_dft.cuh transforms it, then v' is packed into the same buffer
//   and transformed; one block of 256 threads a row, K3's 69.6 KB of
//   shared memory at 12 MP.  1.862 / 1.195 ms at 12 MP, f32 / headline
//   (H100 80GB HBM3, 700 W).
//
// The 2 io x 3 TV x 3 v type combinations times eight kernels (the split
// design's fast and general forms, the radix design's seven lengths) are
// built as three libraries, one a TV carry type (e1_rcarry.cu: f32,
// e1_rcarry_tv_bf16.cu, e1_rcarry_tv_i16.cu), compiled in parallel; each
// exports `lpt_e1_rcarry` for its TV carry type alone.
#pragma once
#include <type_traits>

#include "admm_state.cuh"

namespace lpt {
namespace k8 {

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

// Blocks an SM the radix kernel is compiled for at M = 4096 (its
// __launch_bounds__; 256 threads a block) and the positions of a batch of
// tv_pass0's loads, by the io type: K3's choices, f32 two blocks of
// batches of 4 (128 registers, no spill), 2-byte three blocks of batches
// of 2 (80 registers, 80-96 B of spill stores); xv_pass0's batches hold
// kXvBatch positions for either io type.
template <typename TI>
__host__ __device__ constexpr int min_blocks() { return sizeof(TI) == 2 ? 3 : 2; }
template <typename TI>
__host__ __device__ constexpr int tv_batch() { return sizeof(TI) == 2 ? 2 : 4; }
constexpr int kXvBatch = 4;

template <typename TI, typename TC, typename TV, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? min_blocks<TI>() : 1)
    e1_rcarry_radix_kernel(const TI* __restrict__ img, const TI* __restrict__ fwd,
                           const TV* __restrict__ v, const TC* __restrict__ b,
                           const TC* __restrict__ a0, const TC* __restrict__ a1,
                           const TI* __restrict__ mask, const TI* __restrict__ dp,
                           TI* __restrict__ rkr, TI* __restrict__ rki, TI* __restrict__ vwr,
                           TI* __restrict__ vwi, TV* __restrict__ vo, TC* __restrict__ a0o,
                           TC* __restrict__ a1o, TC* __restrict__ bo,
                           const float2* __restrict__ tab, int ph, int pc, int n1, int n2,
                           float mu1, float mu2, float mu3, float tau, float c_out,
                           float c_diff, Fix fa, Fix fb, Fix fv) {
  extern __shared__ float2 sm[];
  const fft::RTable<M> tb(tab, n1, n2);
  const int r = blockIdx.x;
  const bool xv = blockIdx.y;  // the half: the TV step and rk, or the X / v update and v'
  const size_t hr = (size_t)r * M;
  float2 x[fft::RADIX];
  if (xv) {
    xv_pass0<TI, TV, M, kXvBatch>(fwd, v, mask, dp, vo, 2 * hr, const_row(r, ph, pc, 2 * M),
                                  mu1, c_out, c_diff, fv, x);
  } else {
    float amax = 0.f, bmax = 0.f;  // unused: no saturation channel
    tv_pass0<TI, TC, M, false, false, tv_batch<TI>()>(img, a0, a1, b, a0o, a1o, bo,
                                                      plane_rows(r, ph, 2 * M), mu2, mu3, tau,
                                                      fa, fb, x, amax, bmax);
  }
  fft::rfft_core<TI, M>(x, (xv ? vwr : rkr) + hr, (xv ? vwi : rki) + hr, tb.e, tb.tw, n1, n2, sm);
}

template <typename TI, typename TC, typename TV, int M>
static int run_radix(const void* const* in, void* const* out, const float2* tab, int rows,
                     int ph, int pc, int n1, int n2, float mu1, float mu2, float mu3, float tau,
                     float c_out, float c_diff, Fix fa, Fix fb, Fix fv, void* stream) {
  return launch(e1_rcarry_radix_kernel<TI, TC, TV, M>, dim3(rows, 2),
                dim3(fft::Plan<M>::THREADS), fft::smem_bytes(M, n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TV*)in[2], (const TC*)in[3],
                (const TC*)in[4], (const TC*)in[5], (const TI*)in[6], (const TI*)in[7],
                (TI*)out[0], (TI*)out[1], (TI*)out[2], (TI*)out[3], (TV*)out[4], (TC*)out[5],
                (TC*)out[6], (TC*)out[7], tab, ph, pc, n1, n2, mu1, mu2, mu3, tau, c_out,
                c_diff, fa, fb, fv);
}

// The design by m alone (see the header note).
template <typename TI, typename TC, typename TV>
static int dispatch(const void* const* in, void* const* out, const float2* tab, int rows,
                    int ph, int pc, int m, int n1, int n2, float mu1, float mu2, float mu3,
                    float tau, float c_out, float c_diff, Fix fa, Fix fb, Fix fv,
                    void* stream) {
#define LPT_E8R(M)                                                                         \
  return run_radix<TI, TC, TV, M>(in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3, tau, \
                                  c_out, c_diff, fa, fb, fv, stream)
  switch (m) {
    case 64: LPT_E8R(64);
    case 128: LPT_E8R(128);
    case 256: LPT_E8R(256);
    case 512: LPT_E8R(512);
    case 1024: LPT_E8R(1024);
    case 2048: LPT_E8R(2048);
    case 4096: LPT_E8R(4096);
    default:
      return run<TI, TC, TV>(in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2, mu3, tau, c_out,
                             c_diff, fa, fb, fv, stream);
  }
#undef LPT_E8R
}

// The C entry of one TV carry type TC: every (io, v carry) pair.  rows:
// P * ph, the rows of all planes; ph: the rows of one plane; pc: the
// planes of the mask.  io: storage code of img, fwd, mask, dp and the
// spectra (F32 or BF16); tv: that of a0, a1, b and their updates (TC's
// code, else cudaErrorInvalidValue); vt: that of v and v' (F32, BF16 or
// I16).  lda/sta, ldb/stb, ld_v/st_v: the int16 factors of the a, b and v
// carries.  tab: the split table, followed in the radix design by the
// radix twiddles and the natural-order unpack factors (fft::RTable).
template <typename TC>
static int entry(const void* const* in, void* const* out, const float2* tab, int rows, int ph,
                 int pc, int m, int n1, int n2, float mu1, float mu2, float mu3, float tau,
                 float c_out, float c_diff, Fix fa, Fix fb, Fix fv, int io, int tv, int vt,
                 void* stream) {
  using bf = __nv_bfloat16;
  constexpr int kTv = std::is_same<TC, float>::value ? F32 : std::is_same<TC, bf>::value ? BF16
                                                                                          : I16;
  if (tv != kTv) return (int)cudaErrorInvalidValue;
#define LPT_E8(TI, TV)                                                                  \
  return dispatch<TI, TC, TV>(in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2, mu3, tau, \
                              c_out, c_diff, fa, fb, fv, stream)
  switch (io * 3 + vt) {
    case F32 * 3 + F32: LPT_E8(float, float);
    case F32 * 3 + BF16: LPT_E8(float, bf);
    case F32 * 3 + I16: LPT_E8(float, int16_t);
    case BF16 * 3 + F32: LPT_E8(bf, float);
    case BF16 * 3 + BF16: LPT_E8(bf, bf);
    case BF16 * 3 + I16: LPT_E8(bf, int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LPT_E8
}

}  // namespace k8
}  // namespace lpt

// The exported entry of a library built for the TV carry type TC.
#define LPT_E1_RCARRY_ENTRY(TC)                                                                 \
  extern "C" int lpt_e1_rcarry(                                                                 \
      const void* img, const void* fwd, const void* v, const void* b, const void* a0,           \
      const void* a1, const void* mask, const void* dp, void* rkr, void* rki, void* vwr,        \
      void* vwi, void* vo, void* a0o, void* a1o, void* bo, const float2* tab, int rows, int ph, \
      int pc, int m, int n1, int n2, float mu1, float mu2, float mu3, float tau, float c_out,   \
      float c_diff, float lda, float sta, float ldb, float stb, float ld_v, float st_v, int io, \
      int tv, int vt, void* stream) {                                                           \
    const void* in[8] = {img, fwd, v, b, a0, a1, mask, dp};                                     \
    void* out[8] = {rkr, rki, vwr, vwi, vo, a0o, a1o, bo};                                      \
    return lpt::k8::entry<TC>(in, out, tab, rows, ph, pc, m, n1, n2, mu1, mu2, mu3, tau, c_out, \
                              c_diff, lpt::Fix{lda, sta}, lpt::Fix{ldb, stb},                   \
                              lpt::Fix{ld_v, st_v}, io, tv, vt, stream);                        \
  }
