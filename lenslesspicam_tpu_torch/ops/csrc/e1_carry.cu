// K10: full-width pre-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `e1_carry` (kernel
// `_e1c_kernel`).  Per row r of the padded grid (planes in natural lane
// order, periodic in both axes):
//   the TV / non-negativity step (`tv_row` in natural lane order,
//   admm_state.cuh): a0', a1', b' and rk = b' + Psi^T a', the H halo rows
//   (image r-1 and r+1, a0 r+1) read straight from device memory, the W
//   difference a roll inside the row
//   xi = mu1 fwd - v, X = xdv (xi + mu1 fwd + dp), v' = mu1 X - xi from the
//   carried forward plane fwd (`xv_update`), xdv rebuilt from the {0,1}
//   support mask
//   the forward W transforms of rk and of the f32 v', split order
//   (K12's transform of two real rows).
// The JAX kernel fetches whole neighbour row blocks for its halo; here the
// halo rows are single rows, periodic within the plane.  Rows may be those
// of a stack of P planes of ph rows; the mask is a stack of Pc planes,
// P % Pc == 0, and plane p reads mask plane p % Pc.
//
// Storage: img, fwd, mask, dp and the four spectra in the io type TI (f32
// or bf16); a0, a1, b and their updates in the TV carry type TC (f32 or
// bf16: the JAX kernel stores them at `_CARRY_DTYPE`, never int16); v, v'
// in the v carry type TV (f32, bf16 or int16 fixed point at full scale
// 256 mu1, factors fv).  12 storage combinations.
//
// Bound on the H100: bytes (8 planes read, 8 written).  rk and v' are
// both real: they are transformed once as z = rk + i s v' (s the
// balancing power of two) and separated through the mirror, which halves
// the transform work of two rows.  Two designs, chosen by W alone in
// `lpt_e1_carry` with K12's rule (kernels.e1_carry_design = fft_w_design;
// neither falls back on the other):
//
// radix (W a power of two from 512 to 8192; the 12 MP grid's 8192): one
//   block of W/16 threads per row.  `tv_pass0` (admm_state.cuh, natural
//   lanes) computes rk at the thread's pass-0 positions j = t + T r of the
//   radix FFT, the W neighbours from device memory and a1' of the next
//   position recomputed; the X / v update runs at the same j and stores
//   v'.  z[r] = rk[j] + i v'[j] stays in registers; the balance is a block
//   max over them (`block_max2`, `pow2_balance`), and the rest of K12's
//   transform (`fft::fft_two_real_core`, lpt_fft.cuh: the passes, the
//   split-layout exchange, the mirror store) writes rkr, rki, vwr, vwi.
//   One padded buffer of fft::smem_bytes (69.6 KB at 8192).
// split (any other W, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   `tv_row` in natural lanes writes rk into the real parts of one padded
//   shared row, the X / v update v' into its imaginary parts; the row is
//   balanced on shared memory (`balance_imag`), transformed by the
//   two-stage DFT of lpt_dft.cuh (40 complex multiply-adds a point at 12
//   MP) and separated (`store_two_spectra`).  134 KB of shared memory at
//   12 MP: one block of 512 threads per SM.  3.043 / 1.641 ms at 12 MP,
//   f32 / bench mode (H100 80GB HBM3, 700 W).
#include "admm_state.cuh"

using namespace lpt;

template <typename TI, typename TC, typename TV, bool kGen>
__global__ void __launch_bounds__(FW_THREADS, 1) e1_carry_kernel(
    const TI* __restrict__ img, const TI* __restrict__ fwd, const TV* __restrict__ v,
    const TC* __restrict__ b, const TC* __restrict__ a0, const TC* __restrict__ a1,
    const TI* __restrict__ mask, const TI* __restrict__ dp, TI* __restrict__ rkr,
    TI* __restrict__ rki, TI* __restrict__ vwr, TI* __restrict__ vwi, TV* __restrict__ vo,
    TC* __restrict__ a0o, TC* __restrict__ a1o, TC* __restrict__ bo,
    const float2* __restrict__ tab, int ph, int pc, int n1, int n2, float mu1, float mu2,
    float mu3, float tau, float c_out, float c_diff, Fix fv) {
  constexpr int V = kGen ? 1 : vec_len<TI, TC, TV>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int r = blockIdx.x, n = p.n;
  const size_t fr = (size_t)r * n, mr = const_row(r, ph, pc, n);
  float* f = reinterpret_cast<float*>(A);
  float amax = 0.f, bmax = 0.f;  // unused: no saturation channel
  tv_row<TI, TC, V, false, true>(img, a0, a1, b, a0o, a1o, bo, plane_rows(r, ph, n), n / 2, mu2,
                                 mu3, tau, Fix{}, Fix{}, f, reinterpret_cast<float*>(B), amax,
                                 bmax);
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
    put_part<V>(f, vn, q0, 1, s);
  }
  __syncthreads();
  const float sc = balance_imag(A, n);
  const float2* P = c_fwd_core<kGen>(A, B, p, R);
  store_two_spectra<TI, V>(P, p, rkr + fr, rki + fr, vwr + fr, vwi + fr, 1.f / sc);
}

template <typename TI, typename TC, typename TV>
static int run(const void* const* in, void* const* out, const float2* tab, int rows, int ph,
               int pc, int n1, int n2, float mu1, float mu2, float mu3, float tau, float c_out,
               float c_diff, Fix fv, void* stream) {
  auto kernel = general_form(n1, n2, n1 * n2, vec_len<TI, TC, TV>())
                    ? e1_carry_kernel<TI, TC, TV, true>
                    : e1_carry_kernel<TI, TC, TV, false>;
  return launch(kernel, dim3(rows), dim3(FW_THREADS), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TV*)in[2], (const TC*)in[3],
                (const TC*)in[4], (const TC*)in[5], (const TI*)in[6], (const TI*)in[7],
                (TI*)out[0], (TI*)out[1], (TI*)out[2], (TI*)out[3], (TV*)out[4], (TC*)out[5],
                (TC*)out[6], (TC*)out[7], tab, ph, pc, n1, n2, mu1, mu2, mu3, tau, c_out, c_diff,
                fv);
}

// Threads an SM the radix kernel is compiled for (its __launch_bounds__:
// K10_THREADS_PER_SM / (W/16) blocks of W/16 threads) and the positions of
// a batch of loads (tv_pass0's, then the X / v update's): one block of
// 512 at W = 8192 with batches of 8 (122-128 registers, no spill).  At 12
// MP two blocks (64 registers) with batches of 2 or 4 spilled 16-168 B
// and ran 8-12 % slower at f32 (batches of 2 1 % faster in the bench
// mode); one block with batches of 16 spilled 200-424 B and ran 45-54 %
// slower, with batches of 4 or 1 1-18 % slower (H100 80GB HBM3, 700 W,
// ab_kernels.py).
constexpr int K10_THREADS_PER_SM = 512;
constexpr int K10_BATCH = 8;

template <typename TI, typename TC, typename TV, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS,
                                  K10_THREADS_PER_SM / fft::Plan<M>::THREADS)
    e1_carry_radix_kernel(const TI* __restrict__ img, const TI* __restrict__ fwd,
                          const TV* __restrict__ v, const TC* __restrict__ b,
                          const TC* __restrict__ a0, const TC* __restrict__ a1,
                          const TI* __restrict__ mask, const TI* __restrict__ dp,
                          TI* __restrict__ rkr, TI* __restrict__ rki, TI* __restrict__ vwr,
                          TI* __restrict__ vwi, TV* __restrict__ vo, TC* __restrict__ a0o,
                          TC* __restrict__ a1o, TC* __restrict__ bo,
                          const float2* __restrict__ tw, int ph, int pc, float mu1, float mu2,
                          float mu3, float tau, float c_out, float c_diff, Fix fv) {
  constexpr int NT = fft::Plan<M>::THREADS;
  extern __shared__ float2 sm[];
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t fr = (size_t)r * M, mr = const_row(r, ph, pc, M);
  float2 z[fft::RADIX];
  float amax = 0.f, bmax = 0.f;  // unused: no saturation channel
  tv_pass0<TI, TC, M, false, true, K10_BATCH>(img, a0, a1, b, a0o, a1o, bo,
                                              plane_rows(r, ph, M), mu2, mu3, tau, Fix{}, Fix{},
                                              z, amax, bmax);
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < fft::RADIX; k0 += K10_BATCH) {
    float u[K10_BATCH][4];
#pragma unroll
    for (int i = 0; i < K10_BATCH; ++i) {
      const size_t j = t + NT * (k0 + i);
      u[i][0] = ld1(fwd + fr + j, Fix{});
      u[i][1] = ld1(v + fr + j, fv);
      u[i][2] = ld1(mask + mr + j, Fix{});
      u[i][3] = ld1(dp + fr + j, Fix{});
    }
#pragma unroll
    for (int i = 0; i < K10_BATCH; ++i) {
      const int k = k0 + i;
      const float vn = xv_update(u[i][0], u[i][1], u[i][2], u[i][3], mu1, c_out, c_diff);
      st1(vo + fr + t + NT * k, vn, fv);
      z[k].y = vn;
      m0 = fmaxf(m0, fabsf(z[k].x));
      m1 = fmaxf(m1, fabsf(vn));
    }
  }
  const float sc = pow2_balance(block_max2<NT>(m0, m1));
#pragma unroll
  for (int k = 0; k < fft::RADIX; ++k) z[k].y *= sc;
  fft::fft_two_real_core<TI, M>(z, sc, rkr + fr, rki + fr, vwr + fr, vwi + fr, tw, sm, true);
}

// The table: the split design's [r1f | r2f | r1i | r2i | Tf | Ti]
// (make_plan, no unpack factors), then the radix twiddles of length W.
template <typename TI, typename TC, typename TV, int M>
static int run_radix(const void* const* in, void* const* out, const float2* tab, int rows,
                     int ph, int pc, int n1, int n2, float mu1, float mu2, float mu3, float tau,
                     float c_out, float c_diff, Fix fv, void* stream) {
  if (n2 != 128 || n1 != M / 128) return (int)cudaErrorInvalidValue;
  return launch(e1_carry_radix_kernel<TI, TC, TV, M>, dim3(rows), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const TI*)in[0], (const TI*)in[1],
                (const TV*)in[2], (const TC*)in[3], (const TC*)in[4], (const TC*)in[5],
                (const TI*)in[6], (const TI*)in[7], (TI*)out[0], (TI*)out[1], (TI*)out[2],
                (TI*)out[3], (TV*)out[4], (TC*)out[5], (TC*)out[6], (TC*)out[7],
                tab + 2 * (n1 + n2) + 2 * M, ph, pc, mu1, mu2, mu3, tau, c_out, c_diff, fv);
}

// The design by W = n1 * n2 alone (see the header note).
template <typename TI, typename TC, typename TV>
static int run_design(const void* const* in, void* const* out, const float2* tab, int rows,
                      int ph, int pc, int n1, int n2, float mu1, float mu2, float mu3, float tau,
                      float c_out, float c_diff, Fix fv, void* stream) {
#define LPT_E10R(M)                                                                       \
  return run_radix<TI, TC, TV, M>(in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3, tau, \
                                  c_out, c_diff, fv, stream)
  switch (n1 * n2) {
    case 512: LPT_E10R(512);
    case 1024: LPT_E10R(1024);
    case 2048: LPT_E10R(2048);
    case 4096: LPT_E10R(4096);
    case 8192: LPT_E10R(8192);
    default:
      return run<TI, TC, TV>(in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3, tau, c_out,
                             c_diff, fv, stream);
  }
#undef LPT_E10R
}

template <typename TI>
static int dispatch(int tv, int vt, const void* const* in, void* const* out, const float2* tab,
                    int rows, int ph, int pc, int n1, int n2, float mu1, float mu2, float mu3,
                    float tau, float c_out, float c_diff, Fix fv, void* stream) {
  using bf = __nv_bfloat16;
#define LPT_E10(TC, TV)                                                                      \
  return run_design<TI, TC, TV>(in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3, tau, c_out, \
                                c_diff, fv, stream)
  switch (tv * 3 + vt) {
    case F32 * 3 + F32: LPT_E10(float, float);
    case F32 * 3 + BF16: LPT_E10(float, bf);
    case F32 * 3 + I16: LPT_E10(float, int16_t);
    case BF16 * 3 + F32: LPT_E10(bf, float);
    case BF16 * 3 + BF16: LPT_E10(bf, bf);
    case BF16 * 3 + I16: LPT_E10(bf, int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LPT_E10
}

// rows: P * ph, the rows of all planes; ph: the rows of one plane; pc:
// the planes of the mask; W = n1 * n2.  io: storage code of img, fwd,
// mask, dp and the spectra (F32 or BF16); tv: that of a0, a1, b and their
// updates (F32 or BF16); vt: that of v and v' (F32, BF16 or I16).
// ld_v/st_v: the int16 factors of v.  tab: the split table, followed in
// the radix design by the radix twiddles.
extern "C" int lpt_e1_carry(const void* img, const void* fwd, const void* v, const void* b,
                            const void* a0, const void* a1, const void* mask, const void* dp,
                            void* rkr, void* rki, void* vwr, void* vwi, void* vo, void* a0o,
                            void* a1o, void* bo, const float2* tab, int rows, int ph, int pc,
                            int n1, int n2, float mu1, float mu2, float mu3, float tau,
                            float c_out, float c_diff, float ld_v, float st_v, int io, int tv,
                            int vt, void* stream) {
  const void* in[8] = {img, fwd, v, b, a0, a1, mask, dp};
  void* out[8] = {rkr, rki, vwr, vwi, vo, a0o, a1o, bo};
  const Fix fv{ld_v, st_v};
  switch (io) {
    case F32:
      return dispatch<float>(tv, vt, in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3, tau,
                             c_out, c_diff, fv, stream);
    case BF16:
      return dispatch<__nv_bfloat16>(tv, vt, in, out, tab, rows, ph, pc, n1, n2, mu1, mu2, mu3,
                                     tau, c_out, c_diff, fv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
