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
// full-plane and 2 half-plane writes, each once).  Two designs, chosen by
// M = N/2 alone in `lpt_w_dual_state` with K1's rule
// (kernels.irfft_w_dual_state_design = rfft_w_design; neither falls back
// on the other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): one block of
//   M/16 threads per row on the radix FFT of lpt_fft.cuh.  `irfft_row` of
//   a0 (z0 = p0) is stored as image; `irfft_row` of a1 (z0 = p1) leaves
//   fwd in the registers at j = t + T r, where v, mask and dp are loaded
//   (coalesced across t, even and odd planes), v' computed and stored;
//   v' stays in the registers as the pass-0 input of K1's forward core
//   (`rfft_core`), which writes vwr, vwi.  fwd and v' never pass through
//   shared memory; one padded buffer of fft::smem_bytes (34.8 KB at M =
//   4096) serves all three transforms.  At M = 4096 ptxas gets 128
//   registers (two blocks an SM) and spills 8 bytes: K1's cap of 64 (four
//   blocks) spilled 448-680 bytes a thread and ran 2.4x (headline) / 1.4x
//   (f32) slower, a cap of 80 (three blocks) 352-360 bytes and 1.8x / 1.2x
//   (H100 80GB HBM3, 700 W, one source against the other).
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   the two-stage DFT of lpt_dft.cuh.  One block of 256 threads per row
//   holds the row's spectra, fwd and v' in two shared buffers (69.6 KB at
//   12 MP, three blocks per SM; the three W cores of a row do 108 complex
//   multiply-adds per point there): fwd is turned into v' in place and fed
//   straight to the forward core.  1.766 / 1.464 ms at 12 MP, f32 /
//   headline (H100 80GB HBM3, 700 W).
#include <type_traits>

#include "admm_state.cuh"
#include "lpt_fft.cuh"

using namespace lpt;

template <typename TI, typename TV, bool kGen>
__global__ void __launch_bounds__(256, 3) w_dual_state_kernel(
    const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
    const TI* __restrict__ a1i, const float* __restrict__ p0r, const float* __restrict__ p0i,
    const float* __restrict__ p1r, const float* __restrict__ p1i, const TV* __restrict__ v,
    const TI* __restrict__ mask, const TI* __restrict__ dp, TI* __restrict__ img,
    TV* __restrict__ vo, TI* __restrict__ vwr, TI* __restrict__ vwi,
    const float2* __restrict__ tab, int ph, int pc, int m, int n1, int n2, float mu1, float c_out,
    float c_diff, Fix fv, float iv, float* __restrict__ sat) {
  constexpr int V = kGen ? 1 : vec_len<TI, TV>();
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
  const float2* X =
      w_inv_core<TI, V, kGen>(a0r + hr, a0i + hr, make_float2(p0r[r], p0i[r]), A, B, p, R);
  store_row<TI, V>(X, img + fr, m);
  __syncthreads();
  float2* F = w_inv_core<TI, V, kGen>(a1r + hr, a1i + hr, make_float2(p1r[r], p1i[r]), A, B, p, R);
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
  w_fwd_core<TI, V, kGen>(F, F == A ? B : A, p, R, vwr + hr, vwi + hr);
}

template <typename TI, typename TV>
static int run(const void* const* in, const float* const* cols, void* const* out,
               const float2* tab, int rows, int ph, int pc, int m, int n1, int n2, float mu1,
               float c_out, float c_diff, Fix fv, float iv, float* sat, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<TI, TV>()) ? w_dual_state_kernel<TI, TV, true>
                                                           : w_dual_state_kernel<TI, TV, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)in[0], (const TI*)in[1], (const TI*)in[2], (const TI*)in[3], cols[0],
                cols[1], cols[2], cols[3], (const TV*)in[4], (const TI*)in[5], (const TI*)in[6],
                (TI*)out[0], (TV*)out[1], (TI*)out[2], (TI*)out[3], tab, ph, pc, m, n1, n2, mu1,
                c_out, c_diff, fv, iv, sat);
}

template <typename TI, typename TV, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? 2 : 1)
    w_dual_state_radix_kernel(
        const TI* __restrict__ a0r, const TI* __restrict__ a0i, const TI* __restrict__ a1r,
        const TI* __restrict__ a1i, const float* __restrict__ p0r, const float* __restrict__ p0i,
        const float* __restrict__ p1r, const float* __restrict__ p1i, const TV* __restrict__ v,
        const TI* __restrict__ mask, const TI* __restrict__ dp, TI* __restrict__ img,
        TV* __restrict__ vo, TI* __restrict__ vwr, TI* __restrict__ vwi,
        const float2* __restrict__ tab, int ph, int pc, int n1, int n2, float mu1, float c_out,
        float c_diff, Fix fv, float iv, float* __restrict__ sat) {
  constexpr int NT = fft::Plan<M>::THREADS;
  constexpr bool kSat = std::is_same<TV, int16_t>::value;
  extern __shared__ float2 sm[];
  const fft::RTable<M> tb(tab, n1, n2);
  const int r = blockIdx.x, t = threadIdx.x;
  const size_t hr = (size_t)r * M, fr = 2 * hr, mr = const_row(r, ph, pc, 2 * M);
  float2 x[fft::RADIX];
  fft::irfft_row<TI, M>(a0r + hr, a0i + hr, make_float2(p0r[r], p0i[r]), tb.en, tb.tw, n1, n2,
                        sm, x);
  fft::store_split_row<TI, M>(x, img + fr);
  __syncthreads();  // the image's exchange reads are done
  fft::irfft_row<TI, M>(a1r + hr, a1i + hr, make_float2(p1r[r], p1i[r]), tb.en, tb.tw, n1, n2,
                        sm, x);
  float vmax = 0.f;
#pragma unroll
  for (int k = 0; k < fft::RADIX; ++k) {
    const size_t j = t + NT * k;
    const float ne = xv_update(x[k].x, ld1(v + fr + j, fv), ld1(mask + mr + j, Fix{}),
                               ld1(dp + fr + j, Fix{}), mu1, c_out, c_diff);
    const float no = xv_update(x[k].y, ld1(v + fr + M + j, fv), ld1(mask + mr + M + j, Fix{}),
                               ld1(dp + fr + M + j, Fix{}), mu1, c_out, c_diff);
    st1(vo + fr + j, ne, fv);
    st1(vo + fr + M + j, no, fv);
    if constexpr (kSat) vmax = fmaxf(vmax, fmaxf(fabsf(ne), fabsf(no)));
    x[k] = make_float2(ne, no);
  }
  if constexpr (kSat) {
    // a tree over the block (block_max_to's warp shuffles need whole warps;
    // M < 512 has fewer than 32 threads)
    if (sat) {
      const float m = block_max2<NT>(vmax * iv, 0.f).x;
      if (t == 0) atomicMax(reinterpret_cast<int*>(sat), __float_as_int(m));
    }
  }
  __syncthreads();  // fwd's exchange reads are done: the buffer is free
  fft::rfft_core<TI, M>(x, vwr + hr, vwi + hr, tb.e, tb.tw, n1, n2, sm);
}

template <typename TI, typename TV, int M>
static int run_radix(const void* const* in, const float* const* cols, void* const* out,
                     const float2* tab, int rows, int ph, int pc, int n1, int n2, float mu1,
                     float c_out, float c_diff, Fix fv, float iv, float* sat, void* stream) {
  return launch(w_dual_state_radix_kernel<TI, TV, M>, dim3(rows), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const TI*)in[0], (const TI*)in[1],
                (const TI*)in[2], (const TI*)in[3], cols[0], cols[1], cols[2], cols[3],
                (const TV*)in[4], (const TI*)in[5], (const TI*)in[6], (TI*)out[0], (TV*)out[1],
                (TI*)out[2], (TI*)out[3], tab, ph, pc, n1, n2, mu1, c_out, c_diff, fv, iv, sat);
}

// The design by m alone (see the header note).
template <typename TI, typename TV>
static int dispatch(const void* const* in, const float* const* cols, void* const* out,
                    const float2* tab, int rows, int ph, int pc, int m, int n1, int n2,
                    float mu1, float c_out, float c_diff, Fix fv, float iv, float* sat,
                    void* stream) {
#define LPT_W6R(M)                                                                         \
  return run_radix<TI, TV, M>(in, cols, out, tab, rows, ph, pc, n1, n2, mu1, c_out, c_diff, \
                              fv, iv, sat, stream)
  switch (m) {
    case 64: LPT_W6R(64);
    case 128: LPT_W6R(128);
    case 256: LPT_W6R(256);
    case 512: LPT_W6R(512);
    case 1024: LPT_W6R(1024);
    case 2048: LPT_W6R(2048);
    case 4096: LPT_W6R(4096);
    default:
      return run<TI, TV>(in, cols, out, tab, rows, ph, pc, m, n1, n2, mu1, c_out, c_diff, fv, iv,
                         sat, stream);
  }
#undef LPT_W6R
}

// rows: P * ph, the rows of all planes; ph: the rows of one plane; pc:
// the planes of the mask.  io: storage code of the spectra, image, mask
// and dp (F32 or BF16); vt: that of v and v' (F32, BF16 or I16).
// ld_v/st_v: the int16 factors of v; iv: its inverse full scale; sat: a
// zeroed f32 scalar or null.  tab: the split table, followed in the radix
// design by the radix twiddles and the natural-order unpack factors
// (fft::RTable).
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
#define LPT_W6(TI, TV)                                                                     \
  return dispatch<TI, TV>(in, cols, out, tab, rows, ph, pc, m, n1, n2, mu1, c_out, c_diff, fv, iv, \
                          sat, stream)
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
