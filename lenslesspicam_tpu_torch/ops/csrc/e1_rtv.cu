// K3: v3 pre-transform step of the fused ADMM iteration.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `e1_rtv` (kernel
// `_e1rtv_kernel`).  Per row r of the padded grid (planes in the even/odd
// split lane layout, periodic in both axes):
//   a0' = mu2 soft(psi0 + eta0/mu2, tau/mu2) - eta0, eta0 = mu2 psi0 - a0,
//         psi0 = img[r-1] - img[r]
//   a1' likewise along W, psi1 = roll(img, +1) - img
//   b'  = mu3 max(rho/mu3 + img, 0) - rho, rho = mu3 img - b
//   rk  = b' + (a0'[r+1] - a0'[r]) + (roll(a1', -1) - a1')
// then the forward packed-real W transform of rk (K1's transform); the
// step itself is `tv_row` (split design, shared with K8) or `tv_pass0`
// (radix design), both in admm_state.cuh.  The halo rows
// (img r-1 and r+1, a0 r+1) are read straight from device memory, so no
// block depends on another; a0' of row r+1 is recomputed here.  The
// planes may be a stack of P planes of ph rows (grid P * ph): the halo
// rows wrap within each plane, and the saturation channel is the max over
// all of them.
//
// Storage: img and the rk spectrum in the io type TI (f32 or bf16); a0,
// a1, b and their updates in the TV carry type TC (f32, bf16 or int16
// fixed point at full scales 8 tau for a0/a1 and 32 mu3 for b, factors
// fa/fb).  With int16 carries the block also reports the saturation
// channel: max(max |a0'|, |a1'|) * ia, max |b'| * ib) over the
// pre-quantization f32 values, ia = 1/(8 tau), ib = 1/(32 mu3), by one
// atomicMax into *sat.  The update uses the unquantized a0', a1', b', as
// the JAX kernel does.
//
// Bound on the H100: bytes (4 planes read, 3 planes and 2 half planes
// written).  The halo rows are read again by the neighbouring rows'
// blocks (mostly from L2), the price of blocks that do not depend on each
// other.  Two designs, chosen by M = N/2 alone in `lpt_e1_rtv` with K1's
// rule (kernels.e1_rtv_design = rfft_w_design; neither falls back on the
// other):
//
// radix (M a power of two from 64 to 4096; the 12 MP grid): one block of
//   M/16 threads per row.  `tv_pass0` (admm_state.cuh) computes the TV
//   step at the thread's pass-0 positions j = t + T r of K1's radix FFT,
//   the W neighbours from device memory and a1' of the next position
//   recomputed, so rk never passes through shared memory and no barrier
//   comes before the transform; v[r] = rk_even[j] + i rk_odd[j] goes
//   straight into `fft::rfft_core` (lpt_fft.cuh), which writes rkr, rki.
//   The saturation channel is one block max (`block_max2`) and one
//   atomicMax, as K6's radix design takes it.
// split (any other M, any factors n1 x n2; `general_form` in lpt_dft.cuh):
//   `tv_row` writes a1' to a shared row, synchronises and writes rk into
//   the first W-core buffer, then the two-stage DFT of lpt_dft.cuh (one
//   block of 256 threads a row, 69.6 KB at 12 MP).  1.148 / 0.715 ms at
//   12 MP, f32 / headline (H100 80GB HBM3, 700 W).
#include <type_traits>

#include "admm_state.cuh"

using namespace lpt;

template <typename TI, typename TC, bool kGen>
__global__ void __launch_bounds__(256, 3) e1_rtv_kernel(
    const TI* __restrict__ img, const TC* __restrict__ a0, const TC* __restrict__ a1,
    const TC* __restrict__ b, TI* __restrict__ rkr, TI* __restrict__ rki, TC* __restrict__ a0o,
    TC* __restrict__ a1o, TC* __restrict__ bo, const float2* __restrict__ tab, int ph, int m,
    int n1, int n2, float mu2, float mu3, float tau, Fix fa, Fix fb, float ia, float ib,
    float* __restrict__ sat) {
  constexpr int V = kGen ? 1 : vec_len<TI, TC>();
  constexpr bool kSat = std::is_same<TC, int16_t>::value;
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  float2* A = sm;
  float2* B = A + w_buf_len(n1, n2);
  float2* R = B + w_buf_len(n1, n2);
  load_roots(R, p);
  const int r = blockIdx.x;
  float amax = 0.f, bmax = 0.f;
  tv_row<TI, TC, V, kSat>(img, a0, a1, b, a0o, a1o, bo, plane_rows(r, ph, 2 * m), m, mu2, mu3,
                          tau, fa, fb, reinterpret_cast<float*>(A), reinterpret_cast<float*>(B),
                          amax, bmax);
  if constexpr (kSat) block_max_to(fmaxf(amax * ia, bmax * ib), sat);
  __syncthreads();
  w_fwd_core<TI, V, kGen>(A, B, p, R, rkr + (size_t)r * m, rki + (size_t)r * m);
}

template <typename TI, typename TC>
static int run(const void* img, const void* a0, const void* a1, const void* b, void* rkr,
               void* rki, void* a0o, void* a1o, void* bo, const float2* tab, int rows, int ph,
               int m, int n1, int n2, float mu2, float mu3, float tau, Fix fa, Fix fb, float ia,
               float ib, float* sat, void* stream) {
  auto kernel = general_form(n1, n2, m, vec_len<TI, TC>()) ? e1_rtv_kernel<TI, TC, true>
                                                           : e1_rtv_kernel<TI, TC, false>;
  return launch(kernel, dim3(rows), dim3(256), w_smem_bytes(n1, n2), stream,
                (const TI*)img, (const TC*)a0, (const TC*)a1, (const TC*)b, (TI*)rkr, (TI*)rki,
                (TC*)a0o, (TC*)a1o, (TC*)bo, tab, ph, m, n1, n2, mu2, mu3, tau, fa, fb, ia,
                ib, sat);
}

// Blocks an SM the radix kernel is compiled for at M = 4096 (its
// __launch_bounds__; 256 threads a block) and the positions of a batch of
// tv_pass0's loads, by the io type: f32 two blocks of batches of 4
// (126-128 registers, no spill), 2-byte three blocks of batches of 2 (80
// registers, 44 B of spills); at 12 MP the f32 choice ran 7 % faster
// than the 2-byte one at f32, the 2-byte choice 5 % faster than the f32
// one in the headline mode; batches of 8 or 16 (one block) and of 4 at
// three blocks (300-556 B of spills) ran 31-62 % slower, one position at
// a time 19-33 % slower (H100 80GB HBM3, 700 W, ab_kernels.py).
template <typename TI>
__host__ __device__ constexpr int k3_min_blocks() { return sizeof(TI) == 2 ? 3 : 2; }
template <typename TI>
__host__ __device__ constexpr int k3_batch() { return sizeof(TI) == 2 ? 2 : 4; }

template <typename TI, typename TC, int M>
__global__ void __launch_bounds__(fft::Plan<M>::THREADS, M == 4096 ? k3_min_blocks<TI>() : 1)
    e1_rtv_radix_kernel(const TI* __restrict__ img, const TC* __restrict__ a0,
                        const TC* __restrict__ a1, const TC* __restrict__ b,
                        TI* __restrict__ rkr, TI* __restrict__ rki, TC* __restrict__ a0o,
                        TC* __restrict__ a1o, TC* __restrict__ bo,
                        const float2* __restrict__ tab, int ph, int n1, int n2, float mu2,
                        float mu3, float tau, Fix fa, Fix fb, float ia, float ib,
                        float* __restrict__ sat) {
  constexpr int NT = fft::Plan<M>::THREADS;
  constexpr bool kSat = std::is_same<TC, int16_t>::value;
  extern __shared__ float2 sm[];
  const fft::RTable<M> tb(tab, n1, n2);
  const int r = blockIdx.x;
  float2 v[fft::RADIX];
  float amax = 0.f, bmax = 0.f;
  tv_pass0<TI, TC, M, kSat, false, k3_batch<TI>()>(img, a0, a1, b, a0o, a1o, bo,
                                                  plane_rows(r, ph, 2 * M), mu2, mu3, tau, fa,
                                                  fb, v, amax, bmax);
  if constexpr (kSat) {
    // a tree over the block (block_max_to's warp shuffles need whole warps;
    // M < 512 has fewer than 32 threads)
    const float m = block_max2<NT>(fmaxf(amax * ia, bmax * ib), 0.f).x;
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(sat), __float_as_int(m));
  }
  fft::rfft_core<TI, M>(v, rkr + (size_t)r * M, rki + (size_t)r * M, tb.e, tb.tw, n1, n2, sm);
}

template <typename TI, typename TC, int M>
static int run_radix(const void* img, const void* a0, const void* a1, const void* b, void* rkr,
                     void* rki, void* a0o, void* a1o, void* bo, const float2* tab, int rows,
                     int ph, int n1, int n2, float mu2, float mu3, float tau, Fix fa, Fix fb,
                     float ia, float ib, float* sat, void* stream) {
  return launch(e1_rtv_radix_kernel<TI, TC, M>, dim3(rows), dim3(fft::Plan<M>::THREADS),
                fft::smem_bytes(M, n1, n2), stream, (const TI*)img, (const TC*)a0,
                (const TC*)a1, (const TC*)b, (TI*)rkr, (TI*)rki, (TC*)a0o, (TC*)a1o, (TC*)bo,
                tab, ph, n1, n2, mu2, mu3, tau, fa, fb, ia, ib, sat);
}

// The design by m alone (see the header note).
template <typename TI, typename TC>
static int dispatch(const void* img, const void* a0, const void* a1, const void* b, void* rkr,
                    void* rki, void* a0o, void* a1o, void* bo, const float2* tab, int rows,
                    int ph, int m, int n1, int n2, float mu2, float mu3, float tau, Fix fa,
                    Fix fb, float ia, float ib, float* sat, void* stream) {
#define LPT_E3R(M)                                                                          \
  return run_radix<TI, TC, M>(img, a0, a1, b, rkr, rki, a0o, a1o, bo, tab, rows, ph, n1, n2, \
                              mu2, mu3, tau, fa, fb, ia, ib, sat, stream)
  switch (m) {
    case 64: LPT_E3R(64);
    case 128: LPT_E3R(128);
    case 256: LPT_E3R(256);
    case 512: LPT_E3R(512);
    case 1024: LPT_E3R(1024);
    case 2048: LPT_E3R(2048);
    case 4096: LPT_E3R(4096);
    default:
      return run<TI, TC>(img, a0, a1, b, rkr, rki, a0o, a1o, bo, tab, rows, ph, m, n1, n2, mu2,
                         mu3, tau, fa, fb, ia, ib, sat, stream);
  }
#undef LPT_E3R
}

// rows: P * ph, the rows of all planes; ph: the rows of one plane.
// io: storage code of img and the rk spectrum (F32 or BF16); tv: that of
// a0, a1, b and their updates (F32, BF16 or I16).  lda/sta, ldb/stb: the
// int16 factors of the a and b carries; ia, ib: their inverse full scales;
// sat: a zeroed f32 scalar (I16 only, else unused).  tab: the split
// table, followed in the radix design by the radix twiddles and the
// natural-order unpack factors (fft::RTable).
extern "C" int lpt_e1_rtv(const void* img, const void* a0, const void* a1, const void* b,
                          void* rkr, void* rki, void* a0o, void* a1o, void* bo,
                          const float2* tab, int rows, int ph, int m, int n1, int n2, float mu2,
                          float mu3, float tau, float lda, float sta, float ldb, float stb,
                          float ia, float ib, float* sat, int io, int tv, void* stream) {
  using bf = __nv_bfloat16;
  const Fix fa{lda, sta}, fb{ldb, stb};
#define LPT_E1(TI, TC)                                                                      \
  return dispatch<TI, TC>(img, a0, a1, b, rkr, rki, a0o, a1o, bo, tab, rows, ph, m, n1, n2, mu2, \
                          mu3, tau, fa, fb, ia, ib, sat, stream)
  switch (io * 3 + tv) {
    case F32 * 3 + F32: LPT_E1(float, float);
    case F32 * 3 + BF16: LPT_E1(float, bf);
    case F32 * 3 + I16: LPT_E1(float, int16_t);
    case BF16 * 3 + F32: LPT_E1(bf, float);
    case BF16 * 3 + BF16: LPT_E1(bf, bf);
    case BF16 * 3 + I16: LPT_E1(bf, int16_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LPT_E1
}
