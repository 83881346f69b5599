// K5: H-axis stage 2 of both ADMM planes, spectrum combine, and the
// inverse stage 2 of the combined spectrum and its H-filtered copy.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `_h_combine_dual_kernel`
// (the pallas_call inside `fft_h_combine_dual`).  Planes are viewed
// (n1, n2, W).  For each (k1, w):
//   a = F2 xa, b = F2 ya                       (forward stage 2 over j2)
//   F  = R (a + conj(H) b),  F1 = H F          (elementwise, f32)
//   a0 = F2inv F, a1 = F2inv F1                (inverse stage 2 over k2)
// F and F1 never leave the block.  R reaches 1/mu3 = 2.5e4 at the default
// mu; the combine is kept in f32 in the JAX kernel's order.  All eleven
// planes, the filter H and R included, are stored in the io type T (f32 or
// bf16), as the JAX solver casts them.
//
// Two designs, chosen by n2 alone (kernels.h_combine_dual_design): the
// radix design for n2 = 128 (the 12 MP grid's H = 48 x 128, 768 = 6 x
// 128), any n1 and W, and the split design for any other n2.  Neither
// falls back on the other.
//
// Bound on the H100: bytes, 44 per point at f32, 22 at bf16.
//
// The radix design (h_combine_radix_kernel): the column form of the radix
// FFT (lpt_fft.cuh), 16 + 8 points a column thread instead of the split
// design's 24 complex multiply-adds a point and transform.  A block takes
// one k1 and RTW = 32 lanes, 8 threads a lane (256).  Each thread loads
// its column positions j2 = t + 8 r of xa and ya straight into registers
// (all 64 loads before the first butterfly, each a warp's 32 consecutive
// lanes of one row), transforms xa then ya (one exchange each through one
// 32 KB buffer [position][lane], conflict-free as a warp is 32 lanes),
// loads H and R at each register's own frequency k2 (again 32 lanes of one
// row) and combines on the registers, in digit order: no exchange before
// the combine.  The inverse of F, then of F1, runs the forward network
// transposed (digit order in, natural order out, one exchange), and each
// register is stored to its own row.  Only the registers of A and B, then
// F and F1, stay live; the buffer is reused behind barriers.
//
// The split design (h_combine_kernel, any n2): the four length-n2 DFTs run
// as a x b split stages (8 x 16 at n2 = 128, 24 complex multiply-adds a
// point each).  A block takes one k1 and 32 consecutive lanes of W: loads
// and stores are runs of 32 contiguous elements; the three n2 x 32 tiles
// (96 KB at 12 MP) stay in shared memory.  The planes may be a stack of P
// (grid.y = P); the filter planes H and R are a stack of Pc, P % Pc == 0,
// and plane p reads filter plane p % Pc.  A single plane runs an
// instantiation without the plane offsets (kStack false): with them the
// gray headline loop's K5 took 3 % more time (945.5 against 914-918 us a
// call in the loop, torch.profiler on an H100, profile_solver.py).  ptxas
// allocates registers by the form of the offset sums: written as below,
// the stacked instantiation gets 100 (bf16) / 108 (f32) registers and the
// single-plane one 80, and a stack runs 2-3 % faster than with the sum
// over a shared tile offset, which gave both 80 (`ab_kernels.py --planes
// 1x1,3x3,4x1` on an H100 at 12 MP, one source form against the other).
#include "lpt_fft.cuh"

using namespace lpt;

constexpr int TW = 32;

template <typename T, bool kStack, bool kGen>
__global__ void __launch_bounds__(256) h_combine_kernel(
    const T* __restrict__ xar, const T* __restrict__ xai, const T* __restrict__ yar,
    const T* __restrict__ yai, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ a0r, T* __restrict__ a0i, T* __restrict__ a1r,
    T* __restrict__ a1i, const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const int tile = n2 * TW, cap = tile + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;  // r2f (n2) | r2i (n2)
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    R[i] = p.r2f[i];
    R[n2 + i] = p.r2i[i];
  }
  const int wtiles = tiles<kGen>(w, TW);
  const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const size_t plane = (size_t)n1 * n2 * w;
  const size_t base = (kStack ? blockIdx.y * plane : 0) + (size_t)k1 * n2 * w + w0;
  const size_t cbase = (kStack ? (blockIdx.y % pc) * plane : 0) + (size_t)k1 * n2 * w + w0;
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < tile; i0 += blockDim.x * V) {
    const size_t g = base + (size_t)(i0 / TW) * w + (i0 % TW);
    float xr[V] = {}, xi[V] = {}, yr[V] = {}, yi[V] = {};
    if (!kGen || w0 + i0 % TW < w) {  // the general form's last tile: lanes past w load 0
      ldv<V>(xar + g, xr);
      ldv<V>(xai + g, xi);
      ldv<V>(yar + g, yr);
      ldv<V>(yai + g, yi);
    }
    rot(xr, s);
    rot(xi, s);
    rot(yr, s);
    rot(yi, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      S1[i] = make_float2(xr[k], xi[k]);
      S2[i] = make_float2(yr[k], yi[k]);
    }
  }
  __syncthreads();
  // each stage leaves its result in one of the three tiles (see `dft`)
  float2* a = dft<kGen>(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  float2* b = dft<kGen>(S2, a == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  float2* t = (a != S1 && b != S1) ? S1 : ((a != S2 && b != S2) ? S2 : S3);
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < tile; i0 += blockDim.x * V) {
    const size_t g = cbase + (size_t)(i0 / TW) * w + (i0 % TW);
    float h_r[V] = {}, h_i[V] = {}, rv[V] = {};
    if (!kGen || w0 + i0 % TW < w) {
      ldv<V>(hr + g, h_r);
      ldv<V>(hi + g, h_i);
      ldv<V>(rr + g, rv);
    }
    rot(h_r, s);
    rot(h_i, s);
    rot(rv, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      const float2 A = a[i], B = b[i];
      const float fr = rv[k] * (A.x + h_r[k] * B.x + h_i[k] * B.y);
      const float fi = rv[k] * (A.y + h_r[k] * B.y - h_i[k] * B.x);
      a[i] = make_float2(fr, fi);                                          // F
      b[i] = make_float2(fr * h_r[k] - fi * h_i[k], fr * h_i[k] + fi * h_r[k]);  // H F
    }
  }
  __syncthreads();
  // inverse F
  const float2* g0 = dft<kGen>(a, t, 1, TW, 1, TW, n2, TW, R + n2, nullptr, 0, 0, 1.f);
  __syncthreads();
  auto store = [&](const float2* G, T* outr, T* outi) {
#pragma unroll(V == 1 ? 4 : 1)
    for (int i0 = threadIdx.x * V; i0 < tile; i0 += blockDim.x * V) {
      const size_t g = base + (size_t)(i0 / TW) * w + (i0 % TW);
      if (kGen && w0 + i0 % TW >= w) continue;
      float re[V], im[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float2 z = G[i0 + ((k + s) & (V - 1))];
        re[k] = z.x;
        im[k] = z.y;
      }
      unrot(re, s);
      unrot(im, s);
      stv<V>(outr + g, re);
      stv<V>(outi + g, im);
    }
  };
  store(g0, a0r, a0i);
  // inverse H F, through the tile that is neither H F nor inverse F
  const float2* g1 =
      dft<kGen>(b, g0 == a ? t : a, 1, TW, 1, TW, n2, TW, R + n2, nullptr, 0, 0, 1.f);
  __syncthreads();
  store(g1, a1r, a1i);
}

// ---------------------------------------------------------------------------
// The radix design: n2 = RN2, any n1 and W (the last lane tile guarded
// where RTW does not divide W).
// ---------------------------------------------------------------------------

constexpr int RN2 = 128;                                     // kernels.H_RADIX_N2
constexpr int RTW = 32;                                      // lanes a block
constexpr int RTHREADS = fft::Plan<RN2>::THREADS * RTW;      // 8 a lane

template <typename T, bool kStack, bool kGen>
__global__ void __launch_bounds__(RTHREADS, 2) h_combine_radix_kernel(
    const T* __restrict__ xar, const T* __restrict__ xai, const T* __restrict__ yar,
    const T* __restrict__ yai, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ a0r, T* __restrict__ a0i, T* __restrict__ a1r,
    T* __restrict__ a1i, const float2* __restrict__ tw, int pc, int n1, int w) {
  using namespace fft;
  using P = fft::Plan<RN2>;
  constexpr int NT = P::THREADS, R = P::radix(P::PASSES - 1);
  extern __shared__ float2 sm[];  // RN2 x RTW, [position][lane]
  const int lane = threadIdx.x % RTW, t = threadIdx.x / RTW;
  const int wtiles = tiles<kGen>(w, RTW);
  const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * RTW;
  const bool live = !kGen || w0 + lane < w;  // the guarded tile: lanes past w load 0, store nothing
  const size_t plane = (size_t)n1 * RN2 * w;
  const size_t col = (size_t)k1 * RN2 * w + w0 + lane;
  const size_t base = (kStack ? blockIdx.y * plane : 0) + col;
  const size_t cbase = (kStack ? (blockIdx.y % pc) * plane : 0) + col;
  float2 a[RADIX], b[RADIX];
#pragma unroll
  for (int r = 0; r < RADIX; ++r) {
    const size_t g = base + (size_t)(t + NT * r) * w;
    a[r] = b[r] = make_float2(0.f, 0.f);
    if (live) {
      a[r] = make_float2(ld1(xar + g, Fix{}), ld1(xai + g, Fix{}));
      b[r] = make_float2(ld1(yar + g, Fix{}), ld1(yai + g, Fix{}));
    }
  }
  col_fft<RN2, RTW>(a, sm, tw, t, lane);
  __syncthreads();  // every read of a's exchange is done: the buffer is free
  col_fft<RN2, RTW>(b, sm, tw, t, lane);
  // F = R (A + conj(H) B), F1 = H F at each register's frequency k2
#pragma unroll
  for (int i = 0; i < RADIX / R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const size_t g = cbase + (size_t)frequency<RN2>(t + NT * i, c) * w;
      float h_r = 0.f, h_i = 0.f, rv = 0.f;
      if (live) {
        h_r = ld1(hr + g, Fix{});
        h_i = ld1(hi + g, Fix{});
        rv = ld1(rr + g, Fix{});
      }
      const float2 A = a[i * R + c], B = b[i * R + c];
      const float fr = rv * (A.x + h_r * B.x + h_i * B.y);
      const float fi = rv * (A.y + h_r * B.y - h_i * B.x);
      a[i * R + c] = make_float2(fr, fi);
      b[i * R + c] = make_float2(fr * h_r - fi * h_i, fr * h_i + fi * h_r);
    }
  auto store = [&](const float2(&v)[RADIX], T* outr, T* outi) {
    if (!live) return;
#pragma unroll
    for (int r = 0; r < RADIX; ++r) {
      const size_t g = base + (size_t)(t + NT * r) * w;
      st1(outr + g, v[r].x, Fix{});
      st1(outi + g, v[r].y, Fix{});
    }
  };
  __syncthreads();  // every read of b's exchange is done
  col_ifft<RN2, RTW>(a, sm, tw, t, lane);
  store(a, a0r, a0i);
  __syncthreads();
  col_ifft<RN2, RTW>(b, sm, tw, t, lane);
  store(b, a1r, a1i);
}

// The radix twiddles follow the split design's table (kernels._design_table).
template <typename T>
static int run_radix(const void* const* in, void* const* out, const float2* tab, int planes,
                     int pc, int n1, int w, void* stream) {
  const float2* tw = make_plan(tab, n1, RN2).e;
  const size_t smem = sizeof(float2) * RN2 * RTW;
  const dim3 grid(n1 * ((w + RTW - 1) / RTW), planes);
  const bool gen = w % RTW;
  auto kernel = planes == 1 ? (gen ? h_combine_radix_kernel<T, false, true>
                                   : h_combine_radix_kernel<T, false, false>)
                            : (gen ? h_combine_radix_kernel<T, true, true>
                                   : h_combine_radix_kernel<T, true, false>);
  return launch(kernel, grid, dim3(RTHREADS), smem, stream, (const T*)in[0], (const T*)in[1],
                (const T*)in[2], (const T*)in[3], (const T*)in[4], (const T*)in[5],
                (const T*)in[6], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], tw, pc, n1, w);
}

template <typename T>
static int run(const void* const* in, void* const* out, const float2* tab, int planes, int pc,
               int n1, int n2, int w, void* stream) {
  if (n2 == RN2) return run_radix<T>(in, out, tab, planes, pc, n1, w, stream);
  const size_t smem = sizeof(float2) * (3 * ((size_t)n2 * TW + dft_slack(n2)) + 2 * n2);
  const dim3 grid(n1 * ((w + TW - 1) / TW), planes);
  const bool gen = general_tile(n2, w, TW);
  auto kernel = planes == 1
                    ? (gen ? h_combine_kernel<T, false, true> : h_combine_kernel<T, false, false>)
                    : (gen ? h_combine_kernel<T, true, true> : h_combine_kernel<T, true, false>);
  return launch(kernel, grid, dim3(256), smem, stream, (const T*)in[0], (const T*)in[1],
                (const T*)in[2], (const T*)in[3], (const T*)in[4], (const T*)in[5],
                (const T*)in[6], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3], tab, pc, n1,
                n2, w);
}

// The four input and four output arrays are stacks of `planes` planes of
// (n1, n2, w), the filter arrays hr, hi, rr stacks of pc.  io: storage
// code of all eleven arrays (F32 or BF16).  n2 = RN2 runs the radix design
// (tab: the split table, then the radix twiddles of RN2), any other n2 the
// split design (tab: the split table).
extern "C" int lpt_h_combine_dual(const void* xar, const void* xai, const void* yar,
                                  const void* yai, const void* hr, const void* hi,
                                  const void* rr, void* a0r, void* a0i, void* a1r, void* a1i,
                                  const float2* tab, int planes, int pc, int n1, int n2, int w,
                                  int io, void* stream) {
  const void* in[7] = {xar, xai, yar, yai, hr, hi, rr};
  void* out[4] = {a0r, a0i, a1r, a1i};
  switch (io) {
    case F32: return run<float>(in, out, tab, planes, pc, n1, n2, w, stream);
    case BF16: return run<__nv_bfloat16>(in, out, tab, planes, pc, n1, n2, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
