// K15, K16, K17, K18: H-axis stage 2 (the n2 x n2 contraction over j2, or
// over k2 for the inverse) of the pass-level split backend.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py
//   K15 `h_passB` (kernel `_h_passB_kernel`): stage 2 of one complex plane,
//       forward or inverse (unscaled: the 1/n of the inverse lives in
//       stage 1, K14), with an optional filter multiply of the spectrum
//       before the contraction;
//   K16 `h_passB_combine` (kernel `_h_passB_combine_kernel`): forward stage
//       2 of y, b = F2 y, fused with F = R (a + conj(H) b), a read from
//       device memory;
//   K17 `h_passB_dual` (kernel `_h_passB_dual_kernel`): the inverse stage 2
//       of y and of H y from one read of y;
//   K18 `fft_h_combine2` (kernel `_h_passB_combine2_kernel`): K16 with its
//       spectrum a computed in the block, a = F2 x of the rk stage-1 plane
//       x, instead of read: the rk spectrum never reaches device memory.
// Planes are viewed (n1, n2, W) with h = k1 + n1 k2 in split order; all
// planes, the filter planes included, are stored in the io type T (f32 or
// bf16) and every product and contraction runs in f32 (FFMA).
//
// Bound on the H100: bytes (K15 16 bytes per point at f32, 24 with the
// filter; K16 and K18 36; K17 32; half at bf16; a length-128 DFT runs as an 8 x 16
// split stage, 24 complex multiply-adds per point).  The contraction runs
// down the strided H columns, so a block takes one k1 and 32 consecutive
// lanes of W, as K5 does: loads and stores are runs of 32 contiguous
// elements and the n2 x 32 tile stays in shared memory for the DFT (two
// tiles, 66 KB at 12 MP, three blocks per SM; K17 and K18 three tiles,
// 99 KB, two blocks).  The planes may be a stack of P (grid.y = P); the constant
// planes (filter, H, R) a stack of Pc, P % Pc == 0, plane p reading
// constant plane p % Pc.
#include "lpt_dft.cuh"

using namespace lpt;

constexpr int TW = 32;
constexpr int THREADS = 256;

// The block's n2 x TW tile of a plane and of its constant plane: element i
// of the tile (row i / TW, lane i % TW) lies at base + row * w + lane.
// A block's tile: n2 rows of TW lanes from lane w0; `lanes` = w - w0 of
// them lie inside the plane (the general form's last tile has fewer than
// TW, and its lanes past w are neither loaded nor stored).
struct Tile {
  int w, size, lanes;
  size_t base, cbase;
};

template <bool kGen>
__device__ inline Tile make_tile(int n1, int n2, int w, int pc) {
  const int wtiles = tiles<kGen>(w, TW);
  const int k1 = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const size_t plane = (size_t)n1 * n2 * w;
  const size_t tile0 = (size_t)k1 * n2 * w + w0;
  return Tile{w, n2 * TW, w - w0, blockIdx.y * plane + tile0, (blockIdx.y % pc) * plane + tile0};
}

__device__ __forceinline__ size_t tile_off(const Tile& t, int i) {
  return (size_t)(i / TW) * t.w + (i % TW);
}

// Whether element i of the tile lies inside the plane (always, but in the
// general form).
template <bool kGen>
__device__ __forceinline__ bool in_plane(const Tile& t, int i) {
  return !kGen || i % TW < t.lanes;
}

// S <- y (mr null), S <- m y (mr set, SM null), or S <- y and SM <- m y
// (both set), with the complex constant m = mr + i mi read at the tile's
// constant plane; the product in f32 in the JAX kernel's order.
template <typename T, bool kGen>
__device__ void load_tile(const Tile& t, const T* __restrict__ yr, const T* __restrict__ yi,
                          const T* __restrict__ mr, const T* __restrict__ mi, float2* S,
                          float2* SM) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    const size_t off = tile_off(t, i0);
    float re[V] = {}, im[V] = {}, hr[V] = {}, hi[V] = {};
    const bool in = in_plane<kGen>(t, i0);
    if (in) {
      ldv<V>(yr + t.base + off, re);
      ldv<V>(yi + t.base + off, im);
    }
    rot(re, s);
    rot(im, s);
    if (mr && in) {
      ldv<V>(mr + t.cbase + off, hr);
      ldv<V>(mi + t.cbase + off, hi);
      rot(hr, s);
      rot(hi, s);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      const float2 y = make_float2(re[k], im[k]);
      const float2 z = make_float2(re[k] * hr[k] - im[k] * hi[k], re[k] * hi[k] + im[k] * hr[k]);
      if (!mr) {
        S[i] = y;
      } else if (SM) {
        S[i] = y;
        SM[i] = z;
      } else {
        S[i] = z;
      }
    }
  }
}

// The tile G (shared, f32) stored to (outr, outi) as T.
template <typename T, bool kGen>
__device__ void store_tile(const Tile& t, const float2* G, T* __restrict__ outr,
                           T* __restrict__ outi) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t g = t.base + tile_off(t, i0);
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
}

// Shared memory of a kernel holding `tiles` tiles and n2 roots.
__host__ inline size_t smem_bytes(int tiles, int n2) {
  return sizeof(float2) * (tiles * ((size_t)n2 * TW + dft_slack(n2)) + n2);
}

// K15: stage 2 of (yr, yi), forward or inverse, the spectrum multiplied by
// the filter (fr, fi; null: none) first.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ fr,
    const T* __restrict__ fi, T* __restrict__ outr, T* __restrict__ outi,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w, int inverse) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* R = S2 + cap;
  const float2* roots = inverse ? p.r2i : p.r2f;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = roots[i];
  load_tile<T, kGen>(t, yr, yi, fr, fi, S1, nullptr);
  __syncthreads();
  const float2* z = dft<kGen>(S1, S2, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, z, outr, outi);
}

// K16: b = forward stage 2 of (yr, yi); F = R (a + conj(H) b).
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_combine_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ ar,
    const T* __restrict__ ai, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* R = S2 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2f[i];
  load_tile<T, kGen>(t, yr, yi, nullptr, nullptr, S1, nullptr);
  __syncthreads();
  const float2* b = dft<kGen>(S1, S2, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t off = tile_off(t, i0);
    float a_r[V], a_i[V], h_r[V], h_i[V], rv[V], o_r[V], o_i[V];
    ldv<V>(ar + t.base + off, a_r);
    ldv<V>(ai + t.base + off, a_i);
    ldv<V>(hr + t.cbase + off, h_r);
    ldv<V>(hi + t.cbase + off, h_i);
    ldv<V>(rr + t.cbase + off, rv);
    rot(a_r, s);
    rot(a_i, s);
    rot(h_r, s);
    rot(h_i, s);
    rot(rv, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 B = b[i0 + ((k + s) & (V - 1))];
      o_r[k] = rv[k] * (a_r[k] + h_r[k] * B.x + h_i[k] * B.y);
      o_i[k] = rv[k] * (a_i[k] + h_r[k] * B.y - h_i[k] * B.x);
    }
    unrot(o_r, s);
    unrot(o_i, s);
    stv<V>(fr_out + t.base + off, o_r);
    stv<V>(fi_out + t.base + off, o_i);
  }
}

// K17: a0 = inverse stage 2 of y, a1 = inverse stage 2 of H y.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_dual_kernel(
    const T* __restrict__ yr, const T* __restrict__ yi, const T* __restrict__ hr,
    const T* __restrict__ hi, T* __restrict__ a0r, T* __restrict__ a0i, T* __restrict__ a1r,
    T* __restrict__ a1i, const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2i[i];
  load_tile<T, kGen>(t, yr, yi, hr, hi, S1, S2);
  __syncthreads();
  // each stage leaves its result in its source (split) or its spare (direct)
  const float2* g0 = dft<kGen>(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, g0, a0r, a0i);
  // H y, through the tile that holds neither H y nor the first result
  const float2* g1 = dft<kGen>(S2, g0 == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  store_tile<T, kGen>(t, g1, a1r, a1i);
}

// K18: a = forward stage 2 of (xr, xi), b = forward stage 2 of (yr, yi);
// F = R (a + conj(H) b).  Both contractions read F2 from the same roots.
template <typename T, bool kGen>
__global__ void __launch_bounds__(THREADS) h_pass_b_combine2_kernel(
    const T* __restrict__ xr, const T* __restrict__ xi, const T* __restrict__ yr,
    const T* __restrict__ yi, const T* __restrict__ hr, const T* __restrict__ hi,
    const T* __restrict__ rr, T* __restrict__ fr_out, T* __restrict__ fi_out,
    const float2* __restrict__ tab, int pc, int n1, int n2, int w) {
  constexpr int V = kGen ? 1 : vec_len<T>();
  extern __shared__ float2 sm[];
  const Plan p = make_plan(tab, n1, n2);
  const Tile t = make_tile<kGen>(n1, n2, w, pc);
  const int cap = t.size + dft_slack(n2);
  float2* S1 = sm;
  float2* S2 = S1 + cap;
  float2* S3 = S2 + cap;
  float2* R = S3 + cap;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) R[i] = p.r2f[i];
  load_tile<T, kGen>(t, xr, xi, nullptr, nullptr, S1, nullptr);
  load_tile<T, kGen>(t, yr, yi, nullptr, nullptr, S2, nullptr);
  __syncthreads();
  // each stage leaves its result in its source (split) or its spare (direct)
  const float2* a = dft<kGen>(S1, S3, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  // y, through the tile that holds neither y nor a
  const float2* b = dft<kGen>(S2, a == S1 ? S3 : S1, 1, TW, 1, TW, n2, TW, R, nullptr, 0, 0, 1.f);
  __syncthreads();
  const int s = lane_rot<V, 1>();
#pragma unroll(V == 1 ? 4 : 1)
  for (int i0 = threadIdx.x * V; i0 < t.size; i0 += blockDim.x * V) {
    if (!in_plane<kGen>(t, i0)) continue;
    const size_t off = tile_off(t, i0);
    float h_r[V], h_i[V], rv[V], o_r[V], o_i[V];
    ldv<V>(hr + t.cbase + off, h_r);
    ldv<V>(hi + t.cbase + off, h_i);
    ldv<V>(rr + t.cbase + off, rv);
    rot(h_r, s);
    rot(h_i, s);
    rot(rv, s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + ((k + s) & (V - 1));
      const float2 A = a[i], B = b[i];
      o_r[k] = rv[k] * (A.x + h_r[k] * B.x + h_i[k] * B.y);
      o_i[k] = rv[k] * (A.y + h_r[k] * B.y - h_i[k] * B.x);
    }
    unrot(o_r, s);
    unrot(o_i, s);
    stv<V>(fr_out + t.base + off, o_r);
    stv<V>(fi_out + t.base + off, o_i);
  }
}

static dim3 grid_of(int planes, int n1, int w) { return dim3(n1 * ((w + TW - 1) / TW), planes); }

// Every array is a stack of `planes` planes of (n1, n2, w) but the constant
// ones (filter, H, R), stacks of pc.  io: storage code of all arrays (F32
// or BF16).

// K15.  fr, fi null: no filter.
extern "C" int lpt_h_pass_b(const void* yr, const void* yi, const void* fr, const void* fi,
                            void* outr, void* outi, const float2* tab, int planes, int pc, int n1,
                            int n2, int w, int inverse, int io, void* stream) {
  const size_t smem = smem_bytes(2, n2);
  switch (io) {
    case F32:
      return launch(general_tile(n2, w, TW) ? h_pass_b_kernel<float, true>
                                            : h_pass_b_kernel<float, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem, stream,
                    (const float*)yr, (const float*)yi, (const float*)fr, (const float*)fi,
                    (float*)outr, (float*)outi, tab, pc, n1, n2, w, inverse);
    case BF16: {
      using B = __nv_bfloat16;
      return launch(general_tile(n2, w, TW) ? h_pass_b_kernel<B, true>
                                            : h_pass_b_kernel<B, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem, stream,
                    (const B*)yr, (const B*)yi, (const B*)fr, (const B*)fi, (B*)outr, (B*)outi,
                    tab, pc, n1, n2, w, inverse);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// K16.
extern "C" int lpt_h_pass_b_combine(const void* yr, const void* yi, const void* ar,
                                    const void* ai, const void* hr, const void* hi,
                                    const void* rr, void* fr, void* fi, const float2* tab,
                                    int planes, int pc, int n1, int n2, int w, int io,
                                    void* stream) {
  const size_t smem = smem_bytes(2, n2);
  switch (io) {
    case F32:
      return launch(general_tile(n2, w, TW) ? h_pass_b_combine_kernel<float, true>
                                            : h_pass_b_combine_kernel<float, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem,
                    stream, (const float*)yr, (const float*)yi, (const float*)ar,
                    (const float*)ai, (const float*)hr, (const float*)hi, (const float*)rr,
                    (float*)fr, (float*)fi, tab, pc, n1, n2, w);
    case BF16: {
      using B = __nv_bfloat16;
      return launch(general_tile(n2, w, TW) ? h_pass_b_combine_kernel<B, true>
                                            : h_pass_b_combine_kernel<B, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem,
                    stream, (const B*)yr, (const B*)yi, (const B*)ar, (const B*)ai, (const B*)hr,
                    (const B*)hi, (const B*)rr, (B*)fr, (B*)fi, tab, pc, n1, n2, w);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// K17.
extern "C" int lpt_h_pass_b_dual(const void* yr, const void* yi, const void* hr, const void* hi,
                                 void* a0r, void* a0i, void* a1r, void* a1i, const float2* tab,
                                 int planes, int pc, int n1, int n2, int w, int io,
                                 void* stream) {
  const size_t smem = smem_bytes(3, n2);
  switch (io) {
    case F32:
      return launch(general_tile(n2, w, TW) ? h_pass_b_dual_kernel<float, true>
                                            : h_pass_b_dual_kernel<float, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem,
                    stream, (const float*)yr, (const float*)yi, (const float*)hr,
                    (const float*)hi, (float*)a0r, (float*)a0i, (float*)a1r, (float*)a1i, tab,
                    pc, n1, n2, w);
    case BF16: {
      using B = __nv_bfloat16;
      return launch(general_tile(n2, w, TW) ? h_pass_b_dual_kernel<B, true>
                                            : h_pass_b_dual_kernel<B, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem,
                    stream, (const B*)yr, (const B*)yi, (const B*)hr, (const B*)hi, (B*)a0r,
                    (B*)a0i, (B*)a1r, (B*)a1i, tab, pc, n1, n2, w);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// K18.
extern "C" int lpt_h_pass_b_combine2(const void* xr, const void* xi, const void* yr,
                                     const void* yi, const void* hr, const void* hi,
                                     const void* rr, void* fr, void* fi, const float2* tab,
                                     int planes, int pc, int n1, int n2, int w, int io,
                                     void* stream) {
  const size_t smem = smem_bytes(3, n2);
  switch (io) {
    case F32:
      return launch(general_tile(n2, w, TW) ? h_pass_b_combine2_kernel<float, true>
                                            : h_pass_b_combine2_kernel<float, false>,
                    grid_of(planes, n1, w), dim3(THREADS),
                    smem, stream, (const float*)xr, (const float*)xi, (const float*)yr,
                    (const float*)yi, (const float*)hr, (const float*)hi, (const float*)rr,
                    (float*)fr, (float*)fi, tab, pc, n1, n2, w);
    case BF16: {
      using B = __nv_bfloat16;
      return launch(general_tile(n2, w, TW) ? h_pass_b_combine2_kernel<B, true>
                                            : h_pass_b_combine2_kernel<B, false>,
                    grid_of(planes, n1, w), dim3(THREADS), smem,
                    stream, (const B*)xr, (const B*)xi, (const B*)yr, (const B*)yi,
                    (const B*)hr, (const B*)hi, (const B*)rr, (B*)fr, (B*)fi, tab, pc, n1, n2,
                    w);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
