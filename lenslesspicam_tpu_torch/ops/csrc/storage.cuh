// Storage types of the port's planes, and the loads and stores that move
// them between device memory and the f32 registers all arithmetic runs in.
//
//   float          f32, as is
//   __nv_bfloat16  bf16; a store rounds to nearest even (__float2bfloat16_rn),
//                  as JAX's astype and torch's .to(bfloat16) round
//   int16_t        int16 fixed point of a carry plane: a load is q * ld, a
//                  store rint(clamp(x * st, -32767, 32767)); rintf rounds half
//                  to even like jnp.round.  ld = scale / 32767 and
//                  st = 32767 / scale are computed in float64 on the host and
//                  passed as f32, as JAX's weak-typed constants are.
//
// A loop over a row that touches a 2-byte plane moves V = 8 elements per
// thread per trip: one 16-byte access per 2-byte plane, two per f32 plane.
// A loop over f32 planes only moves one element per trip (V = 1), the
// slice-1 code.  A thread that owns the V consecutive elements c..c+V-1
// visits them in the lane-rotated order e_k = (k + s) mod V,
// s = (lane >> SH) mod V (`lane_rot`), wherever it touches shared memory:
// in natural order the warp's V-strided addresses would stack on a few
// banks.  `rot` reorders a register array into that order, `unrot` back.
// (On an H100 the rotation is worth 10 % of K6 and 27 % of K5 at 12 MP in
// the headline mode: ab_kernels.py against a copy with lane_rot = 0.)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lpt {

// int16 fixed-point factors of one plane (ignored by the float types).
struct Fix {
  float ld, st;
};

// Elements per thread per trip of a loop over planes of these types.
template <typename... Ts>
__host__ __device__ constexpr int vec_len() {
  return ((sizeof(Ts) == 2) || ...) ? 8 : 1;
}

__device__ __forceinline__ float ld1(const float* p, Fix) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, Fix) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld1(const int16_t* p, Fix f) { return (float)*p * f.ld; }

__device__ __forceinline__ uint32_t bits(float x, float, Fix) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(float x, __nv_bfloat16, Fix) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t bits(float x, int16_t, Fix f) {
  return (uint32_t)(uint16_t)(int16_t)rintf(fminf(fmaxf(x * f.st, -32767.f), 32767.f));
}

__device__ __forceinline__ void st1(float* p, float x, Fix) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x, Fix) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void st1(int16_t* p, float x, Fix f) {
  *p = (int16_t)rintf(fminf(fmaxf(x * f.st, -32767.f), 32767.f));
}

// The two elements of a 32-bit word, low half first.
__device__ __forceinline__ void unpack2(uint32_t w, float* x, __nv_bfloat16, Fix) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(uint32_t w, float* x, int16_t, Fix f) {
  x[0] = (float)(int16_t)(w & 0xffffu) * f.ld;
  x[1] = (float)((int32_t)w >> 16) * f.ld;
}

// x[0..V) <- p[0..V), widened to f32.  With V > 1, p is 16-byte aligned.
template <int V, typename T>
__device__ __forceinline__ void ldv(const T* __restrict__ p, float (&x)[V], Fix f = {}) {
  if constexpr (V == 1) {
    x[0] = ld1(p, f);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V % 4 == 0, "f32 vectors are whole float4s");
#pragma unroll
    for (int w = 0; w < V / 4; ++w) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p) + w);
      x[4 * w] = u.x;
      x[4 * w + 1] = u.y;
      x[4 * w + 2] = u.z;
      x[4 * w + 3] = u.w;
    }
  } else {
    static_assert(V % 8 == 0, "2-byte vectors are whole 16-byte words");
#pragma unroll
    for (int w = 0; w < V / 8; ++w) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + w);
      unpack2(u.x, x + 8 * w, T{}, f);
      unpack2(u.y, x + 8 * w + 2, T{}, f);
      unpack2(u.z, x + 8 * w + 4, T{}, f);
      unpack2(u.w, x + 8 * w + 6, T{}, f);
    }
  }
}

// p[0..V) <- x[0..V), rounded to T.  With V > 1, p is 16-byte aligned.
template <int V, typename T>
__device__ __forceinline__ void stv(T* __restrict__ p, const float (&x)[V], Fix f = {}) {
  if constexpr (V == 1) {
    st1(p, x[0], f);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V % 4 == 0, "f32 vectors are whole float4s");
#pragma unroll
    for (int w = 0; w < V / 4; ++w)
      reinterpret_cast<float4*>(p)[w] =
          make_float4(x[4 * w], x[4 * w + 1], x[4 * w + 2], x[4 * w + 3]);
  } else {
    static_assert(V % 8 == 0, "2-byte vectors are whole 16-byte words");
    uint32_t u[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k)
      u[k] = bits(x[2 * k], T{}, f) | (bits(x[2 * k + 1], T{}, f) << 16);
#pragma unroll
    for (int w = 0; w < V / 8; ++w)
      reinterpret_cast<uint4*>(p)[w] = make_uint4(u[4 * w], u[4 * w + 1], u[4 * w + 2], u[4 * w + 3]);
  }
}

// Rotation of the lane that owns a V-element chunk (see the header).
template <int V, int SH>
__device__ __forceinline__ int lane_rot() {
  return V == 1 ? 0 : (int)((threadIdx.x & 31) >> SH) & (V - 1);
}

// x[k] <- x[(k + s) mod V]
template <int V>
__device__ __forceinline__ void rot(float (&x)[V], int s) {
#pragma unroll
  for (int b = 1; b < V; b <<= 1) {
    float t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = (s & b) ? x[(k + b) & (V - 1)] : x[k];
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = t[k];
  }
}

// x[k] <- x[(k - s) mod V]
template <int V>
__device__ __forceinline__ void unrot(float (&x)[V], int s) {
#pragma unroll
  for (int b = 1; b < V; b <<= 1) {
    float t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = (s & b) ? x[(k - b) & (V - 1)] : x[k];
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = t[k];
  }
}

// Max of v over the block, into *out by atomicMax on the int bits: v >= 0,
// and non-negative floats order like their bit patterns.  *out starts at 0.
__device__ __forceinline__ void block_max_to(float v, float* out) {
  __shared__ float red[32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < nw; ++i) v = fmaxf(v, red[i]);
    atomicMax(reinterpret_cast<int*>(out), __float_as_int(v));
  }
}

// Storage type codes of the C entries: 0 f32, 1 bf16, 2 int16.
enum Code { F32 = 0, BF16 = 1, I16 = 2 };

}  // namespace lpt
