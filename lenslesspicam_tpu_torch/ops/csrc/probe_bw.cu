// P1, P2, P3: the port's bandwidth probe, three streaming passes over a
// (rows, w) plane in row blocks.
//
// Replaces scripts/dev/_probe_bw.py
//   P1 `pure_copy_plane` (kernel `_pure_copy_kernel`): o = x;
//   P2 `copy_plane` (kernel `_copy_kernel`): o = T(f32(x) * 1.0001f), one
//       f32 multiply and one round to nearest even;
//   P3 `copy_plane_consts` (kernel `_copy_kernel_consts`): o = T(f32(x) +
//       0 * sum_k c_k[0, 0]), each block first bringing all n constant
//       (128, 128) f32 planes on chip, as the Pallas BlockSpec brings each
//       whole block into VMEM and as the port's DFT kernels read their
//       constant tables per block.
//
// The probe measures what the port's CUDA kernels can reach when they
// stream, so it is built with the same toolchain and moves the same
// 16-byte words per thread as their loads and stores (`ldv`/`stv` of
// storage.cuh: P1 copies the words as they are, P2 and P3 widen each to
// f32 and store it back with `stv`).  Block b streams rows
// [b br, (b + 1) br), grid = rows / br, as the Pallas grid steps do; each
// of its 512 threads keeps eight 16-byte loads in flight before it stores
// them (on the H100 this streamed faster than 256 threads with four, most
// at br = 32, where only 192 blocks share the 132 SMs).
//
// Bound on the H100: bytes.  At 6144 x 8192 every plane (100.7 MB at 2
// bytes, 201.3 MB at 4) is larger than the 50 MB L2, so a loop that chains
// output into input streams from HBM.  P3's constant planes (64 KB each)
// stay in L2 across blocks: what it adds is the per-block cost of bringing
// n of them through shared memory.  Each goes through one 64 KB shared
// buffer and c_k[0, 0] is read back after a barrier; stores to shared
// memory are seen by the other threads, so the compiler keeps every load.
#include <cuda_fp16.h>

#include "lpt_dft.cuh"

namespace lpt {

// f16 words for ldv/stv: the two halves of a 32-bit word, low first; a
// store rounds to nearest even, as torch's .to(float16) and JAX's astype.
__device__ __forceinline__ void unpack2(uint32_t w, float* x, __half, Fix) {
  x[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  x[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__device__ __forceinline__ uint32_t bits(float x, __half, Fix) {
  return (uint32_t)__half_as_ushort(__float2half_rn(x));
}

}  // namespace lpt

using namespace lpt;

// The elements of one 16-byte word of T, widened to f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float (&x)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  } else {
    unpack2(u.x, x, T{}, Fix{});
    unpack2(u.y, x + 2, T{}, Fix{});
    unpack2(u.z, x + 4, T{}, Fix{});
    unpack2(u.w, x + 6, T{}, Fix{});
  }
}

constexpr int THREADS = 512;
constexpr int DEPTH = 8;                  // 16-byte loads in flight per thread
constexpr int CONST_WORDS = 128 * 128 / 4;  // one constant plane in float4 words
enum Op { COPY, SCALE, CONSTS };

// o = op(x) over the block's `words` 16-byte words of the plane.
template <typename T, Op OP>
__global__ void __launch_bounds__(THREADS) probe_kernel(const uint4* __restrict__ x,
                                                        uint4* __restrict__ o, int words,
                                                        const float4* __restrict__ consts,
                                                        int n_consts) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float4 cs[];
  const size_t base = (size_t)blockIdx.x * words;
  float bump = 0.f;
  if constexpr (OP == CONSTS) {
    float sum = 0.f;
    for (int k = 0; k < n_consts; ++k) {
      const float4* c = consts + (size_t)k * CONST_WORDS;
      for (int i = threadIdx.x; i < CONST_WORDS; i += blockDim.x) cs[i] = __ldg(c + i);
      __syncthreads();
      sum += cs[0].x;
      __syncthreads();
    }
    bump = sum * 0.f;
  }
  for (int i = threadIdx.x; i < words; i += DEPTH * blockDim.x) {
    uint4 u[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      if (i + j * (int)blockDim.x < words) u[j] = __ldg(x + base + i + j * blockDim.x);
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      const int w = i + j * (int)blockDim.x;
      if (w >= words) continue;
      if constexpr (OP == COPY) {
        o[base + w] = u[j];
      } else {
        float v[V];
        widen<T>(u[j], v);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = OP == SCALE ? v[k] * 1.0001f : v[k] + bump;
        stv<V>(reinterpret_cast<T*>(o + base + w), v);
      }
    }
  }
}

template <typename T, Op OP>
static int run(const void* x, void* o, int rows, int w, int br, const float* consts,
               int n_consts, void* stream) {
  if (br <= 0 || rows % br || ((size_t)w * sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  const int words = (int)((size_t)br * w * sizeof(T) / 16);
  const size_t smem = OP == CONSTS ? CONST_WORDS * sizeof(float4) : 0;
  return launch(probe_kernel<T, OP>, dim3(rows / br), dim3(THREADS), smem, stream,
                (const uint4*)x, (uint4*)o, words, (const float4*)consts, n_consts);
}

// Type codes of the probe's entries (the storage codes of storage.cuh,
// extended): 0 f32, 1 bf16, 3 f16, 4 i32.
enum ProbeCode { P_F32 = 0, P_BF16 = 1, P_F16 = 3, P_I32 = 4 };

template <Op OP>
static int dispatch(const void* x, void* o, int rows, int w, int br, const float* consts,
                    int n_consts, int code, void* stream) {
  switch (code) {
    case P_F32: return run<float, OP>(x, o, rows, w, br, consts, n_consts, stream);
    case P_BF16: return run<__nv_bfloat16, OP>(x, o, rows, w, br, consts, n_consts, stream);
    case P_F16: return run<__half, OP>(x, o, rows, w, br, consts, n_consts, stream);
    case P_I32:
      if constexpr (OP == COPY) return run<int32_t, COPY>(x, o, rows, w, br, consts, 0, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, o: contiguous 16-byte aligned (rows, w) planes of the type `code`;
// br: rows per block (rows % br == 0); consts: n (128, 128) f32 planes.

// P1 (f32, bf16, f16, i32).
extern "C" int lpt_pure_copy_plane(const void* x, void* o, int rows, int w, int br, int code,
                                   void* stream) {
  return dispatch<COPY>(x, o, rows, w, br, nullptr, 0, code, stream);
}

// P2 (f32, bf16, f16).
extern "C" int lpt_copy_plane(const void* x, void* o, int rows, int w, int br, int code,
                              void* stream) {
  return dispatch<SCALE>(x, o, rows, w, br, nullptr, 0, code, stream);
}

// P3 (f32, bf16, f16).
extern "C" int lpt_copy_plane_consts(const void* x, void* o, const float* consts, int n_consts,
                                     int rows, int w, int br, int code, void* stream) {
  return dispatch<CONSTS>(x, o, rows, w, br, consts, n_consts, code, stream);
}
