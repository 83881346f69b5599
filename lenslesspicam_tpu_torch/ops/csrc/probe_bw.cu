// P1, P2, P3: the port's bandwidth probe, three streaming passes over a
// (rows, w) plane.
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
// Bound on the H100: bytes.  At 6144 x 8192 every plane (100.7 MB at 2
// bytes, 201.3 MB at 4) is larger than the 50 MB L2, so a loop that chains
// output into input streams from HBM.
//
// P1 and P2: a bulk-copy stream through shared memory.  The plane is one
// flat run of rows * w * sizeof(T) bytes (whole 16-byte words), cut into
// chunks of CHUNK bytes, the last one ragged.  Block b streams chunk b
// (grid = the chunks), so the hardware deals the chunks to the SMs as
// blocks finish, and the order in which the plane is walked depends on
// its shape alone.  The Pallas row block `br` is checked but sets no grid
// (a VMEM block size is a TPU artefact).  One thread of the block brings
// its chunk into shared memory by `cp.async.bulk`, which lands on an
// mbarrier, and writes it back by a bulk store; P1's bytes never pass
// through registers.  In P2 the block's threads first widen each 16-byte
// word of the arrived chunk to f32, multiply, round it back in place,
// fence it for the copy engine and meet at a barrier.  Both launch
// STREAM_THREADS threads a block (P1's others leave at once), which holds
// an SM to four resident blocks: its stages, 64 KB of loads in flight.
// On the H100 that ran level with x.clone() and torch.mul, where a
// persistent grid that dealt the chunks to a ring of stages in each block
// ran 5 % behind them (its slowest SM sets the end), and one-thread
// blocks (13 resident, 208 KB in flight) 1 % behind; PERF.md has the
// variants' times.
//
// P3: row blocks.  Block b streams rows [b br, (b + 1) br), grid = rows /
// br, as the Pallas grid steps do; each of its 512 threads keeps eight
// 16-byte loads in flight before it stores them.  Its constant planes
// (64 KB each) stay in L2 across blocks: what it adds is the per-block
// cost of bringing n of them through shared memory.  Each goes through one
// 64 KB shared buffer and c_k[0, 0] is read back after a barrier; stores to
// shared memory are seen by the other threads, so the compiler keeps every
// load.
#include <cuda_fp16.h>

#include "bulk_copy.cuh"
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

enum Op { COPY, SCALE, CONSTS };

// P1's and P2's chunks.
constexpr int CHUNK = 16384;            // bytes a chunk, a block's stage
constexpr int STREAM_THREADS = 512;     // threads a block
constexpr int BAR_BYTES = 128;          // the mbarrier, before the stage
constexpr int WORDS = CHUNK / 16 / STREAM_THREADS;   // P2's 16-byte words a thread
static_assert(CHUNK % (16 * STREAM_THREADS) == 0, "a stage of whole words a thread");

// o = op(x) over chunk blockIdx.x of the `bytes` bytes of the plane.
template <typename T, Op OP>
__global__ void __launch_bounds__(STREAM_THREADS)
    chunk_kernel(const char* __restrict__ x, char* __restrict__ o, long long bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + BAR_BYTES;
  const long long at = (long long)blockIdx.x * CHUNK;
  const uint32_t size = (uint32_t)min((long long)CHUNK, bytes - at);
  if (OP == COPY && threadIdx.x) return;
  if (threadIdx.x == 0) {
    mbar_init(full);
    mbar_fence_init();
    bulk_load(stage, x + at, size, full);
  }
  if constexpr (OP == SCALE) __syncthreads();     // the barrier is initialised
  mbar_wait(full, 0);
  if constexpr (OP == SCALE) {
    constexpr int V = 16 / sizeof(T);
    uint4* w = reinterpret_cast<uint4*>(stage);
    const int words = (int)(size / 16);
    uint4 u[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int i = threadIdx.x + k * STREAM_THREADS;
      if (i < words) u[k] = w[i];
    }
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      const int i = threadIdx.x + k * STREAM_THREADS;
      if (i >= words) continue;
      float v[V];
      widen<T>(u[k], v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] *= 1.0001f;
      stv<V>(reinterpret_cast<T*>(w + i), v);
    }
    fence_async_shared();
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    bulk_store(o + at, stage, size);
    bulk_wait_read();          // the stage is read before the block leaves
  }
}

// P3's row blocks.
constexpr int THREADS = 512;
constexpr int DEPTH = 8;                  // 16-byte loads in flight per thread
constexpr int CONST_WORDS = 128 * 128 / 4;  // one constant plane in float4 words

// o = x + 0 * sum_k c_k[0, 0] over the block's `words` 16-byte words of the
// plane.
template <typename T>
__global__ void __launch_bounds__(THREADS) consts_kernel(const uint4* __restrict__ x,
                                                         uint4* __restrict__ o, int words,
                                                         const float4* __restrict__ consts,
                                                         int n_consts) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float4 cs[];
  const size_t base = (size_t)blockIdx.x * words;
  float sum = 0.f;
  for (int k = 0; k < n_consts; ++k) {
    const float4* c = consts + (size_t)k * CONST_WORDS;
    for (int i = threadIdx.x; i < CONST_WORDS; i += blockDim.x) cs[i] = __ldg(c + i);
    __syncthreads();
    sum += cs[0].x;
    __syncthreads();
  }
  const float bump = sum * 0.f;
  for (int i = threadIdx.x; i < words; i += DEPTH * blockDim.x) {
    uint4 u[DEPTH];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      if (i + j * (int)blockDim.x < words) u[j] = __ldg(x + base + i + j * blockDim.x);
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      const int w = i + j * (int)blockDim.x;
      if (w >= words) continue;
      float v[V];
      widen<T>(u[j], v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = v[k] + bump;
      stv<V>(reinterpret_cast<T*>(o + base + w), v);
    }
  }
}

template <typename T, Op OP>
static int run(const void* x, void* o, int rows, int w, int br, const float* consts,
               int n_consts, void* stream) {
  if (br <= 0 || rows % br || ((size_t)w * sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  if constexpr (OP == CONSTS) {
    const int words = (int)((size_t)br * w * sizeof(T) / 16);
    return launch(consts_kernel<T>, dim3(rows / br), dim3(THREADS),
                  CONST_WORDS * sizeof(float4), stream, (const uint4*)x, (uint4*)o, words,
                  (const float4*)consts, n_consts);
  } else {
    const long long bytes = (long long)rows * w * (long long)sizeof(T);
    const long long n_chunks = (bytes + CHUNK - 1) / CHUNK;
    if (n_chunks < 1 || n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    return launch(chunk_kernel<T, OP>, dim3((unsigned)n_chunks), dim3(STREAM_THREADS),
                  BAR_BYTES + (size_t)CHUNK, stream, (const char*)x, (char*)o, bytes);
  }
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
// br: the Pallas row block (rows % br == 0; P3's rows per block);
// consts: n (128, 128) f32 planes.

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
