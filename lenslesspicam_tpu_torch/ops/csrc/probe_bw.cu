// P1, P2, P3: the port's bandwidth probe, three streaming passes over a
// (rows, w) plane.
//
// Replaces scripts/dev/_probe_bw.py
//   P1 `pure_copy_plane` (kernel `_pure_copy_kernel`): o = x;
//   P2 `copy_plane` (kernel `_copy_kernel`): o = T(f32(x) * 1.0001f), one
//       f32 multiply and one round to nearest even;
//   P3 `copy_plane_consts` (kernel `_copy_kernel_consts`): o = T(f32(x) +
//       0 * sum_k c_k[0, 0]), reading one element of each of the n constant
//       (128, 128) f32 planes.
//
// Bound on the H100: bytes.  At 6144 x 8192 every plane (100.7 MB at 2
// bytes, 201.3 MB at 4) is larger than the 50 MB L2, so a loop that chains
// output into input streams from HBM.
//
// A bulk-copy stream through shared memory, the three alike.  The plane
// is one flat run of rows * w * sizeof(T) bytes (whole 16-byte words), cut
// into chunks of CHUNK bytes, the last one ragged.  Block b streams chunk b
// (grid = the chunks), so the hardware deals the chunks to the SMs as
// blocks finish, and the order in which the plane is walked depends on
// its shape alone.  The Pallas row block `br` is checked but sets no grid
// (a VMEM block size is a TPU artefact).  One thread of the block brings
// its chunk into shared memory by `cp.async.bulk`, which lands on an
// mbarrier, and writes it back by a bulk store; P1's bytes never pass
// through registers.  In P2 and P3 the block's threads first widen each
// 16-byte word of the arrived chunk to f32, multiply (P2) or add the bump
// (P3), round it back in place, fence it for the copy engine and meet at
// a barrier.  All launch STREAM_THREADS threads a block (P1's others leave
// at once), which holds an SM to four resident blocks: its stages, 64 KB
// of loads in flight.  On the H100 that ran level with x.clone() and
// torch.mul, where a persistent grid that dealt the chunks to a ring of
// stages in each block ran 5 % behind them (its slowest SM sets the end),
// and one-thread blocks (13 resident, 208 KB in flight) 1 % behind;
// PERF.md has the variants' times.
//
// P3's constants.  The Pallas kernel's constant index map brings each
// constant plane on chip once per core; the function reads c_k[0, 0]
// alone.  So while its chunk is in flight each block loads the n scalars
// c_k[0, 0] (4 bytes each, 64 KB apart: after the first block they come
// from the L2), STREAM_THREADS at a time, one a thread, through shared
// memory, and every thread sums them in f32 from k = 0, the plain
// version's order: a NaN or an inf among them, or a sum that overflows,
// makes every output NaN, and with n = 0 the bump is +0 (a -0 in x comes
// out +0, as in the plain version).  The kernel moves x, o and 4 n bytes.
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

// The chunks of P1-P3.
constexpr int CHUNK = 16384;            // bytes a chunk, a block's stage
constexpr int STREAM_THREADS = 512;     // threads a block
constexpr int BAR_BYTES = 128;          // the mbarrier, before the stage
constexpr int WORDS = CHUNK / 16 / STREAM_THREADS;   // 16-byte words a thread
constexpr int CONST_FLOATS = 128 * 128;  // one constant plane of P3
static_assert(CHUNK % (16 * STREAM_THREADS) == 0, "a stage of whole words a thread");

// Shared memory a block: the barrier, the stage and, for P3, a round of
// STREAM_THREADS constant scalars after the stage.
template <Op OP>
constexpr size_t smem_bytes() {
  return BAR_BYTES + (size_t)CHUNK + (OP == CONSTS ? sizeof(float) * STREAM_THREADS : 0);
}

// o = op(x) over chunk blockIdx.x of the `bytes` bytes of the plane; P3
// adds 0 * sum_k consts[k * CONST_FLOATS], k < n_consts.
template <typename T, Op OP>
__global__ void __launch_bounds__(STREAM_THREADS)
    chunk_kernel(const char* __restrict__ x, char* __restrict__ o, long long bytes,
                 const float* __restrict__ consts, int n_consts) {
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
  float bump = 0.f;
  if constexpr (OP == CONSTS) {
    // c_k[0, 0] while the chunk is in flight, a round of STREAM_THREADS
    // through shared memory, summed in order by every thread
    float* cs = reinterpret_cast<float*>(stage + CHUNK);
    float sum = 0.f;
    for (int k0 = 0;; k0 += STREAM_THREADS) {
      const int k = k0 + (int)threadIdx.x;
      if (k < n_consts) cs[threadIdx.x] = __ldg(consts + (size_t)k * CONST_FLOATS);
      __syncthreads();     // the round is in; the first: the barrier is initialised
      const int m = min(n_consts - k0, STREAM_THREADS);
      for (int j = 0; j < m; ++j) sum += cs[j];
      if (k0 + STREAM_THREADS >= n_consts) break;
      __syncthreads();     // the round is read before the next overwrites it
    }
    bump = sum * 0.f;
  }
  if constexpr (OP == SCALE) __syncthreads();     // the barrier is initialised
  mbar_wait(full, 0);
  if constexpr (OP != COPY) {
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
      for (int e = 0; e < V; ++e) v[e] = OP == SCALE ? v[e] * 1.0001f : v[e] + bump;
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

template <typename T, Op OP>
static int run(const void* x, void* o, int rows, int w, int br, const float* consts,
               int n_consts, void* stream) {
  if (br <= 0 || rows % br || ((size_t)w * sizeof(T)) % 16) return (int)cudaErrorInvalidValue;
  if (n_consts < 0) return (int)cudaErrorInvalidValue;
  const long long bytes = (long long)rows * w * (long long)sizeof(T);
  const long long n_chunks = (bytes + CHUNK - 1) / CHUNK;
  if (n_chunks < 1 || n_chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch(chunk_kernel<T, OP>, dim3((unsigned)n_chunks), dim3(STREAM_THREADS),
                smem_bytes<OP>(), stream, (const char*)x, (char*)o, bytes, consts, n_consts);
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
// br: the Pallas row block (rows % br == 0, checked; it sets no grid);
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
