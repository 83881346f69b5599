// K7: saturation fraction of a stored int16 carry plane.
//
// Replaces lenslesspicam_tpu/ops/pallas_kernels2.py `sat_scan_i16` (kernel
// `_sat_scan_kernel`): max |x| / 32767 over the plane.  The TPU kernel
// max-accumulates an (8, 128) block over its grid steps in order; GPU
// blocks run in no order, so each block reduces its share (grid-stride
// loop with four 16-byte loads in flight per thread, a warp-shuffle max)
// and adds it with one atomicMax on the int bits of a zeroed f32 scalar,
// which orders like the value for non-negative floats.  |x| is taken in
// int32: a plane holding -32768 reads 32768/32767 > 1, as JAX's f32 -min
// does.
//
// Bound on the H100: bytes (the plane is read once; one max per element).
#include <algorithm>

#include "storage.cuh"

using namespace lpt;

__global__ void __launch_bounds__(256) sat_scan_kernel(const int16_t* __restrict__ x, size_t n,
                                                       float inv, float* __restrict__ sat) {
  const size_t nw = n / 8;  // whole 16-byte words
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int mx = 0;
  // four independent 16-byte loads in flight per thread per trip
  for (size_t i = t0; i < nw; i += 4 * stride) {
    uint4 u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = i + j * stride < nw ? __ldg(reinterpret_cast<const uint4*>(x) + i + j * stride)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w[4] = {u[j].x, u[j].y, u[j].z, u[j].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        mx = max(mx, abs((int)(int16_t)(w[k] & 0xffffu)));
        mx = max(mx, abs((int32_t)w[k] >> 16));
      }
    }
  }
  for (size_t i = nw * 8 + t0; i < n; i += stride) mx = max(mx, abs((int)x[i]));
  block_max_to((float)mx * inv, sat);
}

// x: 16-byte aligned int16 plane of n elements; inv: 1/32767 as f32; sat:
// a zeroed f32 scalar.
extern "C" int lpt_sat_scan_i16(const int16_t* x, long long n, float inv, float* sat,
                                void* stream) {
  const long long words = (n + 7) / 8;
  const int blocks = (int)std::min(std::max((words + 255) / 256, 1LL), 1056LL);  // 8 per SM
  sat_scan_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(x, (size_t)n, inv, sat);
  return (int)cudaGetLastError();
}
