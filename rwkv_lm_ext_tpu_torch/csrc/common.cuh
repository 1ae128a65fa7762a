// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel of this directory is reached through a plain C entry point
// (`extern "C"`) that the Python side loads with ctypes
// (rwkv_lm_ext_tpu_torch/ops/_lib.py). Each entry point takes raw device
// pointers and a cudaStream_t, launches on that stream, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rwkv {

// dtype codes shared with ops/_lib.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the whole block, returned to every thread. blockDim.x must
// be a multiple of 32; `red` holds at least blockDim.x / 32 floats of shared
// memory. No trailing barrier: the caller must not write `red` again until
// every thread has passed a later barrier.
__device__ __forceinline__ float block_sum_nowait(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < n_warps; ++i) s += red[i];
  return s;
}

// block_sum_nowait with a trailing barrier, so `red` can be reused at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const float s = block_sum_nowait(v, red);
  __syncthreads();
  return s;
}

}  // namespace rwkv
