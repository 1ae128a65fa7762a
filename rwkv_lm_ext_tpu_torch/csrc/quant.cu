// B.4: per-row int8 quantization of activations, the dynamic half of the
// int8c projection.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/quant_pallas.py:29
// _quant_kernel (launched by quantize_rows, :82). For each row of an (M, C)
// array:
//   ax   = max_c |x[c]|                      (fp32)
//   sx   = max(ax * fl(1/127), 1e-12)
//   q[c] = (int8) rint(x[c] / sx)            (IEEE division, half to even)
// written as int8 q (M, C) and fp32 sx (M, 1). Bit-identity with the Pallas
// kernel and with ops/quant.py quantize_rows_plain is the contract:
//   - the scale is ax times the fp32 constant 1/127, not ax / 127: XLA folds
//     the division by the constant into that multiply, in the Pallas kernel
//     and in every jitted quantize_rows_xla, and the two differ in the last
//     bit for a few percent of rows;
//   - x / sx is an IEEE division (__fdiv_rn), never x * (1/sx);
//   - rounding is __float2int_rn, half to even like jnp.round and
//     torch.round (roundf would round halves away from zero);
//   - no clip, as in the reference; |x / sx| <= 127 by construction.
// The library is built without fast-math (ops/_lib.py).
//
// A second entry, rwkv_quantize_rows_given, takes the row scales sx as an
// input and writes q only: the quantizing sweep of the same kernel with the
// absmax pass left out. A tensor-parallel row-parallel projection
// (parallel/tp.py) splits the contraction axis, so a rank holds a slice of
// each row; it takes every slice's scale (the first entry), the largest of
// them over the ranks (an all-reduce), and quantizes its slice with that
// scale here. Since fl(a * c) and the 1e-12 floor are monotone in a, the
// largest slice scale is the whole row's, so the slices' codes are the
// whole row's codes, bit for bit. Same bound (bytes: one read of x and sx,
// one int8 write) and the same one-block-a-row design.
//
// Bound on the card: bytes. One read of x and one int8 write: at
// (32768, 2048) bf16 that is 134 MB + 67 MB, about 0.06 ms at 3.35 TB/s.
// Design: one block of 256 threads per row. When the row is 16-byte
// aligned and at most 8 vectors a thread, each thread keeps its slice of
// the row in registers (16-byte loads), so the row is read from device
// memory once and the quantizing sweep touches registers only; any other
// row takes a generic path that reads the row twice (the second time from
// L1/L2). The Pallas wrapper fell back to jnp for C % 128 != 0 or small M;
// this kernel takes any M and C.
#include <cstdint>

#include "common.cuh"

namespace rwkv {

constexpr int kQuantThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;   // folded to the fp32 constant

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };           // float4
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };   // 8 x bf16

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}

template <int K> struct alignas(K) QPack { signed char c[K]; };

// max of v over the block, returned to every thread (inputs are >= 0)
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantThreads / 32; ++i) m = fmaxf(m, red[i]);
  return m;
}

__device__ __forceinline__ float row_scale(float ax) {
  return fmaxf(__fmul_rn(ax, kInv127), 1e-12f);
}

__device__ __forceinline__ signed char quant_one(float x, float sx) {
  return static_cast<signed char>(__float2int_rn(__fdiv_rn(x, sx)));
}

// C % kN == 0 and 16-byte aligned rows; thread t holds vectors t, t + 256, ...
// GIVEN: sx is read from s (the given-scale entry) instead of computed and
// written.
template <typename T, int NV, bool GIVEN>
__global__ void __launch_bounds__(kQuantThreads) quant_rows_vec_kernel(
    const T* __restrict__ x, signed char* __restrict__ q,
    float* __restrict__ s, int C) {
  constexpr int K = Vec<T>::kN;
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * C;
  signed char* qr = q + row * C;
  const int nvec = C / K;
  float v[NV][K];
  float ax = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int vi = threadIdx.x + n * kQuantThreads;
    if (vi < nvec) {
      load_vec(xr + (size_t)vi * K, v[n]);
#pragma unroll
      for (int e = 0; e < K; ++e) ax = fmaxf(ax, fabsf(v[n][e]));
    }
  }
  float sx;
  if constexpr (GIVEN) {
    sx = s[row];
  } else {
    sx = row_scale(block_max(ax, red));
    if (threadIdx.x == 0) s[row] = sx;
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int vi = threadIdx.x + n * kQuantThreads;
    if (vi < nvec) {
      QPack<K> pk;
#pragma unroll
      for (int e = 0; e < K; ++e) pk.c[e] = quant_one(v[n][e], sx);
      *reinterpret_cast<QPack<K>*>(qr + (size_t)vi * K) = pk;
    }
  }
}

// any C and alignment: scalar loads, the row read twice (once with GIVEN)
template <typename T, bool GIVEN>
__global__ void __launch_bounds__(kQuantThreads) quant_rows_generic_kernel(
    const T* __restrict__ x, signed char* __restrict__ q,
    float* __restrict__ s, int C) {
  __shared__ float red[kQuantThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * C;
  signed char* qr = q + row * C;
  float sx;
  if constexpr (GIVEN) {
    sx = s[row];
  } else {
    float ax = 0.f;
    for (int c = threadIdx.x; c < C; c += kQuantThreads) ax = fmaxf(ax, fabsf(to_f(xr[c])));
    sx = row_scale(block_max(ax, red));
    if (threadIdx.x == 0) s[row] = sx;
  }
  for (int c = threadIdx.x; c < C; c += kQuantThreads) qr[c] = quant_one(to_f(xr[c]), sx);
}

template <typename T, bool GIVEN>
static cudaError_t launch_quant(const void* x, void* q, void* s, long long M,
                                int C, cudaStream_t stream) {
  constexpr int K = Vec<T>::kN;
  const T* xp = static_cast<const T*>(x);
  auto* qp = static_cast<signed char*>(q);
  auto* sp = static_cast<float*>(s);
  const bool aligned = C % K == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % K == 0;
  const int per_thread = (C / K + kQuantThreads - 1) / kQuantThreads;
  const unsigned grid = (unsigned)M;
  if (aligned && per_thread <= 1)
    quant_rows_vec_kernel<T, 1, GIVEN><<<grid, kQuantThreads, 0, stream>>>(xp, qp, sp, C);
  else if (aligned && per_thread <= 2)
    quant_rows_vec_kernel<T, 2, GIVEN><<<grid, kQuantThreads, 0, stream>>>(xp, qp, sp, C);
  else if (aligned && per_thread <= 4)
    quant_rows_vec_kernel<T, 4, GIVEN><<<grid, kQuantThreads, 0, stream>>>(xp, qp, sp, C);
  else if (aligned && per_thread <= 8)
    quant_rows_vec_kernel<T, 8, GIVEN><<<grid, kQuantThreads, 0, stream>>>(xp, qp, sp, C);
  else
    quant_rows_generic_kernel<T, GIVEN><<<grid, kQuantThreads, 0, stream>>>(xp, qp, sp, C);
  return cudaGetLastError();
}

template <bool GIVEN>
static int quantize_entry(const void* x, void* q, void* s, long long M, int C, int dtype,
                          void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  if (M > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_quant<float, GIVEN>(x, q, s, M, C, st);
    case kBFloat16: return launch_quant<__nv_bfloat16, GIVEN>(x, q, s, M, C, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rwkv

extern "C" int rwkv_quantize_rows(const void* x, void* q, void* s, long long M,
                                  int C, int dtype, void* stream) {
  return rwkv::quantize_entry<false>(x, q, s, M, C, dtype, stream);
}

// s (M,) fp32 holds the given row scales; writes q only
extern "C" int rwkv_quantize_rows_given(const void* x, void* q, const void* s,
                                        long long M, int C, int dtype, void* stream) {
  return rwkv::quantize_entry<true>(x, q, const_cast<void*>(s), M, C, dtype, stream);
}
