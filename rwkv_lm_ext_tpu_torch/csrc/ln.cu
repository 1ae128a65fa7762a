// K3: LayerNorm over the last axis of an (M, C) row-major array.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/ln_pallas.py:21 _ln_kernel
// (launched by _ln_pallas, under layer_norm_pallas). Same arithmetic: one
// pass over the row for fp32 statistics E[x] and E[x^2], variance
// E[x^2] - mu^2 clamped at 0, then (x - mu) * rsqrt(var + eps) * scale + bias,
// written in the input's dtype.
//
// Bound on the card: bytes (one read and one write of the row; the second
// sweep re-reads the row from L1). One block per row, 256 threads striding
// over C, so any C and any row count works: the Pallas wrapper fell back to
// XLA unless C % 128 == 0 and M % 256 == 0; this kernel has no such gate.
#include "common.cuh"

namespace rwkv {

constexpr int kLnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLnThreads) layer_norm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ y, int C, float eps) {
  __shared__ float red[kLnThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float s = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    const float v = to_f(xr[c]);
    s += v;
    s2 = fmaf(v, v, s2);
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float mu = s / C;
  const float var = fmaxf(s2 / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += kLnThreads) {
    const float v = (to_f(xr[c]) - mu) * rstd;
    yr[c] = from_f<T>(fmaf(v, to_f(scale[c]), to_f(bias[c])));
  }
}

template <typename T>
static cudaError_t launch_layer_norm(const void* x, const void* scale,
                                     const void* bias, void* y, long long M,
                                     int C, float eps, cudaStream_t stream) {
  layer_norm_kernel<T><<<(unsigned)M, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y), C, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

extern "C" int rwkv_layer_norm(const void* x, const void* scale,
                               const void* bias, void* y, long long M, int C,
                               float eps, int dtype, void* stream) {
  using namespace rwkv;
  if (M <= 0 || C <= 0) return cudaSuccess;
  if (M > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_layer_norm<float>(x, scale, bias, y, M, C, eps, s);
    case kBFloat16: return launch_layer_norm<__nv_bfloat16>(x, scale, bias, y, M, C, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rwkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
