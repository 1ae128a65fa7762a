// B.15: K1's function (the RWKV-6 WKV recurrence, then the per-head
// GroupNorm(ln_x), scale, bias and gate) that also writes the fp32 state
// after EVERY position: the speculative verify pass (models/collect.py).
//
// Replaces no TPU kernel: the JAX package's wkv_collect
// (rwkv_lm_ext_tpu/ops/wkv_reference.py:80) is an XLA lax.scan whose carry
// stack XLA writes out; models/collect.py there runs it in place of the
// Pallas kernel, then the GroupNorm and gate as plain ops. Contract: r, k,
// v, g (B,T,H,N) in one dtype, w (B,T,H,N) fp32 log-decay (v5's constant
// decay expanded over B and T), u (H,N), ln_x scale/bias (H*N) fp32, s0
// (B,H,N,N) fp32 in (K,V) layout -> the gated output (B,T,H*N) in g's dtype
// and states[t] (B,H,N,N) fp32, the state after step t, at
// states + t * t_stride: a caller may hand in one layer's slice of a
// (T, L, B, H, N, N) stack (t_stride = L*B*H*N*N).
//
// Bound on the card: at the verify pass's shapes (B=1, T = gamma + 1 = 9,
// H=32, N=64) the state stack is what moves, 9 * 32 * 64 * 64 * 4 B = 4.7
// MB a layer, 1.4 us at 3.35 TB/s; but only 32 blocks run 9 dependent steps
// each, so launch latency and the step chain set the time, not the bytes.
// Design: the sequential body of K1 (csrc/wkv_fused.cu
// wkv6_sequential_kernel), one block of N threads per (b, h), thread j
// keeping column S[:, j] in registers; after each step the block writes the
// whole state, thread j its column, so for each row i the N threads store N
// neighbouring floats (coalesced). The fp32 sums are K1's sequential ones in
// the same order, so in fp32 the outputs equal K1's sequential body's; K1's
// bf16 chunked body sums in another order. K1 itself is not changed.
#include "common.cuh"

namespace rwkv {

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_collect_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const T* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ states, long long t_stride, int T_len, int H,
    float eps) {
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float ew_s[N];
  __shared__ __align__(16) float uk_s[N];
  __shared__ float red_mu[(N + 31) / 32], red_var[(N + 31) / 32];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[N];
  const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0p[i * N + j];
  const float u_j = u[h * N + j];
  const float sc_j = scale[h * N + j], bi_j = bias[h * N + j];

  const size_t step = (size_t)H * N;
  size_t idx = ((size_t)b * T_len * H + h) * N + j;  // element (b, 0, h, j)
  float* st = states + (size_t)bh * N * N + j;       // column j of states[0][b][h]
  for (int t = 0; t < T_len; ++t, idx += step, st += t_stride) {
    const float r_j = to_f(r[idx]), k_j = to_f(k[idx]), v_j = to_f(v[idx]);
    const float g_j = to_f(g[idx]);
    // three barriers a step, as in K1's sequential body: the stage and
    // red_mu of step t+1 are written only after step t's red_var barrier
    r_s[j] = r_j;
    k_s[j] = k_j;
    ew_s[j] = expf(-expf(w[idx]));
    uk_s[j] = u_j * k_j;
    __syncthreads();

    float y = 0.f, ruk = 0.f;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(r_s + i);
      const float4 k4 = *reinterpret_cast<const float4*>(k_s + i);
      const float4 e4 = *reinterpret_cast<const float4*>(ew_s + i);
      const float4 uk4 = *reinterpret_cast<const float4*>(uk_s + i);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ee[4] = {e4.x, e4.y, e4.z, e4.w};
      const float uu[4] = {uk4.x, uk4.y, uk4.z, uk4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        y = fmaf(rr[q], S[i + q], y);
        ruk = fmaf(rr[q], uu[q], ruk);
        S[i + q] = fmaf(S[i + q], ee[q], kk[q] * v_j);
      }
    }
    y = fmaf(ruk, v_j, y);
#pragma unroll
    for (int i = 0; i < N; ++i) st[(size_t)i * N] = S[i];

    const float mu = block_sum_nowait(y, red_mu) * (1.f / N);
    const float d = y - mu;
    const float var = block_sum_nowait(d * d, red_var) * (1.f / N);
    out[idx] = from_f<T>(fmaf(d * rsqrtf(var + eps), sc_j, bi_j) * g_j);
  }
}

template <typename T, int N>
static cudaError_t launch_collect(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* g, const void* scale,
                                  const void* bias, const void* s0, void* out, void* states,
                                  long long t_stride, int B, int T_len, int H, float eps,
                                  cudaStream_t stream) {
  wkv6_collect_kernel<T, N><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s0), static_cast<T*>(out), static_cast<float*>(states),
      t_stride, T_len, H, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

extern "C" int rwkv_wkv6_collect(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* g, const void* scale,
                                 const void* bias, const void* s0, void* out, void* states,
                                 long long t_stride, int B, int T_len, int H, int N, float eps,
                                 int dtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0 || T_len <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_COLLECT_CASE(TYPE, NN)                                                       \
  return launch_collect<TYPE, NN>(r, k, v, w, u, g, scale, bias, s0, out, states, t_stride, \
                                  B, T_len, H, eps, s)
  if (dtype == kFloat32 && N == 16) RWKV_COLLECT_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_COLLECT_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_COLLECT_CASE(float, 64);
  if (dtype == kFloat32 && N == 128) RWKV_COLLECT_CASE(float, 128);
  if (dtype == kBFloat16 && N == 16) RWKV_COLLECT_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_COLLECT_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_COLLECT_CASE(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && N == 128) RWKV_COLLECT_CASE(__nv_bfloat16, 128);
#undef RWKV_COLLECT_CASE
  return cudaErrorInvalidValue;
}
