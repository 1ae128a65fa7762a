// K1: RWKV-6 WKV recurrence + per-head GroupNorm(ln_x) + gate, forward.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/wkv_pallas.py:743
// _wkv_gn_kernel (launched by _fused_impl under wkv6_fused_output). Same
// contract: r, k, v, g (B,T,H,N), w (B,T,H,N) fp32 log-decay, u (H,N),
// ln_x scale/bias (H*N), initial state s0 (B,H,N,N) fp32 in (K,V) layout ->
// gated output (B,T,H*N) in g's dtype and the final state (B,H,N,N) fp32.
//
// What it computes per (b, h) and step t, exactly as the sequential golden
// (ops/wkv_reference.py:58-67):
//   y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//   S_ij = S_ij * exp(-exp(w_i)) + k_i v_j
//   out  = (GroupNorm_head(y) * scale + bias) * g
// The TPU kernel instead factors each chunk of L steps into (L, L) matrix
// products for the MXU, which needs the exact-A / rescale decompositions;
// the plain recurrence here is exact at any decay and needs none of them,
// so the port has no WKV dispatch to select.
//
// Design: the TPU grid carried the state in VMEM scratch across sequential
// grid steps; Hopper runs blocks in no order, so the T loop is inside the
// block. One block per (b, h) with N threads; thread j keeps column S[:, j]
// in registers for the whole sequence. Per step the block stages r, k,
// exp(-exp(w)) and u*k in shared memory, each thread forms y_j, and the
// GroupNorm statistics are two block reductions (mean, then centred
// variance, as the TPU kernel computes them). The next step's inputs are
// loaded into registers before the current step's math to hide their
// latency.
//
// Bound on the card: bytes. At B=64, T=512, H=32, N=64 one call moves
// ~4 x 134 MB of bf16 r/k/v/g, 268 MB of fp32 w and 134 MB of output, about
// 0.28 ms at 3.35 TB/s; this first version is latency-bound by its serial
// T loop (three barriers a step) instead.
#include "common.cuh"

namespace rwkv {

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_fused_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const T* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ sT, int T_len, int H, float eps) {
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float ew_s[N];
  __shared__ __align__(16) float uk_s[N];
  __shared__ float red_mu[N / 32], red_var[N / 32];
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
  float r_n = 0.f, k_n = 0.f, v_n = 0.f, w_n = 0.f, g_n = 0.f;
  if (T_len > 0) {
    r_n = to_f(r[idx]); k_n = to_f(k[idx]); v_n = to_f(v[idx]);
    w_n = w[idx]; g_n = to_f(g[idx]);
  }
  for (int t = 0; t < T_len; ++t) {
    const float r_j = r_n, k_j = k_n, v_j = v_n, w_j = w_n, g_j = g_n;
    const size_t cur = idx;
    idx += step;
    if (t + 1 < T_len) {
      r_n = to_f(r[idx]); k_n = to_f(k[idx]); v_n = to_f(v[idx]);
      w_n = w[idx]; g_n = to_f(g[idx]);
    }
    // Three barriers a step. Rewriting the stage (or red_mu) for step t+1
    // needs no barrier of its own: a thread gets there only after the
    // red_var barrier of step t, which every thread reaches after its last
    // read of the stage and of red_mu in step t; likewise red_var is
    // rewritten only after step t+1's red_mu barrier.
    r_s[j] = r_j;
    k_s[j] = k_j;
    ew_s[j] = expf(-expf(w_j));
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

    const float mu = block_sum_nowait(y, red_mu) * (1.f / N);
    const float d = y - mu;
    const float var = block_sum_nowait(d * d, red_var) * (1.f / N);
    out[cur] = from_f<T>(fmaf(d * rsqrtf(var + eps), sc_j, bi_j) * g_j);
  }
  float* sTp = sT + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sTp[i * N + j] = S[i];
}

template <typename T, int N>
static cudaError_t launch_wkv6(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* g,
                               const void* scale, const void* bias,
                               const void* s0, void* out, void* sT, int B,
                               int T_len, int H, float eps,
                               cudaStream_t stream) {
  wkv6_fused_kernel<T, N><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s0), static_cast<T*>(out),
      static_cast<float*>(sT), T_len, H, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

extern "C" int rwkv_wkv6_fused(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* g,
                               const void* scale, const void* bias,
                               const void* s0, void* out, void* sT, int B,
                               int T_len, int H, int N, float eps, int dtype,
                               void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_WKV6_CASE(TYPE, NN) \
  return launch_wkv6<TYPE, NN>(r, k, v, w, u, g, scale, bias, s0, out, sT, B, T_len, H, eps, s)
  if (dtype == kFloat32 && N == 32) RWKV_WKV6_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_WKV6_CASE(float, 64);
  if (dtype == kBFloat16 && N == 32) RWKV_WKV6_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_WKV6_CASE(__nv_bfloat16, 64);
#undef RWKV_WKV6_CASE
  return cudaErrorInvalidValue;
}
