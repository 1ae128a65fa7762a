// B.9: one T=1 WKV6 step + per-head GroupNorm(ln_x) + gate, on the logical
// (B, H, N, N) fp32 state.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/wkv_decode.py:68
// _decode_packed_kernel (launched by wkv6_decode_step_packed_pallas, :202);
// the JAX package's default T=1 route, the XLA twin wkv6_decode_step_packed
// (:242), computes the same function. Per (b, h):
//   y_j   = sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j
//   S'_ij = exp(-exp(w_i)) S_ij + k_i v_j
//   out   = (GroupNorm_head(y) * scale + bias) * g     (eps = ln_x_eps)
// r, k, v, g (B, C) in one dtype, w (B, C) fp32, u (H, N), scale/bias (C,)
// fp32 -> out (B, C) in g's dtype and S' (B, H, N, N) fp32.
//
// The Pallas kernel's tile-packed (B, H, N*N/128, 128) state, its one-hot
// MXU spreads with the hi/lo bf16 split, and _pick_bt_packed all work around
// the TPU's 128-lane tiles; none of them is carried over.
//
// Bound on the card: bytes. The state is read once and written once:
// 2 * B * H * N * N * 4 = 67 MB a layer at B=64, H=32, N=64, about 20 us at
// 3.35 TB/s; at B=1 the step is bound by launch latency. Design: one block
// of 4N threads per (b, h). Thread t owns four adjacent columns (a float4)
// of N/16 rows, the rows interleaved so that a warp's loads cover adjacent
// rows; it issues all its 16-byte state loads before any store, computes
// its partial y and S', and writes S' over the same addresses. Partial y
// sums meet in shared memory; the bonus, the GroupNorm mean and the
// centred variance are block reductions in fp32.
//
// out_state may alias state (the engine updates its state in place): every
// element is read and then written by the same thread, so the two pointers
// are deliberately not __restrict__.
#include "common.cuh"

namespace rwkv {

template <typename T, int N>
__global__ void __launch_bounds__(4 * N) wkv6_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ g,
    const float* __restrict__ u, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* state, T* __restrict__ out,
    float* out_state, int H, float eps) {
  constexpr int kThreads = 4 * N;
  constexpr int kGroups = N / 4;               // float4 column groups
  constexpr int kSlabs = kThreads / kGroups;   // 16 row slabs
  constexpr int kRows = N / kSlabs;            // rows a thread owns
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float ew_s[N];
  __shared__ __align__(16) float v_s[N];
  __shared__ __align__(16) float part[kSlabs][N];
  __shared__ float red[kThreads / 32];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int t = threadIdx.x;
  const size_t vec = (size_t)bh * N;           // (b, h*N) of a (B, C) array
  float ruk = 0.f;
  if (t < N) {
    const float rt = to_f(r[vec + t]), kt = to_f(k[vec + t]);
    r_s[t] = rt;
    k_s[t] = kt;
    v_s[t] = to_f(v[vec + t]);
    ew_s[t] = expf(-expf(w[vec + t]));
    ruk = rt * u[h * N + t] * kt;
  }
  __syncthreads();

  const int j0 = (t % kGroups) * 4, slab = t / kGroups;
  const float* sp = state + (size_t)bh * N * N + j0;
  float* op = out_state + (size_t)bh * N * N + j0;
  float4 s4[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    s4[q] = *reinterpret_cast<const float4*>(sp + (size_t)(q * kSlabs + slab) * N);
  const float4 v4 = *reinterpret_cast<const float4*>(v_s + j0);
  float4 y4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = q * kSlabs + slab;
    const float ri = r_s[i], ki = k_s[i], ei = ew_s[i];
    const float4 s = s4[q];
    y4.x = fmaf(ri, s.x, y4.x);
    y4.y = fmaf(ri, s.y, y4.y);
    y4.z = fmaf(ri, s.z, y4.z);
    y4.w = fmaf(ri, s.w, y4.w);
    float4 n;
    n.x = fmaf(s.x, ei, ki * v4.x);
    n.y = fmaf(s.y, ei, ki * v4.y);
    n.z = fmaf(s.z, ei, ki * v4.z);
    n.w = fmaf(s.w, ei, ki * v4.w);
    *reinterpret_cast<float4*>(op + (size_t)i * N) = n;
  }
  *reinterpret_cast<float4*>(&part[slab][j0]) = y4;

  // the barrier inside this sum also publishes part[][]
  const float bonus = block_sum(ruk, red);
  float y = 0.f;
  if (t < N) {
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) y += part[s][t];
    y = fmaf(bonus, v_s[t], y);
  }
  const float mu = block_sum(t < N ? y : 0.f, red) * (1.f / N);
  const float d = y - mu;
  const float var = block_sum_nowait(t < N ? d * d : 0.f, red) * (1.f / N);
  if (t < N) {
    const int c = h * N + t;
    out[vec + t] = from_f<T>(fmaf(d * rsqrtf(var + eps), scale[c], bias[c]) * to_f(g[vec + t]));
  }
}

template <typename T, int N>
static cudaError_t launch_decode(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* g,
                                 const void* scale, const void* bias,
                                 const void* state, void* out, void* out_state,
                                 int B, int H, float eps, cudaStream_t stream) {
  wkv6_decode_kernel<T, N><<<B * H, 4 * N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(g), static_cast<const float*>(u),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(state), static_cast<T*>(out),
      static_cast<float*>(out_state), H, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

extern "C" int rwkv_wkv6_decode(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* g,
                                const void* scale, const void* bias,
                                const void* state, void* out, void* out_state,
                                int B, int H, int N, float eps, int dtype,
                                void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_DECODE_CASE(TYPE, NN) \
  return launch_decode<TYPE, NN>(r, k, v, w, u, g, scale, bias, state, out, out_state, B, H, eps, s)
  if (dtype == kFloat32 && N == 32) RWKV_DECODE_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_DECODE_CASE(float, 64);
  if (dtype == kBFloat16 && N == 32) RWKV_DECODE_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_DECODE_CASE(__nv_bfloat16, 64);
#undef RWKV_DECODE_CASE
  return cudaErrorInvalidValue;
}
