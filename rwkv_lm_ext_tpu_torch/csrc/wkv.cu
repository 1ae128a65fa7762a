// B.8: the unfused RWKV-6 WKV recurrence, forward: raw fp32 y and the final
// state, no GroupNorm and no gate.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/wkv_pallas.py:440 _wkv_kernel
// (launched by _wkv_pallas_fwd_impl under wkv_pallas, the "pallas" backend of
// ops/wkv.py:48 wkv). Contract: r, k, v (B,T,H,N) in one dtype, w (B,T,H,N)
// fp32 log-decay, u (H,N) or none (no bonus), initial state s0 (B,H,N,N) fp32
// in (K,V) layout or none (zeros) -> y (B,T,H,N) fp32 and the final state
// (B,H,N,N) fp32. Per (b, h) and step, as the sequential golden
// (ops/wkv_reference.py):
//   y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//   S_ij = S_ij * exp(-exp(w_i)) + k_i v_j
// Its callers are the bidirectional encoders (models/bidirectional.py), which
// run it twice a layer: a causal pass and a reverse pass.
//
// The TPU kernel splits T into chunks, factors each chunk into (L, L)
// matrix products by an exact dyadic decomposition of the decay and carries
// the state in VMEM between sequential grid steps.
//
// The bidirectional op needs the same scan over each row's valid prefix,
// walked backwards. The JAX package flips r, k, v, w with a gather, runs the
// causal kernel and flips y back: six more passes over (B,T,C) a layer. Here
// `reverse` and a per-row `lengths` (B,) int32 change only the time index:
// the block walks t = L-1 .. 0 (or 0 .. L-1) with L = lengths[b] (T when
// there are none), reads nothing at or beyond L and writes zeros to y there.
// The final state is the state after the prefix.
//
// Bound on the card: bytes. At B=8, T=512, H=32, N=64 a call reads 3 x 16.8
// MB of bf16 r/k/v and 33.6 MB of fp32 w and writes 33.6 MB of fp32 y and the
// final state, about 0.036 ms at 3.35 TB/s (0.29 ms at B=64); the chunked
// factoring's products are 4 N^2 a step and head on the tensor cores, a
// tenth of that time.
//
// Two bodies; the wrapper (ops/wkv.py) picks one from dtype and head size.
//
// Chunked body (bf16, N = 32 or 64), wkv6_raw_chunked_kernel: K1's chunked
// walk (chunk_walk, wkv_chunk.cuh) in its fourth mode, kChunkRaw: chunks of
// 16 steps on mma.sync, the state transposed in fp32 accumulators, exact at
// any decay (every scale exp of a sum of -exp(w)), the operands that are not
// bf16 in two bf16 limbs; phases A-C of the GroupNorm modes, then y stored in
// fp32 straight from the product's tile, with no GroupNorm and no gate. The
// walk takes `reverse` and `lengths` as pass 1 of B.8's backward does. One
// block of 2N threads per (b, h).
//
// Sequential body (fp32, and N of 16 or 128), wkv6_kernel: the first version, K1's
// first recurrence without the GroupNorm: one block of N threads per (b, h),
// thread j keeps column S[:, j] in registers for the whole sequence, one
// barrier a step (the stage of r, k, exp(-exp(w)), u*k is double buffered).
// It is latency-bound by the serial T loop; it keeps fp32 within 2e-5 of the
// plain version.
#include "wkv_chunk.cuh"

namespace rwkv {

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, const int* __restrict__ lengths,
    float* __restrict__ y_out, float* __restrict__ sT, int T_len, int H, int reverse) {
  __shared__ __align__(16) float r_s[2][N];
  __shared__ __align__(16) float k_s[2][N];
  __shared__ __align__(16) float ew_s[2][N];
  __shared__ __align__(16) float uk_s[2][N];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[N];
  if (s0) {
    const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) S[i] = s0p[i * N + j];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) S[i] = 0.f;
  }
  const float u_j = u ? u[h * N + j] : 0.f;
  const int L = lengths ? min(max(lengths[b], 0), T_len) : T_len;

  const size_t stride = (size_t)H * N;
  const size_t base = ((size_t)b * T_len * H + h) * N + j;   // element (b, 0, h, j)
  // step s of the walk reads and writes time t = s, or L-1-s in reverse
  auto at = [&](int s) { return base + (size_t)(reverse ? L - 1 - s : s) * stride; };

  float r_n = 0.f, k_n = 0.f, v_n = 0.f, w_n = 0.f;
  if (L > 0) {
    const size_t first = at(0);
    r_n = to_f(r[first]); k_n = to_f(k[first]); v_n = to_f(v[first]); w_n = w[first];
  }
  for (int s = 0; s < L; ++s) {
    const float r_j = r_n, k_j = k_n, v_j = v_n, w_j = w_n;
    const size_t cur = at(s);
    if (s + 1 < L) {
      const size_t nxt = at(s + 1);
      r_n = to_f(r[nxt]); k_n = to_f(k[nxt]); v_n = to_f(v[nxt]); w_n = w[nxt];
    }
    // One barrier a step: buffer s&1 was last read in step s-2, and a thread
    // gets here only after step s-1's barrier, which every thread reaches
    // after its reads of step s-2.
    const int buf = s & 1;
    r_s[buf][j] = r_j;
    k_s[buf][j] = k_j;
    ew_s[buf][j] = expf(-expf(w_j));
    uk_s[buf][j] = u_j * k_j;
    __syncthreads();

    float y = 0.f, ruk = 0.f;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(r_s[buf] + i);
      const float4 k4 = *reinterpret_cast<const float4*>(k_s[buf] + i);
      const float4 e4 = *reinterpret_cast<const float4*>(ew_s[buf] + i);
      const float4 uk4 = *reinterpret_cast<const float4*>(uk_s[buf] + i);
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
    y_out[cur] = fmaf(ruk, v_j, y);
  }
  for (int t = L; t < T_len; ++t) y_out[base + (size_t)t * stride] = 0.f;
  float* sTp = sT + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sTp[i * N + j] = S[i];
}

template <int N>
__global__ void __launch_bounds__(2 * N, 4) wkv6_raw_chunked_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    const int* __restrict__ lengths, float* __restrict__ y, float* __restrict__ sT, int T_len,
    int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_walk<N, kChunkRaw>(r, k, v, w, u, nullptr, nullptr, nullptr, s0, nullptr, lengths,
                           nullptr, sT, nullptr, y, nullptr, nullptr, nullptr, T_len, H, 0.f,
                           reverse, smem);
}

template <int N>
static cudaError_t launch_raw_chunked(const void* r, const void* k, const void* v,
                                      const void* w, const void* u, const void* s0,
                                      const void* lengths, void* y, void* sT, int B, int T_len,
                                      int H, int reverse, cudaStream_t stream) {
  constexpr int smem = ChunkLayout<N, kChunkRaw>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_raw_chunked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_raw_chunked_kernel<N><<<B * H, 2 * N, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const int*>(lengths), static_cast<float*>(y), static_cast<float*>(sT), T_len,
      H, reverse);
  return cudaGetLastError();
}

}  // namespace rwkv

// body codes shared with ops/wkv.py
enum { kWkvSequential = 0, kWkvChunked = 1 };

extern "C" int rwkv_wkv6(const void* r, const void* k, const void* v, const void* w,
                         const void* u, const void* s0, const void* lengths, void* y,
                         void* sT, int B, int T_len, int H, int N, int reverse, int dtype,
                         int body, void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (body == kWkvChunked) {
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    if (N == 32)
      return launch_raw_chunked<32>(r, k, v, w, u, s0, lengths, y, sT, B, T_len, H, reverse, s);
    if (N == 64)
      return launch_raw_chunked<64>(r, k, v, w, u, s0, lengths, y, sT, B, T_len, H, reverse, s);
    return cudaErrorInvalidValue;
  }
  if (body != kWkvSequential) return cudaErrorInvalidValue;
#define RWKV_WKV_CASE(TYPE, NN)                                                          \
  do {                                                                                   \
    wkv6_kernel<TYPE, NN><<<B * H, NN, 0, s>>>(                                           \
        static_cast<const TYPE*>(r), static_cast<const TYPE*>(k),                        \
        static_cast<const TYPE*>(v), static_cast<const float*>(w),                       \
        static_cast<const float*>(u), static_cast<const float*>(s0),                     \
        static_cast<const int*>(lengths), static_cast<float*>(y),                        \
        static_cast<float*>(sT), T_len, H, reverse);                                     \
    return cudaGetLastError();                                                           \
  } while (0)
  if (dtype == kFloat32 && N == 16) RWKV_WKV_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_WKV_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_WKV_CASE(float, 64);
  if (dtype == kFloat32 && N == 128) RWKV_WKV_CASE(float, 128);
  if (dtype == kBFloat16 && N == 16) RWKV_WKV_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_WKV_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_WKV_CASE(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && N == 128) RWKV_WKV_CASE(__nv_bfloat16, 128);
#undef RWKV_WKV_CASE
  return cudaErrorInvalidValue;
}
