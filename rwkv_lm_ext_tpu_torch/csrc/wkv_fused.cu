// K1: RWKV-6 WKV recurrence + per-head GroupNorm(ln_x) + gate, forward.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/wkv_pallas.py:743
// _wkv_gn_kernel (launched by _fused_impl under wkv6_fused_output). Same
// contract: r, k, v, g (B,T,H,N), w (B,T,H,N) fp32 log-decay, u (H,N),
// ln_x scale/bias (H*N), initial state s0 (B,H,N,N) fp32 in (K,V) layout ->
// gated output (B,T,H*N) in g's dtype and the final state (B,H,N,N) fp32.
//
// What it computes per (b, h) and step t (ops/wkv_reference.py:58-67), with
// d_t = -exp(w_t) per channel i:
//   y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//   S_ij = S_ij * exp(d_i) + k_i v_j
//   out  = (GroupNorm_head(y) * scale + bias) * g
//
// Bound on the card: bytes. At B=64, T=512, H=32, N=64 one call moves four
// bf16 and one fp32 (B,T,H,N) inputs, the output and two states, 0.30 ms at
// 3.35 TB/s; its products are 17 GFLOP, nothing on the tensor cores. The
// first version walked T step by step (512 dependent steps, three block
// barriers each) and took six times that: the chain set the pace.
//
// Two bodies; the wrapper (ops/wkv_fused.py) picks one from the dtype.
//
// Chunked body (bf16), wkv6_chunked_kernel: chunks of kL = 16 steps. With
// c_t = d_0 + .. + d_{t-1} inside the chunk (c_0 = 0, c_L the whole chunk):
//   y_t  = (r_t * exp(c_t)) @ S  +  sum_{s<t} A[t,s] v_s  +  (r_t . u k_t) v_t
//   A[t,s] = sum_i r_ti k_si exp(c_t,i - c_{s+1},i)
//   S   <- diag(exp(c_L)) S + sum_s (k_s * exp(c_L - c_{s+1}))^T v_s
// Every exponent is a sum of d's, so never positive: no factor overflows at
// any decay (the usual r e^{c}, k e^{-c} factoring does at w ~ +3), and an
// underflow to 0 is the true value to fp32. The TPU kernel needed its dyadic
// exact-A cascade for this; here A is made on the CUDA cores, and without an
// exponential: for a column s the factor exp(c_t - c_{s+1}) is the running
// product of exp(d_{s+1}) .. exp(d_{t-1}), so a thread walks t with
// q <- q exp(d_t) from q = k_s (the recurrence itself, on vectors instead of
// the state). Columns s and kL - 2 - s have kL steps together, so every
// thread does the same work; the partial sums over 4-channel slices are
// added in a fixed order. The formulas hold for any chunk length and a ragged
// last chunk is masked (d = 0, r = k = v = 0).
//   * One block of 2N threads per (b, h). Warp m keeps rows j in [16m, 16m+16)
//     of the TRANSPOSED state S^T[j][i] as fp32 mma accumulators for the whole
//     sequence. The update S^T += V^T (k scaled) accumulates straight into
//     them, and because an accumulator tile has the layout of an A operand,
//     y^T = S^T (r scaled)^T reads the state from the same registers: the
//     state never visits shared memory, and every warp owns its 16 outputs j
//     of all 16 steps, so no sum crosses warps.
//   * Precision. The state and all sums are fp32. Operands that are not
//     exact in bf16 go to the tensor cores as two bf16 limbs (hi + lo, about
//     16 bits): the state and r exp(c) (three products hi hi, hi lo, lo hi),
//     the scaled k and A (two products against v, which is exact). The
//     factors of r and k are exponentials of running sums of d, forward for
//     r, backward for k: no difference of two prefix sums, nothing cancels.
//   * r, k, v, g, w of the next chunk arrive by cp.async while this one is
//     computed (two stages). GroupNorm and the gate run on 16 rows at once,
//     16 bytes of output a thread.
//   * Five barriers a chunk instead of three a step.
//
// Sequential body (fp32), wkv6_sequential_kernel: the first version, the
// plain recurrence on fp32 FMAs, one thread per state column. It keeps the
// fp32 instantiation within 1e-4 of the plain version, and it is the body of
// the head sizes the chunked one does not take (16 and 128, in either
// dtype): at N = 128 a thread's column is 128 floats of registers under
// __launch_bounds__(128). Neither body needs the JAX package's exact/rescale
// dispatch.
#include "wkv_chunk.cuh"

namespace rwkv {

// ------------------------------------------------------------------------
// Sequential body. One block per (b, h) with N threads; thread j keeps column
// S[:, j] in registers for the whole sequence. Per step the block stages r,
// k, exp(-exp(w)) and u*k in shared memory, each thread forms y_j, and the
// GroupNorm statistics are two block reductions.
// ------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_sequential_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const T* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ sT, int T_len, int H, float eps) {
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
static cudaError_t launch_sequential(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* g,
                               const void* scale, const void* bias,
                               const void* s0, void* out, void* sT, int B,
                               int T_len, int H, float eps,
                               cudaStream_t stream) {
  wkv6_sequential_kernel<T, N><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const T*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s0), static_cast<T*>(out),
      static_cast<float*>(sT), T_len, H, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Chunked body: the walk over the chunks is chunk_walk (wkv_chunk.cuh), which
// pass 1 of the backward (wkv_fused_bwd.cu) runs too; K1 takes its output
// mode, the gated output and the final state.
// ------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(2 * N, 4) wkv6_chunked_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const bf16* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    bf16* __restrict__ out, float* __restrict__ sT, int T_len, int H, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_walk<N, kChunkOutput>(r, k, v, w, u, g, scale, bias, s0, nullptr, nullptr, out, sT,
                              nullptr, nullptr, nullptr, nullptr, nullptr, T_len, H, eps, 0, smem);
}

template <int N>
static cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* g, const void* scale,
                                  const void* bias, const void* s0, void* out, void* sT, int B,
                                  int T_len, int H, float eps, cudaStream_t stream) {
  constexpr int smem = ChunkLayout<N, kChunkOutput>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_chunked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_chunked_kernel<N><<<B * H, 2 * N, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const bf16*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s0), static_cast<bf16*>(out), static_cast<float*>(sT), T_len, H,
      eps);
  return cudaGetLastError();
}

}  // namespace rwkv

// body codes shared with ops/wkv_fused.py
enum { kBodySequential = 0, kBodyChunked = 1 };

// steps a chunk of the chunked body takes
extern "C" long long rwkv_wkv6_fused_chunk() { return rwkv::kL; }

// blocks of the chunked body that one SM holds at head size N (registers and
// shared memory decide), or a negative CUDA error code
extern "C" long long rwkv_wkv6_fused_blocks_per_sm(int N) {
  using namespace rwkv;
  int blocks = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (N == 64) {
    e = cudaFuncSetAttribute(wkv6_chunked_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ChunkLayout<64, kChunkOutput>::kBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_chunked_kernel<64>, 128,
                                                        ChunkLayout<64, kChunkOutput>::kBytes);
  } else if (N == 32) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_chunked_kernel<32>, 64,
                                                      ChunkLayout<32, kChunkOutput>::kBytes);
  }
  return e == cudaSuccess ? blocks : -(long long)e;
}

extern "C" int rwkv_wkv6_fused(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* g,
                               const void* scale, const void* bias,
                               const void* s0, void* out, void* sT, int B,
                               int T_len, int H, int N, float eps, int dtype,
                               int body, void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (body == kBodyChunked) {
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    if (N == 32) return launch_chunked<32>(r, k, v, w, u, g, scale, bias, s0, out, sT, B, T_len, H, eps, s);
    if (N == 64) return launch_chunked<64>(r, k, v, w, u, g, scale, bias, s0, out, sT, B, T_len, H, eps, s);
    return cudaErrorInvalidValue;
  }
  if (body != kBodySequential) return cudaErrorInvalidValue;
#define RWKV_WKV6_CASE(TYPE, NN) \
  return launch_sequential<TYPE, NN>(r, k, v, w, u, g, scale, bias, s0, out, sT, B, T_len, H, eps, s)
  if (dtype == kFloat32 && N == 16) RWKV_WKV6_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_WKV6_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_WKV6_CASE(float, 64);
  if (dtype == kFloat32 && N == 128) RWKV_WKV6_CASE(float, 128);
  if (dtype == kBFloat16 && N == 16) RWKV_WKV6_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_WKV6_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_WKV6_CASE(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && N == 128) RWKV_WKV6_CASE(__nv_bfloat16, 128);
#undef RWKV_WKV6_CASE
  return cudaErrorInvalidValue;
}
