// K2: RWKV-6 time-mix prologue: LayerNorm(ln1) + token shift + ddlerp.
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/ddlerp_pallas.py:35
// _prologue_kernel (launched by _prologue_impl under tmix_prologue). For each
// row t of x (B,T,C):
//   xn   = LayerNorm(x[t])                        (fp32 statistics, eps)
//   prev = xn[t-1], or shift_ln[b] at t = 0       (shift_ln is already ln'd)
//   xx   = prev - xn;  xxx = xn + xx * maa_x
//   h    = tanh(xxx @ w1)                         (C -> 5D)
//   m_i  = h[:, iD:(i+1)D] @ w2[i]                (D -> C), i = w, k, v, r, g
//   out_i = xn + xx * (maa_i + m_i)
// and writes xw, xk, xv, xr, xg and xn into one (6,B,T,C) buffer.
//
// Design: the TPU kernel walked T blocks in order and carried the previous
// block's last ln'd row in scratch. Hopper runs blocks in no order, so the
// block owning rows [t0, t0 + kRows) recomputes the LayerNorm of row t0 - 1
// itself (or takes shift_ln at t0 = 0), as the Pallas backward already does.
// Per block: LayerNorm statistics of kRows + 1 rows (one warp per row), xxx
// for the tile kept transposed in shared memory ((C, kRows) fp32, so one
// float4 pair feeds all rows of a column), the C -> 5D product with one
// thread per output column, h kept transposed the same way, then the
// 5D -> C products and the five lerps with threads striding over C. Both
// low-rank products accumulate in fp32 on the CUDA cores; w1 and w2 (0.65 MB
// each in bf16 at C=2048, D=32) are read from L2 by every block, kUnroll
// loads at a time so that their latencies overlap.
//
// Bound on the card: operations. 4 * C * 5D ~ 1.3 MFLOP a token, 43 GFLOP a
// layer at B=64, T=512, C=2048, D=32, against 0.4 GB of activations moved;
// without tensor cores this version is limited by CUDA-core FMA issue.
// Shared memory is (C8 * kRows + kRows * 5D + 2 * (kRows + 1)) floats, C8 =
// C rounded up to kUnroll: 70.7 KB at C=2048, D=32, opted in above the 48 KB
// default.
#include "common.cuh"

namespace rwkv {

constexpr int kRows = 8;          // rows of T per block
constexpr int kPrologueThreads = 256;
constexpr int kUnroll = 8;        // loads issued together in the product loops
static_assert(kRows == 8, "fma_rows handles exactly 8 rows");

// the transposed xxx is padded with zero columns to a multiple of kUnroll
__host__ __device__ inline int padded_cols(int C) {
  return (C + kUnroll - 1) / kUnroll * kUnroll;
}

static size_t prologue_smem_bytes(int C, int D) {
  return sizeof(float) *
         ((size_t)padded_cols(C) * kRows + (size_t)kRows * 5 * D + 2 * (kRows + 1));
}

// acc[r] += a[r] * w for the kRows values at a (16-byte aligned)
__device__ __forceinline__ void fma_rows(float* acc, const float* a, float w) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  acc[0] = fmaf(a0.x, w, acc[0]);
  acc[1] = fmaf(a0.y, w, acc[1]);
  acc[2] = fmaf(a0.z, w, acc[2]);
  acc[3] = fmaf(a0.w, w, acc[3]);
  acc[4] = fmaf(a1.x, w, acc[4]);
  acc[5] = fmaf(a1.y, w, acc[5]);
  acc[6] = fmaf(a1.z, w, acc[6]);
  acc[7] = fmaf(a1.w, w, acc[7]);
}

// min 3 blocks an SM: three 70.7 KB tiles fit its shared memory, and the
// register cap this implies (<= 85) measured 12 % faster than 2 blocks at 99
// registers on an H100 80GB HBM3 at 700 W
template <typename T>
__global__ void __launch_bounds__(kPrologueThreads, 3) tmix_prologue_kernel(
    const T* __restrict__ x, const T* __restrict__ shift,
    const T* __restrict__ ln_scale, const T* __restrict__ ln_bias,
    const T* __restrict__ maa, const T* __restrict__ w1,
    const T* __restrict__ w2, T* __restrict__ out, int B, int T_len, int C,
    int D, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int D5 = 5 * D;
  const int C8 = padded_cols(C);
  float* xxxT = smem;                        // (C8, kRows)
  float* hT = xxxT + (size_t)C8 * kRows;     // (5D, kRows)
  float* stats = hT + kRows * D5;            // (kRows + 1, 2): mu, rstd
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xb = x + (size_t)b * T_len * C;

  // LayerNorm statistics of rows t0-1 .. t0+kRows-1 (slot s is row t0-1+s)
  for (int s = warp; s <= kRows; s += kPrologueThreads / 32) {
    const int t = t0 - 1 + s;
    float mu = 0.f, rstd = 0.f;
    if (t >= 0 && t < T_len) {
      const T* xr = xb + (size_t)t * C;
      float a = 0.f, a2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float vv = to_f(xr[c]);
        a += vv;
        a2 = fmaf(vv, vv, a2);
      }
      a = warp_sum(a);
      a2 = warp_sum(a2);
      mu = a / C;
      rstd = rsqrtf(fmaxf(a2 / C - mu * mu, 0.f) + eps);
    }
    if (lane == 0) {
      stats[2 * s] = mu;
      stats[2 * s + 1] = rstd;
    }
  }
  __syncthreads();

  // ln'd value of slot s at column c; slot 0 of the first tile is the shift
  // row, rows past T read as 0 (their outputs are never written)
  auto xn_at = [&](int s, int c, float sc, float bi) -> float {
    const int t = t0 - 1 + s;
    if (t < 0) return to_f(shift[(size_t)b * C + c]);
    if (t >= T_len) return 0.f;
    return fmaf((to_f(xb[(size_t)t * C + c]) - stats[2 * s]) * stats[2 * s + 1], sc, bi);
  };

  // xxx of the tile, transposed; padding columns are 0
  for (int c = threadIdx.x; c < C8; c += kPrologueThreads) {
    if (c >= C) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) xxxT[(size_t)c * kRows + r] = 0.f;
      continue;
    }
    const float sc = to_f(ln_scale[c]), bi = to_f(ln_bias[c]);
    const float mx = to_f(maa[c]);
    float prev = xn_at(0, c, sc, bi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float cur = xn_at(r + 1, c, sc, bi);
      xxxT[(size_t)c * kRows + r] = fmaf(prev - cur, mx, cur);
      prev = cur;
    }
  }
  __syncthreads();

  // h = tanh(xxx @ w1): one thread per output column; kUnroll w1 loads
  // (L2 hits) are issued before their FMAs so their latencies overlap
  for (int n = threadIdx.x; n < D5; n += kPrologueThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < C8; c0 += kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wv[u] = c0 + u < C ? to_f(w1[(size_t)(c0 + u) * D5 + n]) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* a = xxxT + (size_t)(c0 + u) * kRows;
        fma_rows(acc, a, wv[u]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) hT[n * kRows + r] = tanhf(acc[r]);
  }
  __syncthreads();

  // m_i = h_i @ w2[i] and the five lerps, threads striding over C
  const size_t plane = (size_t)B * T_len * C;
  const size_t row0 = ((size_t)b * T_len + t0) * C;
  for (int c = threadIdx.x; c < C; c += kPrologueThreads) {
    const float sc = to_f(ln_scale[c]), bi = to_f(ln_bias[c]);
    float xn[kRows], xx[kRows];
    float prev = xn_at(0, c, sc, bi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xn[r] = xn_at(r + 1, c, sc, bi);
      xx[r] = prev - xn[r];
      prev = xn[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (t0 + r < T_len) out[5 * plane + row0 + (size_t)r * C + c] = from_f<T>(xn[r]);
    for (int i = 0; i < 5; ++i) {
      float m[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) m[r] = 0.f;
      const T* w2i = w2 + (size_t)i * D * C + c;
      const float* hi = hT + (size_t)i * D * kRows;
      for (int d0 = 0; d0 < D; d0 += kUnroll) {   // D % kUnroll == 0
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) wv[u] = to_f(w2i[(size_t)(d0 + u) * C]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma_rows(m, hi + (size_t)(d0 + u) * kRows, wv[u]);
      }
      const float mi = to_f(maa[(size_t)(i + 1) * C + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (t0 + r < T_len)
          out[i * plane + row0 + (size_t)r * C + c] = from_f<T>(fmaf(xx[r], mi + m[r], xn[r]));
    }
  }
}

template <typename T>
static cudaError_t launch_prologue(const void* x, const void* shift,
                                   const void* ln_scale, const void* ln_bias,
                                   const void* maa, const void* w1,
                                   const void* w2, void* out, int B, int T_len,
                                   int C, int D, float eps,
                                   cudaStream_t stream) {
  const size_t smem = prologue_smem_bytes(C, D);
  cudaError_t e = cudaFuncSetAttribute(
      tmix_prologue_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kRows - 1) / kRows, B);
  tmix_prologue_kernel<T><<<grid, kPrologueThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<const T*>(maa), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), B, T_len, C, D, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

// Dynamic shared memory one block needs at (C, D); the wrapper checks it
// against the card's opt-in limit before launching.
extern "C" long long rwkv_tmix_prologue_smem_bytes(int C, int D) {
  return (long long)rwkv::prologue_smem_bytes(C, D);
}

extern "C" int rwkv_tmix_prologue(const void* x, const void* shift,
                                  const void* ln_scale, const void* ln_bias,
                                  const void* maa, const void* w1,
                                  const void* w2, void* out, int B, int T_len,
                                  int C, int D, float eps, int dtype,
                                  void* stream) {
  using namespace rwkv;
  if (D <= 0 || D % kUnroll != 0) return cudaErrorInvalidValue;
  if (B <= 0 || T_len <= 0 || C <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_prologue<float>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, D, eps, s);
    case kBFloat16:
      return launch_prologue<__nv_bfloat16>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, D, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
