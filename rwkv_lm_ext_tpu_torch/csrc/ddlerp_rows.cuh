// The rows of a tile of K2's tensor-core body (ddlerp.cu) and of its backward
// B.5 (ddlerp_bwd.cu): a tile holds flattened rows b*T + t, and each row is
// mixed with its predecessor (the row before, or shift_ln[b] at t = 0, which
// is already LayerNorm'd). The tile keeps the LayerNorm statistics of its
// rows and of the row before its first in shared memory: slot s holds row
// m0 - 1 + s as (mu, rstd).
#pragma once

#include "mma.cuh"

namespace rwkv {

typedef __nv_bfloat16 bf16;

// What a thread keeps of one row it mixes: where the row and its predecessor
// are, and their LayerNorm statistics (the shift row is taken as it is).
struct RowRef {
  const bf16* cur;
  const bf16* prev;
  float mu, rstd, pmu, prstd;
  bool valid, prev_is_shift;
};

__device__ __forceinline__ RowRef make_row(const bf16* x, const bf16* shift, const float* stats,
                                           int m0, int r, int M, int T_len, int C) {
  RowRef ref;
  const int m = m0 + r;
  ref.valid = m < M;
  const int mm = ref.valid ? m : 0;
  const int b = mm / T_len;
  ref.prev_is_shift = mm - b * T_len == 0;
  ref.cur = x + (size_t)mm * C;
  ref.prev = ref.prev_is_shift ? shift + (size_t)b * C : ref.cur - C;
  ref.mu = stats[2 * (r + 1)];
  ref.rstd = stats[2 * (r + 1) + 1];
  ref.pmu = stats[2 * r];
  ref.prstd = stats[2 * r + 1];
  return ref;
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// xn and xx = prev - xn of eight columns of a row, from the raw words
__device__ __forceinline__ void ln_pair(const RowRef& row, const uint4& xq, const uint4& pq,
                                        const float* sc, const float* bi, float* xn, float* xx) {
  float xv[8], pv[8];
  unpack8(xq, xv);
  unpack8(pq, pv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xn[j] = fmaf((xv[j] - row.mu) * row.rstd, sc[j], bi[j]);
    const float prev = row.prev_is_shift ? pv[j] : fmaf((pv[j] - row.pmu) * row.prstd, sc[j], bi[j]);
    xx[j] = prev - xn[j];
  }
}

// LayerNorm statistics of rows m0-1 .. m0+rows-1 into stats (slot s is row
// m0-1+s; rows outside [0, M) get zeros), one warp a row. The caller puts a
// block barrier after.
__device__ __forceinline__ void tile_stats(const bf16* x, float* stats, int m0, int rows, int M,
                                           int C, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int s = warp; s <= rows; s += blockDim.x / 32) {
    const int m = m0 - 1 + s;
    float mu = 0.f, rstd = 0.f;
    if (m >= 0 && m < M) {
      const bf16* xr = x + (size_t)m * C;
      float a = 0.f, a2 = 0.f;
      // eight loads in flight a lane: a row of C = 2048 is one round
      for (int c0 = lane * 8; c0 < C; c0 += 8 * 256) {
        uint4 q[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) q[u] = c0 + u * 256 < C ? ldg16(xr + c0 + u * 256) : zero4;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float v[8];
          unpack8(q[u], v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            a += v[j];
            a2 = fmaf(v[j], v[j], a2);
          }
        }
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
}

}  // namespace rwkv
