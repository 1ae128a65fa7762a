// B.5: backward of K2 (RWKV-6 time-mix prologue: LayerNorm(ln1) + token
// shift + ddlerp).
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/ddlerp_pallas.py:166
// _prologue_bwd_kernel (launched by _prologue_bwd_pallas, :288, under the
// custom_vjp of _prologue). From the primal inputs and the six output
// cotangents (dxw, dxk, dxv, dxr, dxg, dxln; a missing one is zeros) it gives
// dx, dshift, dln_scale, dln_bias, dmaa (6, C), dw1 (C, 5D) and dw2 (5, D, C).
//
// Forward, per row (K2): xn = LN(x); prev = xn[t-1] (shift at t=0);
// xx = prev - xn; xxx = xn + xx*maa_x; h = tanh(xxx @ w1);
// m_i = h_i @ w2[i]; out_i = xn + xx*(maa_i + m_i). Adjoint per row:
//   dm_i = d_i * xx          dh_i = dm_i @ w2[i]^T      dpre = dh * (1 - h^2)
//   dxxx = dpre @ w1^T       dxx = sum_i d_i (maa_i + m_i) + dxxx * maa_x
//   dxn  = dxln + sum_i d_i + dxxx - dxx + dxx[t+1]      (dprev[t+1] = dxx[t+1])
//   dx   = LN adjoint of dxn;  dshift = dxx[t=0]
//   dmaa_{i+1} = sum_rows dm_i,  dmaa_0 = sum_rows dxxx*xx,
//   dln_scale = sum_rows dxn*xn_raw, dln_bias = sum_rows dxn,
//   dw1 = xxx^T dpre,  dw2[i] = h_i^T dm_i.
//
// Design. The TPU kernel walks the T blocks in reverse order and carries
// dprev across them in VMEM. Hopper runs blocks in no order, but the token
// shift couples only neighbouring rows, so the chain is split in two
// row-parallel kernels:
//   chain (one block per 8 rows of one sequence, as K2): recompute LN/shift/
//     ddlerp as K2 does, run the chain up to dxx and the part of dxn that is
//     local to the row (both fp32 to device memory), and write the per-block
//     partial column sums of dmaa;
//   ln (one block per 8 rows): dxn[t] = local part + dxx[t+1], the LN
//     adjoint, dshift from row 0, and per-block partials of dln_scale/bias.
// The two weight gradients, (C x BT)(BT x 5D) and five (D x BT)(BT x C), are
// products over all rows: the chain kernel saves xxx, h, dpre and dm_i
// (fp32) and a tiled A^T B kernel reduces them, one block per output tile
// walking all rows in order. Partial column sums are reduced by
// rwkv_sum_partials (csrc/wkv_fused_bwd.cu) in a fixed order. No atomics:
// two calls on the same inputs give bit-identical gradients. When the
// weights need no gradient (LoRA: K2's parameters are frozen), nothing is
// saved and only the chain and ln kernels run.
//
// Bound on the card: operations. Per row the chain costs 4 products of
// C x 5D (h, dh, dxxx, m recomputed) ~ 2.6 MFLOP, the weight products 1.3
// MFLOP more, all on the CUDA cores in fp32: ~16 GFLOP a layer at B=8,
// T=512, against ~0.3 GB moved (the saved dm_i are 168 MB fp32 there).
// Shared memory of the chain kernel: max(C8*8, 5*256*8) + 2*5D*8 + 18
// floats, 75.8 KB at C=2048, D=32, opted in above the 48 KB default.
#include "common.cuh"

namespace rwkv {

constexpr int kBwdRows = 8;        // rows of T per block (fma8 handles 8)
constexpr int kBwdThreads = 256;   // also the column chunk of the dh product
constexpr int kBwdUnroll = 8;
constexpr int kNPerThread = 2;     // columns of 5D a thread owns: 5D <= 512

__host__ __device__ inline int bwd_padded_cols(int C) {
  return (C + kBwdUnroll - 1) / kBwdUnroll * kBwdUnroll;
}

static size_t chain_smem_bytes(int C, int D) {
  const size_t big = (size_t)bwd_padded_cols(C) * kBwdRows;
  const size_t stage = (size_t)5 * kBwdThreads * kBwdRows;
  return sizeof(float) * ((big > stage ? big : stage) + 2 * (size_t)kBwdRows * 5 * D +
                          2 * (kBwdRows + 1));
}

// acc[r] += a[r] * w for the 8 values at a (16-byte aligned)
__device__ __forceinline__ void fma8(float* acc, const float* a, float w) {
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

template <typename T>
__device__ __forceinline__ float ld_or_0(const T* p, size_t i) {
  return p ? to_f(p[i]) : 0.f;
}

struct Cotangents {
  const void* d[5];   // dxw, dxk, dxv, dxr, dxg; null = zeros
  const void* dxln;
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2) prologue_bwd_chain_kernel(
    const T* __restrict__ x, const T* __restrict__ shift,
    const T* __restrict__ ln_scale, const T* __restrict__ ln_bias,
    const T* __restrict__ maa, const T* __restrict__ w1, const T* __restrict__ w1T,
    const T* __restrict__ w2, const T* __restrict__ w2T, Cotangents cts,
    float* __restrict__ dxx_out, float* __restrict__ dxnp_out,
    float* __restrict__ xxx_s, float* __restrict__ h_s, float* __restrict__ dpre_s,
    float* __restrict__ dm_s, float* __restrict__ dmaa_p, int B, int T_len, int C,
    int D, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int D5 = 5 * D;
  const int C8 = bwd_padded_cols(C);
  const size_t big = (size_t)C8 * kBwdRows > (size_t)5 * kBwdThreads * kBwdRows
                         ? (size_t)C8 * kBwdRows
                         : (size_t)5 * kBwdThreads * kBwdRows;
  float* xxxT = smem;                  // (C8, R): phases 1-2
  float* stage = smem;                 // (5, 256, R): phase 3, same memory
  float* hT = smem + big;              // (5D, R)
  float* dpreT = hT + kBwdRows * D5;   // (5D, R)
  float* stats = dpreT + kBwdRows * D5;   // (R + 1, 2): mu, rstd
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBwdRows;
  const int blk = b * gridDim.x + blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xb = x + (size_t)b * T_len * C;
  const size_t plane = (size_t)B * T_len * C;
  const size_t row0 = (size_t)b * T_len + t0;   // global row of slot 1
  const T* d[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) d[i] = static_cast<const T*>(cts.d[i]);
  const T* dxln = static_cast<const T*>(cts.dxln);

  // phase 0: LayerNorm statistics of rows t0-1 .. t0+R-1 (slot s = row t0-1+s)
  for (int s = warp; s <= kBwdRows; s += kBwdThreads / 32) {
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

  auto xn_at = [&](int s, int c, float sc, float bi) -> float {
    const int t = t0 - 1 + s;
    if (t < 0) return to_f(shift[(size_t)b * C + c]);
    if (t >= T_len) return 0.f;
    return fmaf((to_f(xb[(size_t)t * C + c]) - stats[2 * s]) * stats[2 * s + 1], sc, bi);
  };
  // xn and xx of the tile's rows at column c
  auto rows_at = [&](int c, float* xn, float* xx) {
    const float sc = to_f(ln_scale[c]), bi = to_f(ln_bias[c]);
    float prev = xn_at(0, c, sc, bi);
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      xn[r] = xn_at(r + 1, c, sc, bi);
      xx[r] = prev - xn[r];
      prev = xn[r];
    }
  };
  auto valid = [&](int r) { return t0 + r < T_len; };

  // phase 1: xxx of the tile, transposed; saved for dw1
  for (int c = threadIdx.x; c < C8; c += kBwdThreads) {
    if (c >= C) {
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) xxxT[(size_t)c * kBwdRows + r] = 0.f;
      continue;
    }
    float xn[kBwdRows], xx[kBwdRows];
    rows_at(c, xn, xx);
    const float mx = to_f(maa[c]);
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float v = fmaf(xx[r], mx, xn[r]);
      xxxT[(size_t)c * kBwdRows + r] = v;
      if (xxx_s && valid(r)) xxx_s[(row0 + r) * C + c] = v;
    }
  }
  __syncthreads();

  // phase 2: h = tanh(xxx @ w1), one thread per column n of 5D
  for (int n = threadIdx.x; n < D5; n += kBwdThreads) {
    float acc[kBwdRows];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < C8; c0 += kBwdUnroll) {
      float wv[kBwdUnroll];
#pragma unroll
      for (int q = 0; q < kBwdUnroll; ++q)
        wv[q] = c0 + q < C ? to_f(w1[(size_t)(c0 + q) * D5 + n]) : 0.f;
#pragma unroll
      for (int q = 0; q < kBwdUnroll; ++q) fma8(acc, xxxT + (size_t)(c0 + q) * kBwdRows, wv[q]);
    }
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float hv = tanhf(acc[r]);
      hT[n * kBwdRows + r] = hv;
      if (h_s && valid(r)) h_s[(row0 + r) * D5 + n] = hv;
    }
  }
  __syncthreads();   // xxxT is dead from here: phase 3 reuses it as the stage

  // phase 3: dh[r, n] = sum_c dm_i[r, c] w2[i][d][c] (n = i*D + d), over
  // column chunks of 256 staged in shared memory; dm_i and the dmaa_{1..5}
  // partials are written on the way
  // thread owns columns n = threadIdx.x + q * 256 (q < kNPerThread) of 5D
  float dh[kNPerThread][kBwdRows];
#pragma unroll
  for (int q = 0; q < kNPerThread; ++q)
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) dh[q][r] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kBwdThreads) {
    const int c = c0 + threadIdx.x;
    if (c < C) {
      float xn[kBwdRows], xx[kBwdRows];
      rows_at(c, xn, xx);
      for (int i = 0; i < 5; ++i) {
        float colsum = 0.f;
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          const float dm = valid(r) ? ld_or_0(d[i], (row0 + r) * C + c) * xx[r] : 0.f;
          stage[((size_t)i * kBwdThreads + threadIdx.x) * kBwdRows + r] = dm;
          colsum += dm;
          if (dm_s && valid(r)) dm_s[i * plane + (row0 + r) * C + c] = dm;
        }
        if (dmaa_p) dmaa_p[((size_t)blk * 6 + i + 1) * C + c] = colsum;
      }
    } else {
      for (int i = 0; i < 5; ++i)
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r)
          stage[((size_t)i * kBwdThreads + threadIdx.x) * kBwdRows + r] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kNPerThread; ++q) {
      const int n = threadIdx.x + q * kBwdThreads;
      if (n >= D5) break;
      const float* st = stage + (size_t)(n / D) * kBwdThreads * kBwdRows;
      const int cn = min(kBwdThreads, C - c0);
      int cc = 0;
      for (; cc + kBwdUnroll <= cn; cc += kBwdUnroll) {
        float wv[kBwdUnroll];
#pragma unroll
        for (int p = 0; p < kBwdUnroll; ++p) wv[p] = to_f(w2T[(size_t)(c0 + cc + p) * D5 + n]);
#pragma unroll
        for (int p = 0; p < kBwdUnroll; ++p) fma8(dh[q], st + (size_t)(cc + p) * kBwdRows, wv[p]);
      }
      for (; cc < cn; ++cc)
        fma8(dh[q], st + (size_t)cc * kBwdRows, to_f(w2T[(size_t)(c0 + cc) * D5 + n]));
    }
    __syncthreads();
  }

  // phase 4: dpre = dh * (1 - h^2); saved for dw1
#pragma unroll
  for (int q = 0; q < kNPerThread; ++q) {
    const int n = threadIdx.x + q * kBwdThreads;
    if (n >= D5) break;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float hv = hT[n * kBwdRows + r];
      const float dp = dh[q][r] * (1.f - hv * hv);
      dpreT[n * kBwdRows + r] = dp;
      if (dpre_s && valid(r)) dpre_s[(row0 + r) * D5 + n] = dp;
    }
  }
  __syncthreads();

  // phase 5: per column, dxxx = dpre @ w1^T, m_i recomputed, then dxx and
  // the row-local part of dxn
  for (int c = threadIdx.x; c < C; c += kBwdThreads) {
    float xn[kBwdRows], xx[kBwdRows];
    rows_at(c, xn, xx);
    float dxxx[kBwdRows];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) dxxx[r] = 0.f;
    for (int n0 = 0; n0 < D5; n0 += kBwdUnroll) {   // D5 % 8 == 0
      float wv[kBwdUnroll];
#pragma unroll
      for (int q = 0; q < kBwdUnroll; ++q) wv[q] = to_f(w1T[(size_t)(n0 + q) * C + c]);
#pragma unroll
      for (int q = 0; q < kBwdUnroll; ++q) fma8(dxxx, dpreT + (size_t)(n0 + q) * kBwdRows, wv[q]);
    }
    const float mx = to_f(maa[c]);
    float dxx[kBwdRows], dxn[kBwdRows];
    float col0 = 0.f;
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      dxx[r] = dxxx[r] * mx;
      dxn[r] = valid(r) ? ld_or_0(dxln, (row0 + r) * C + c) + dxxx[r] : 0.f;
      col0 = fmaf(dxxx[r], xx[r], col0);
    }
    for (int i = 0; i < 5; ++i) {
      float m[kBwdRows];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) m[r] = 0.f;
      const T* w2i = w2 + (size_t)i * D * C + c;
      const float* hi = hT + (size_t)i * D * kBwdRows;
      for (int d0 = 0; d0 < D; d0 += kBwdUnroll) {   // D % 8 == 0
        float wv[kBwdUnroll];
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) wv[q] = to_f(w2i[(size_t)(d0 + q) * C]);
#pragma unroll
        for (int q = 0; q < kBwdUnroll; ++q) fma8(m, hi + (size_t)(d0 + q) * kBwdRows, wv[q]);
      }
      const float mi = to_f(maa[(size_t)(i + 1) * C + c]);
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const float di = valid(r) ? ld_or_0(d[i], (row0 + r) * C + c) : 0.f;
        dxx[r] = fmaf(di, mi + m[r], dxx[r]);
        dxn[r] += di;
      }
    }
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      if (valid(r)) {
        dxx_out[(row0 + r) * C + c] = dxx[r];
        dxnp_out[(row0 + r) * C + c] = dxn[r] - dxx[r];
      }
    }
    if (dmaa_p) dmaa_p[(size_t)blk * 6 * C + c] = col0;
  }
}

// dxn[t] = dxnp[t] + dxx[t+1]; LayerNorm adjoint; dshift; dln partials
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) prologue_bwd_ln_kernel(
    const T* __restrict__ x, const T* __restrict__ ln_scale,
    const float* __restrict__ dxx, const float* __restrict__ dxnp, T* __restrict__ dx,
    float* __restrict__ dshift, float* __restrict__ dln_p, int T_len, int C, float eps) {
  __shared__ float red[4][kBwdThreads / 32];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBwdRows;
  const int blk = b * gridDim.x + blockIdx.x;
  if (t0 == 0)
    for (int c = threadIdx.x; c < C; c += kBwdThreads)
      dshift[(size_t)b * C + c] = dxx[(size_t)b * T_len * C + c];
  if (dln_p)   // each thread zeroes the columns it accumulates below
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      dln_p[(size_t)blk * 2 * C + c] = 0.f;
      dln_p[(size_t)blk * 2 * C + C + c] = 0.f;
    }
  for (int r = 0; r < kBwdRows && t0 + r < T_len; ++r) {
    const int t = t0 + r;
    const size_t row = ((size_t)b * T_len + t) * C;
    const bool has_next = t + 1 < T_len;
    float a = 0.f, a2 = 0.f;
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      const float vv = to_f(x[row + c]);
      a += vv;
      a2 = fmaf(vv, vv, a2);
    }
    const float mu = block_sum_nowait(a, red[0]) / C;
    const float rstd = rsqrtf(fmaxf(block_sum_nowait(a2, red[1]) / C - mu * mu, 0.f) + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      const float xr = (to_f(x[row + c]) - mu) * rstd;
      const float dxn = dxnp[row + c] + (has_next ? dxx[row + C + c] : 0.f);
      const float dxnr = dxn * to_f(ln_scale[c]);
      s1 += dxnr;
      s2 = fmaf(dxnr, xr, s2);
      if (dln_p) {
        dln_p[(size_t)blk * 2 * C + c] += dxn * xr;
        dln_p[(size_t)blk * 2 * C + C + c] += dxn;
      }
    }
    const float m1 = block_sum_nowait(s1, red[2]) / C;
    const float m2 = block_sum(s2, red[3]) / C;   // trailing barrier: red is reused next row
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      const float xr = (to_f(x[row + c]) - mu) * rstd;
      const float dxn = dxnp[row + c] + (has_next ? dxx[row + C + c] : 0.f);
      const float dxnr = dxn * to_f(ln_scale[c]);
      dx[row + c] = from_f<T>(rstd * (dxnr - m1 - xr * m2));
    }
  }
}

// out[z][m][n] = sum_k X[z][k][m] * Y[z][k][n] (row-major X (K, ldx), Y (K,
// ldy), out (M, ldo)); one block per 64 x 64 output tile walks all K in
// order, 256 threads with 4 x 4 outputs each
constexpr int kTile = 64, kTileK = 16;

__global__ void __launch_bounds__(256) atb_kernel(
    const float* __restrict__ X, int ldx, long long sx, const float* __restrict__ Y, int ldy,
    long long sy, float* __restrict__ out, int ldo, long long so, int M, int Nn, int K) {
  __shared__ __align__(16) float Xs[kTileK][kTile];
  __shared__ __align__(16) float Ys[kTileK][kTile];
  X += blockIdx.z * sx;
  Y += blockIdx.z * sy;
  out += blockIdx.z * so;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * kTile; e += 256) {
      const int kk = e / kTile, mm = e % kTile;
      const int kg = k0 + kk;
      Xs[kk][mm] = (kg < K && m0 + mm < M) ? X[(size_t)kg * ldx + m0 + mm] : 0.f;
      Ys[kk][mm] = (kg < K && n0 + mm < Nn) ? Y[(size_t)kg * ldy + n0 + mm] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 ya = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
      const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
      const float yv[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(xv[p], yv[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + ty * 4 + p, n = n0 + tx * 4 + q;
      if (m < M && n < Nn) out[(size_t)m * ldo + n] = acc[p][q];
    }
}

static cudaError_t launch_atb(const float* X, int ldx, long long sx, const float* Y, int ldy,
                              long long sy, float* out, int ldo, long long so, int M, int Nn,
                              int K, int batch, cudaStream_t s) {
  dim3 grid((Nn + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch);
  atb_kernel<<<grid, 256, 0, s>>>(X, ldx, sx, Y, ldy, sy, out, ldo, so, M, Nn, K);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_prologue_bwd(const void* const* in, Cotangents cts,
                                       void* const* out, void* const* scratch, int B,
                                       int T_len, int C, int D, float eps,
                                       cudaStream_t s) {
  const T* x = static_cast<const T*>(in[0]);
  const T* shift = static_cast<const T*>(in[1]);
  const T* ln_scale = static_cast<const T*>(in[2]);
  const T* ln_bias = static_cast<const T*>(in[3]);
  const T* maa = static_cast<const T*>(in[4]);
  const T* w1 = static_cast<const T*>(in[5]);
  const T* w1T = static_cast<const T*>(in[6]);
  const T* w2 = static_cast<const T*>(in[7]);
  const T* w2T = static_cast<const T*>(in[8]);
  T* dx = static_cast<T*>(out[0]);
  float* dshift = static_cast<float*>(out[1]);
  float* dw1 = static_cast<float*>(out[2]);     // null: no weight gradients
  float* dw2 = static_cast<float*>(out[3]);
  float* dxx = static_cast<float*>(scratch[0]);
  float* dxnp = static_cast<float*>(scratch[1]);
  float* xxx_s = static_cast<float*>(scratch[2]);
  float* h_s = static_cast<float*>(scratch[3]);
  float* dpre_s = static_cast<float*>(scratch[4]);
  float* dm_s = static_cast<float*>(scratch[5]);
  float* dmaa_p = static_cast<float*>(scratch[6]);
  float* dln_p = static_cast<float*>(scratch[7]);
  const int D5 = 5 * D;
  const size_t smem = chain_smem_bytes(C, D);
  cudaError_t e = cudaFuncSetAttribute(prologue_bwd_chain_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kBwdRows - 1) / kBwdRows, B);
  prologue_bwd_chain_kernel<T><<<grid, kBwdThreads, smem, s>>>(
      x, shift, ln_scale, ln_bias, maa, w1, w1T, w2, w2T, cts, dxx, dxnp, xxx_s, h_s, dpre_s,
      dm_s, dmaa_p, B, T_len, C, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  prologue_bwd_ln_kernel<T><<<grid, kBwdThreads, 0, s>>>(x, ln_scale, dxx, dxnp, dx, dshift,
                                                         dln_p, T_len, C, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (dw1 == nullptr) return cudaSuccess;
  const int K = B * T_len;
  // dw1 (C, 5D) = xxx^T dpre
  if ((e = launch_atb(xxx_s, C, 0, dpre_s, D5, 0, dw1, D5, 0, C, D5, K, 1, s)) != cudaSuccess)
    return e;
  // dw2[i] (D, C) = h_i^T dm_i
  return launch_atb(h_s, D5, D, dm_s, C, (long long)K * C, dw2, C, (long long)D * C, D, C, K,
                    5, s);
}

}  // namespace rwkv

// Dynamic shared memory of the chain kernel at (C, D); the wrapper checks it
// against the card's opt-in limit before launching.
extern "C" long long rwkv_tmix_prologue_bwd_smem_bytes(int C, int D) {
  return (long long)rwkv::chain_smem_bytes(C, D);
}

// in: x, shift, ln_scale, ln_bias, maa, w1, w1T (5D, C), w2, w2T (C, 5D), all
//   of `dtype`; d0..d4, dxln: cotangents of `dtype`, each may be null;
// out: dx (dtype), dshift (B, C) fp32, dw1 (C, 5D) fp32, dw2 (5, D, C) fp32;
// scratch (fp32): dxx, dxnp (B*T, C); xxx (B*T, C), h, dpre (B*T, 5D),
//   dm (5, B*T, C), dmaa partials (n_blocks, 6, C), dln partials
//   (n_blocks, 2, C), n_blocks = B * ceil(T / 8). dw1, dw2 and the xxx, h,
//   dpre, dm and dmaa scratch are null together when no weight gradient is
//   wanted; the dln partials may be null on their own.
extern "C" int rwkv_tmix_prologue_bwd(const void* x, const void* shift, const void* ln_scale,
                                      const void* ln_bias, const void* maa, const void* w1,
                                      const void* w1T, const void* w2, const void* w2T,
                                      const void* d0, const void* d1, const void* d2,
                                      const void* d3, const void* d4, const void* dxln,
                                      void* dx, void* dshift, void* dw1, void* dw2, void* dxx,
                                      void* dxnp, void* xxx_s, void* h_s, void* dpre_s,
                                      void* dm_s, void* dmaa_p, void* dln_p, int B, int T_len,
                                      int C, int D, float eps, int dtype, void* stream) {
  using namespace rwkv;
  if (D <= 0 || D % kBwdUnroll != 0) return cudaErrorInvalidValue;
  if (B <= 0 || T_len <= 0 || C <= 0) return cudaSuccess;
  const bool w_on = dw1 != nullptr;
  if (w_on != (dw2 != nullptr) || w_on != (xxx_s != nullptr) || w_on != (h_s != nullptr) ||
      w_on != (dpre_s != nullptr) || w_on != (dm_s != nullptr) || w_on != (dmaa_p != nullptr))
    return cudaErrorInvalidValue;
  const void* in[9] = {x, shift, ln_scale, ln_bias, maa, w1, w1T, w2, w2T};
  Cotangents cts{{d0, d1, d2, d3, d4}, dxln};
  void* out[4] = {dx, dshift, dw1, dw2};
  void* scratch[8] = {dxx, dxnp, xxx_s, h_s, dpre_s, dm_s, dmaa_p, dln_p};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_prologue_bwd<float>(in, cts, out, scratch, B, T_len, C, D, eps, s);
    case kBFloat16:
      return launch_prologue_bwd<__nv_bfloat16>(in, cts, out, scratch, B, T_len, C, D, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
