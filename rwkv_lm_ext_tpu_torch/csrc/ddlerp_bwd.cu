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
// The TPU kernel walks the T blocks in reverse order and carries dprev
// across them in VMEM. Hopper runs blocks in no order, but the token shift
// couples only neighbouring rows of one sequence.
//
// Bound on the card: bytes. At B=8, T=512, C=2048, D=32 a dx-only call reads
// x and five cotangents and writes dx (bf16, 0.12 GB: 0.036 ms at 3.35 TB/s);
// its four products (h and m recomputed, dh and dxxx) are 10.7 GFLOP, 0.011
// ms on the bf16 tensor cores but 0.16 ms as fp32 FMAs, so they belong on the
// tensor cores.
//
// Two bodies; the wrapper (ops/ddlerp.py b5_body) picks one from dtype and
// shape, by K2's rule.
//
// Tensor-core body (bf16, C % 8 == 0, D = 32 or 64), prologue_bwd_tc_kernel:
// K2's row tiles (csrc/ddlerp.cu), one kernel for the whole chain.
//   * A block holds 32 flattened rows b*T + t (each with its predecessor)
//     and owns the first 31: tile i starts at row 31 i, and its 32nd row is
//     a halo, the next tile's first. The token-shift term dxn[t] += dxx[t+1]
//     then finds dxx[t+1] in the tile for every owned row (a row that ends
//     its sequence takes none; dshift is dxx of each sequence's row 0, from
//     the tile that owns it). The halo costs 1/32 of the products; keeping
//     the first version's chain / ln split instead would send dxx and the
//     row-local dxn (two fp32 (B*T, C) tensors, 134 MB at B=8) through
//     device memory and back. 32 rows a tile, not K2's 64: at B=8 the 133
//     tiles fill the 132 SMs, and the tile's shared memory (99 KB at D=32)
//     lets two blocks share an SM.
//   * Four products on mma.sync m16n8k16 with fp32 accumulators, walking C
//     in slabs of 32 with the weights' slabs staged by double-buffered
//     cp.async: h = tanh(xxx @ w1) as K2 (pass 1); dh_i = dm_i @ w2[i]^T,
//     dm_i = d_i * xx (pass 2), then dpre = dh (1 - h^2); dxxx = dpre @ w1^T
//     and m_i = h_i @ w2[i] (pass 3), whose w1 rows and w2 columns are
//     permuted on their way in so that a thread's accumulators are four
//     neighbouring columns of two rows, and the elementwise adjoint reads and
//     writes 8-byte words. The fp32 activation operands (xxx, dm_i, dpre, h)
//     are stored as two bf16 limbs (hi + lo, about 16 bits), and every
//     product takes both limbs (the weights are bf16 already).
//   * The LayerNorm adjoint needs two sums over each row's C columns before
//     its first dx: pass 3 leaves dxn (fp32) in a scratch of the tile's own
//     rows (in L2: 133 tiles x 256 KB at B=8) and the sums in shared memory,
//     then the block reads dxn back, row by row, and writes dx.
//   * The weight gradients' form saves xxx, h, dpre and dm_i (fp32) for the
//     weight products below and writes the tile's partial column sums of
//     dmaa and dln (fixed order: the warp's 16 rows by shuffle, then the two
//     row tiles); the weight products stay on the CUDA cores.
//
// CUDA-core body (fp32, and the bf16 shapes the other does not take): the
// first version, two row-parallel kernels:
//   chain (one block per 8 rows of one sequence): recompute LN/shift/ddlerp
//     as K2 does, run the chain up to dxx and the part of dxn that is local to
//     the row (both fp32 to device memory), and write the per-block partial
//     column sums of dmaa;
//   ln (one block per 8 rows): dxn[t] = local part + dxx[t+1], the LN
//     adjoint, dshift from row 0, and per-block partials of dln_scale/bias.
// Its products run as fp32 FMAs; it keeps fp32 within 5e-4 of autograd.
//
// Both bodies: the two weight gradients, (C x BT)(BT x 5D) and five (D x BT)
// (BT x C), are products over all rows of the saved xxx, h, dpre and dm_i,
// reduced by a tiled A^T B kernel, one block per output tile walking all
// rows in order. Partial column sums are reduced by rwkv_sum_partials
// (csrc/wkv_fused_bwd.cu) in a fixed order. No atomics: two calls on the
// same inputs give bit-identical gradients. When the weights need no
// gradient (LoRA: K2's parameters are frozen), nothing is saved and the
// weight products do not run.
//
// Shared memory of the CUDA-core chain kernel: max(C8*8, 5*256*8) + 2*5D*8
// + 18 floats, 75.8 KB at C=2048, D=32; of the tensor-core kernel 98.8 KB at
// D=32 and 184 KB at D=64; both opted in above the 48 KB default.
#include "ddlerp_rows.cuh"

namespace rwkv {

// body codes shared with ops/ddlerp.py
enum : int { kB5CudaCore = 0, kB5TensorCore = 1 };

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

// ------------------------------------------------------------------------
// Tensor-core body (bf16, C % 8 == 0, D = 32 or 64): prologue_bwd_tc_kernel
// ------------------------------------------------------------------------

constexpr int kTR = 32;              // rows a tile holds: 31 it owns and the halo row after them
constexpr int kTOwn = kTR - 1;       // rows a tile owns (writes); tile i starts at row 31 i
constexpr int kTThreads = 128;       // 4 warps: 2 row tiles of 16 x 2 column halves
constexpr int kTSlab = 32;           // columns of C a step of a product takes
constexpr int kXS = kTSlab + 8;      // bf16 row stride of a (rows, slab) tile: 80 bytes
constexpr int kDxxS = kTSlab + 4;    // fp32 row stride of the dxx tile

template <int D>
struct BwdTcLayout {
  static constexpr int kD5 = 5 * D;
  static constexpr int kHS = kD5 + 8;             // bf16 row stride of (rows, 5D) tiles
  static constexpr int kW1Elems = kTSlab * kHS;   // w1 rows c of a slab, 5D values each
  static constexpr int kW2Elems = kD5 * kXS;      // w2 rows (i, d), a slab of columns each
  static constexpr int kStageElems = kW1Elems + kW2Elems;   // the last pass takes both
  static constexpr int kHElems = 2 * kTR * kHS;             // h: hi, lo
  static constexpr int kXElems = 2 * 2 * kTR * kXS;         // xxx: two slabs x two limbs
  static constexpr int kDmElems = 2 * 5 * kTR * kXS;        // dm_i of a slab: two limbs x 5
  static constexpr int kDpElems = 2 * kTR * kHS;            // dpre: two limbs
  static constexpr int kRegionElems =
      kDmElems > kDpElems ? (kDmElems > kXElems ? kDmElems : kXElems)
                          : (kDpElems > kXElems ? kDpElems : kXElems);
  static constexpr int kFloats = kTR * kDxxS + 2 * (kTR + 1) + 2 * kTR * 2 + 2 * 6 * kTSlab;
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kStageElems + kHElems + kRegionElems) + sizeof(float) * kFloats;
  static_assert(kW1Elems % 8 == 0 && kStageElems % 8 == 0 && kHElems % 8 == 0 &&
                kRegionElems % 8 == 0, "16-byte alignment");
};

// position of column c (0..31) of a slab in the permuted stage: the
// accumulators (tile nt, pair e) of thread tig of a column half are then the
// four neighbouring columns 4 tig + 2 nt + e
__device__ __forceinline__ int slab_pos(int c) {
  return (c & 16) + ((c & 3) >> 1) * 8 + 2 * ((c & 15) >> 2) + (c & 1);
}

__device__ __forceinline__ void unpack4(const uint2& q, float* f) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ uint2 ldg8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

// hi and lo limbs of eight fp32 values into two bf16 rows
__device__ __forceinline__ void store_limbs8(const float* v, bf16* hi, bf16* lo) {
  float h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) split_bf16(v[j], h[j], l[j]);
  *reinterpret_cast<uint4*>(hi) = pack8(h);
  *reinterpret_cast<uint4*>(lo) = pack8(l);
}

template <int D>
__global__ void __launch_bounds__(kTThreads, D == 32 ? 2 : 1) prologue_bwd_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ shift,
    const bf16* __restrict__ ln_scale, const bf16* __restrict__ ln_bias,
    const bf16* __restrict__ maa, const bf16* __restrict__ w1, const bf16* __restrict__ w2,
    Cotangents cts, bf16* __restrict__ dx, float* __restrict__ dshift, float* __restrict__ dxn_s,
    float* __restrict__ xxx_s, float* __restrict__ h_s, float* __restrict__ dpre_s,
    float* __restrict__ dm_s, float* __restrict__ dmaa_p, float* __restrict__ dln_p, int M,
    int T_len, int C, float eps) {
  using L = BwdTcLayout<D>;
  constexpr int D5 = L::kD5, HS = L::kHS;
  constexpr int NT1 = D5 / 16;      // 8-wide column tiles of 5D a warp owns
  static_assert(NT1 % 2 == 0, "column tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);     // 2 x kStageElems
  bf16* sH = stage + 2 * L::kStageElems;               // h: hi, lo (kTR, HS)
  bf16* region = sH + L::kHElems;
  bf16* sX = region;                                   // pass 1: xxx [slab buffer][limb]
  bf16* sDm = region;                                  // pass 2: dm [limb][i]
  bf16* sDp = region;                                  // pass 3: dpre [limb]
  // the fp32 arrays read as float4 first, each a multiple of 16 bytes
  float* sDxx = reinterpret_cast<float*>(region + L::kRegionElems);   // (kTR, kDxxS)
  float* sCol = sDxx + kTR * kDxxS;                    // [rt][6][kTSlab]: dmaa column sums
  float* sRows = sCol + 2 * 6 * kTSlab;                // [half][row][2]: the LN adjoint's sums
  float* stats = sRows + 2 * kTR * 2;                  // (kTR + 1, 2)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int rt = warp & 1, half = warp >> 1;
  const int tile = blockIdx.x;
  const int m0 = tile * kTOwn;
  const int n_slabs = (C + kTSlab - 1) / kTSlab;
  const bool full = xxx_s != nullptr;   // the weight gradients' form
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const int ld_row = (lane & 7) + ((lane >> 4) << 3), ld_col = ((lane >> 3) & 1) * 8;
  const bf16* d[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) d[i] = static_cast<const bf16*>(cts.d[i]);
  const bf16* dxln = static_cast<const bf16*>(cts.dxln);
  // a row the tile writes: not the halo row, not past the last row
  auto owned = [&](int r) { return r < kTOwn && m0 + r < M; };

  tile_stats(x, stats, m0, kTR, M, C, eps);
  __syncthreads();

  // staging threads: one 16-byte word (8 columns) of row sr of a slab
  const int sr = tid >> 2, cq = (tid & 3) * 8;
  const RowRef mine = make_row(x, shift, stats, m0, sr, M, T_len, C);
  const size_t mrow = (size_t)(m0 + sr);
  uint4 xq, pq, scq, biq, mq;       // the next slab's words of this thread
  auto fetch = [&](int slab, const bf16* vec) {
    const int c = slab * kTSlab + cq;
    const bool on = mine.valid && c < C;
    xq = on ? ldg16(mine.cur + c) : zero4;
    pq = on ? ldg16(mine.prev + c) : zero4;
    scq = on ? ldg16(ln_scale + c) : zero4;
    biq = on ? ldg16(ln_bias + c) : zero4;
    mq = on && vec ? ldg16(vec + c) : zero4;
  };
  // rows c of w1 (5D values each) into dst, row c at position pos(c)
  auto stage_w1 = [&](int slab, bf16* dst, bool permute) {
    constexpr int kChunks = D5 / 8;
    for (int idx = tid; idx < kTSlab * kChunks; idx += kTThreads) {
      const int kr = idx / kChunks, ch = idx - kr * kChunks;
      bf16* dd = dst + (permute ? slab_pos(kr) : kr) * HS + ch * 8;
      const int c = slab * kTSlab + kr;
      if (c < C) cp_async_16(dd, w1 + (size_t)c * D5 + ch * 8);
      else *reinterpret_cast<uint4*>(dd) = zero4;
    }
  };

  // ---- pass 1: h = tanh(xxx @ w1), as K2 ---------------------------------
  float acc[NT1][4];
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  auto store_xxx = [&](int slab, bf16* dst) {
    const int c = slab * kTSlab + cq;
    float v[8];
    if (mine.valid && c < C) {
      float sc[8], bi[8], mx[8], xn[8], xx[8];
      unpack8(scq, sc);
      unpack8(biq, bi);
      unpack8(mq, mx);
      ln_pair(mine, xq, pq, sc, bi, xn, xx);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaf(xx[j], mx[j], xn[j]);
      if (full && owned(sr)) {
        float4* o = reinterpret_cast<float4*>(xxx_s + mrow * C + c);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    store_limbs8(v, dst + sr * kXS + cq, dst + kTR * kXS + sr * kXS + cq);
  };
  stage_w1(0, stage, false);
  fetch(0, maa);
  store_xxx(0, sX);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait_all();
    __syncthreads();
    const bf16* wS = stage + (s & 1) * L::kStageElems;
    const bf16* xS = sX + (s & 1) * 2 * kTR * kXS;
    if (s + 1 < n_slabs) {
      stage_w1(s + 1, stage + ((s + 1) & 1) * L::kStageElems, false);
      fetch(s + 1, maa);
    }
#pragma unroll
    for (int ks = 0; ks < kTSlab / 16; ++ks) {
      unsigned a[4], al[4];
      const bf16* ap = xS + (rt * 16 + (lane & 15)) * kXS + ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(a, ap);
      ldmatrix_x4(al, ap + kTR * kXS);
#pragma unroll
      for (int np = 0; np < NT1 / 2; ++np) {
        unsigned bq[4];
        ldmatrix_x4_trans(bq, wS + (ks * 16 + (lane & 15)) * HS + half * NT1 * 8 + np * 16 +
                                  (lane >> 4) * 8);
        mma_m16n8k16(acc[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(acc[2 * np + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        mma_m16n8k16(acc[2 * np], al[0], al[1], al[2], al[3], bq[0], bq[1]);
        mma_m16n8k16(acc[2 * np + 1], al[0], al[1], al[2], al[3], bq[2], bq[3]);
      }
    }
    if (s + 1 < n_slabs) store_xxx(s + 1, sX + ((s + 1) & 1) * 2 * kTR * kXS);
  }
  // h in two limbs; the accumulators start over as dh
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt) {
    const int col = half * NT1 * 8 + nt * 8 + 2 * tig;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rt * 16 + g + 8 * rr;
      float hi0, lo0, hi1, lo1;
      const float h0 = tanhf(acc[nt][2 * rr]), h1 = tanhf(acc[nt][2 * rr + 1]);
      split_bf16(h0, hi0, lo0);
      split_bf16(h1, hi1, lo1);
      *reinterpret_cast<unsigned*>(sH + row * HS + col) = pack_bf16(hi0, hi1);
      *reinterpret_cast<unsigned*>(sH + kTR * HS + row * HS + col) = pack_bf16(lo0, lo1);
      if (full && owned(row))
        *reinterpret_cast<float2*>(h_s + (size_t)(m0 + row) * D5 + col) = make_float2(h0, h1);
      acc[nt][2 * rr] = acc[nt][2 * rr + 1] = 0.f;
    }
  }

  // ---- pass 2: dh_i = dm_i @ w2[i]^T, dm_i = d_i * xx ---------------------
  // A slab stages the rows (i, d) of w2 over its columns; dm_i of the slab
  // goes to shared memory in two limbs, one buffer (two barriers a slab).
  auto stage_w2 = [&](int slab, bf16* dst) {
    constexpr int kChunks = kTSlab / 8;
    for (int idx = tid; idx < D5 * kChunks; idx += kTThreads) {
      const int n = idx / kChunks, ch = idx - n * kChunks;
      const int c = slab * kTSlab + ch * 8;
      bf16* dd = dst + n * kXS + ch * 8;
      if (c < C) cp_async_16(dd, w2 + (size_t)n * C + c);
      else *reinterpret_cast<uint4*>(dd) = zero4;
    }
  };
  uint4 dq[5];
  auto fetch_d = [&](int slab) {
    fetch(slab, nullptr);
    const int c = slab * kTSlab + cq;
    const bool on = mine.valid && c < C;
#pragma unroll
    for (int i = 0; i < 5; ++i) dq[i] = on && d[i] ? ldg16(d[i] + mrow * C + c) : zero4;
  };
  auto store_dm = [&](int slab) {
    const int c = slab * kTSlab + cq;
    float xn[8], xx[8];
    if (mine.valid && c < C) {
      float sc[8], bi[8];
      unpack8(scq, sc);
      unpack8(biq, bi);
      ln_pair(mine, xq, pq, sc, bi, xn, xx);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xx[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float v[8];
      unpack8(dq[i], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= xx[j];
      if (full && owned(sr) && c < C) {
        float4* o = reinterpret_cast<float4*>(dm_s + ((size_t)i * M + mrow) * C + c);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      bf16* hi = sDm + (i * kTR + sr) * kXS + cq;
      store_limbs8(v, hi, hi + 5 * kTR * kXS);
    }
  };
  __syncthreads();   // h is complete; pass 1's buffers are free
  stage_w2(0, stage);
  fetch_d(0);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait_all();
    __syncthreads();   // w2 of slab s has landed; dm of slab s - 1 is read
    store_dm(s);
    if (s + 1 < n_slabs) {
      stage_w2(s + 1, stage + ((s + 1) & 1) * L::kStageElems);
      fetch_d(s + 1);
    }
    __syncthreads();
    const bf16* wS = stage + (s & 1) * L::kStageElems;
#pragma unroll
    for (int ks = 0; ks < kTSlab / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < NT1 / 2; ++np) {
        const int n0 = half * NT1 * 8 + np * 16;
        const int i = n0 / D;
        unsigned a[4], al[4], bq[4];
        const bf16* ap = sDm + (i * kTR + rt * 16 + (lane & 15)) * kXS + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a, ap);
        ldmatrix_x4(bq, wS + (n0 + ld_row) * kXS + ks * 16 + ld_col);
        mma_m16n8k16(acc[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(acc[2 * np + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        ldmatrix_x4(al, ap + 5 * kTR * kXS);
        mma_m16n8k16(acc[2 * np], al[0], al[1], al[2], al[3], bq[0], bq[1]);
        mma_m16n8k16(acc[2 * np + 1], al[0], al[1], al[2], al[3], bq[2], bq[3]);
      }
    }
  }
  __syncthreads();   // every warp is done with dm: its memory takes dpre
  // dpre = dh * (1 - h^2), h from its two limbs
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt) {
    const int col = half * NT1 * 8 + nt * 8 + 2 * tig;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rt * 16 + g + 8 * rr;
      const float2 hh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sH + row * HS + col));
      const float2 hl =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sH + kTR * HS + row * HS + col));
      const float h0 = hh.x + hl.x, h1 = hh.y + hl.y;
      const float p0 = acc[nt][2 * rr] * (1.f - h0 * h0), p1 = acc[nt][2 * rr + 1] * (1.f - h1 * h1);
      float hi0, lo0, hi1, lo1;
      split_bf16(p0, hi0, lo0);
      split_bf16(p1, hi1, lo1);
      *reinterpret_cast<unsigned*>(sDp + row * HS + col) = pack_bf16(hi0, hi1);
      *reinterpret_cast<unsigned*>(sDp + kTR * HS + row * HS + col) = pack_bf16(lo0, lo1);
      if (full && owned(row))
        *reinterpret_cast<float2*>(dpre_s + (size_t)(m0 + row) * D5 + col) = make_float2(p0, p1);
    }
  }

  // ---- pass 3: dxxx = dpre @ w1^T, m_i = h_i @ w2[i], then per element
  //   dxx = dxxx maa_x + sum_i d_i (maa_i + m_i)
  //   dxn = dxln + sum_i d_i + dxxx - dxx + dxx[t+1]
  // A slab stages w1's rows and w2's columns of its 32 columns, both permuted
  // by slab_pos, so that a thread's accumulators are 4 neighbouring columns of
  // 2 rows. dxx[t+1] of the tile's last owned row is its halo row's; a row
  // that ends its sequence takes none. dxn goes to dxn_s (fp32) and comes back
  // once every column has added to the rows' LayerNorm-adjoint sums.
  auto stage_both = [&](int slab, bf16* dst) {
    stage_w1(slab, dst, true);
    bf16* d2 = dst + L::kW1Elems;
    for (int idx = tid; idx < D5 * (kTSlab / 2); idx += kTThreads) {
      const int n = idx / (kTSlab / 2), c = 2 * (idx - n * (kTSlab / 2));
      const int col = slab * kTSlab + c;
      unsigned* dd = reinterpret_cast<unsigned*>(d2 + n * kXS + slab_pos(c));
      if (col < C) cp_async_4(dd, w2 + (size_t)n * C + col);
      else *dd = 0u;
    }
  };
  const RowRef rows[2] = {make_row(x, shift, stats, m0, rt * 16 + g, M, T_len, C),
                          make_row(x, shift, stats, m0, rt * 16 + g + 8, M, T_len, C)};
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  stage_both(0, stage);
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait_all();
    __syncthreads();   // slab s has landed; sDxx and sCol of slab s - 1 are read
    if (s + 1 < n_slabs) stage_both(s + 1, stage + ((s + 1) & 1) * L::kStageElems);
    const bf16* w1S = stage + (s & 1) * L::kStageElems;
    const bf16* w2S = w1S + L::kW1Elems;
    const int cl = half * 16 + tig * 4;      // this thread's 4 columns in the slab
    const int c0 = s * kTSlab + cl;
    const bool col_on = c0 < C;
    // every word this slab's epilogue needs is asked for before the products
    uint2 xw[2], pw[2], dw[5][2], lw[2], mw[6], scw, biw;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const bool on = col_on && rows[rr].valid;
      const size_t at = (size_t)(m0 + rt * 16 + g + 8 * rr) * C + c0;
      xw[rr] = on ? ldg8(rows[rr].cur + c0) : make_uint2(0u, 0u);
      pw[rr] = on ? ldg8(rows[rr].prev + c0) : make_uint2(0u, 0u);
      lw[rr] = on && dxln ? ldg8(dxln + at) : make_uint2(0u, 0u);
#pragma unroll
      for (int i = 0; i < 5; ++i) dw[i][rr] = on && d[i] ? ldg8(d[i] + at) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) mw[i] = col_on ? ldg8(maa + (size_t)i * C + c0) : make_uint2(0u, 0u);
    scw = col_on ? ldg8(ln_scale + c0) : make_uint2(0u, 0u);
    biw = col_on ? ldg8(ln_bias + c0) : make_uint2(0u, 0u);

    float ax[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D5 / 16; ++ks) {
      unsigned a[4], bq[4];
      const bf16* ap = sDp + (rt * 16 + (lane & 15)) * HS + ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(a, ap);
      ldmatrix_x4(bq, w1S + (half * 16 + ld_row) * HS + ks * 16 + ld_col);
      mma_m16n8k16(ax[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
      mma_m16n8k16(ax[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
      ldmatrix_x4(a, ap + kTR * HS);
      mma_m16n8k16(ax[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
      mma_m16n8k16(ax[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
    }
    float sc[4], bi[4], mv[6][4], xn[2][4], xx[2][4], xr[2][4];
    unpack4(scw, sc);
    unpack4(biw, bi);
#pragma unroll
    for (int i = 0; i < 6; ++i) unpack4(mw[i], mv[i]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float xv[4], pv[4];
      unpack4(xw[rr], xv);
      unpack4(pw[rr], pv);
      const RowRef& row = rows[rr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xr[rr][j] = (xv[j] - row.mu) * row.rstd;
        xn[rr][j] = fmaf(xr[rr][j], sc[j], bi[j]);
        const float prev =
            row.prev_is_shift ? pv[j] : fmaf((pv[j] - row.pmu) * row.prstd, sc[j], bi[j]);
        xx[rr][j] = prev - xn[rr][j];
      }
    }
    // dxx, the row-local part of dxn, and the dmaa column sums of owned rows
    float dxx[2][4], dxn[2][4], col[6][4] = {};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lv[4];
      unpack4(lw[rr], lv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float X = ax[j >> 1][2 * rr + (j & 1)];
        dxx[rr][j] = X * mv[0][j];
        dxn[rr][j] = lv[j] + X;
        if (owned(rt * 16 + g + 8 * rr)) col[0][j] = fmaf(X, xx[rr][j], col[0][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float am[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) am[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned a[4], bq[4];
        const bf16* ap = sH + (rt * 16 + (lane & 15)) * HS + i * D + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a, ap);
        ldmatrix_x4_trans(bq, w2S + (i * D + ks * 16 + (lane & 15)) * kXS + half * 16 +
                                  (lane >> 4) * 8);
        mma_m16n8k16(am[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(am[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        ldmatrix_x4(a, ap + kTR * HS);
        mma_m16n8k16(am[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(am[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float dv[4];
        unpack4(dw[i][rr], dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dxx[rr][j] = fmaf(dv[j], mv[i + 1][j] + am[j >> 1][2 * rr + (j & 1)], dxx[rr][j]);
          dxn[rr][j] += dv[j];
          if (owned(rt * 16 + g + 8 * rr)) col[i + 1][j] = fmaf(dv[j], xx[rr][j], col[i + 1][j]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rt * 16 + g + 8 * rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) dxn[rr][j] -= dxx[rr][j];
      *reinterpret_cast<float4*>(sDxx + row * kDxxS + cl) =
          make_float4(dxx[rr][0], dxx[rr][1], dxx[rr][2], dxx[rr][3]);
      if (col_on && owned(row) && (m0 + row) % T_len == 0)
        *reinterpret_cast<float4*>(dshift + (size_t)((m0 + row) / T_len) * C + c0) =
            make_float4(dxx[rr][0], dxx[rr][1], dxx[rr][2], dxx[rr][3]);
    }
    if (full) {
      // column sums over the warp's 16 rows, then the two row tiles in order
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) col[i][j] += __shfl_xor_sync(0xffffffffu, col[i][j], o);
      if (g == 0)
#pragma unroll
        for (int i = 0; i < 6; ++i)
          *reinterpret_cast<float4*>(sCol + (rt * 6 + i) * kTSlab + cl) =
              make_float4(col[i][0], col[i][1], col[i][2], col[i][3]);
    }
    __syncthreads();   // the slab's dxx (and column sums) are complete
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rt * 16 + g + 8 * rr;
      if (!col_on || !owned(row)) continue;
      const bool next = (m0 + row + 1) % T_len != 0;   // row + 1 is in this tile
      const float4 nx = *reinterpret_cast<const float4*>(sDxx + (row + 1) * kDxxS + cl);
      const float nv[4] = {nx.x, nx.y, nx.z, nx.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (next) dxn[rr][j] += nv[j];
        const float dr = dxn[rr][j] * sc[j];
        s1[rr] += dr;
        s2[rr] = fmaf(dr, xr[rr][j], s2[rr]);
      }
      *reinterpret_cast<float4*>(dxn_s + (size_t)(m0 + row) * C + c0) =
          make_float4(dxn[rr][0], dxn[rr][1], dxn[rr][2], dxn[rr][3]);
    }
    if (full)
      for (int idx = tid; idx < 6 * kTSlab; idx += kTThreads) {
        const int i = idx / kTSlab, c = idx - i * kTSlab;
        if (s * kTSlab + c < C)
          dmaa_p[((size_t)tile * 6 + i) * C + s * kTSlab + c] =
              sCol[i * kTSlab + c] + sCol[(6 + i) * kTSlab + c];
      }
  }

  // ---- the LayerNorm adjoint: the rows' sums, then dx over the owned rows
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[rr] += __shfl_xor_sync(0xffffffffu, s1[rr], o);
      s2[rr] += __shfl_xor_sync(0xffffffffu, s2[rr], o);
    }
    if (tig == 0) {
      const int row = rt * 16 + g + 8 * rr;
      sRows[(half * kTR + row) * 2] = s1[rr];
      sRows[(half * kTR + row) * 2 + 1] = s2[rr];
    }
  }
  __syncthreads();   // dxn_s of the tile's owned rows and the sums are complete
  for (int c = tid * 8; c < C; c += kTThreads * 8) {
    float sc[8], dla[8], dlb[8];
    unpack8(ldg16(ln_scale + c), sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) dla[j] = dlb[j] = 0.f;
    for (int r = 0; r < kTOwn && m0 + r < M; ++r) {
      const size_t at = (size_t)(m0 + r) * C + c;
      const float mu = stats[2 * (r + 1)], rstd = stats[2 * (r + 1) + 1];
      const float m1 = (sRows[r * 2] + sRows[(kTR + r) * 2]) / C;
      const float m2 = (sRows[r * 2 + 1] + sRows[(kTR + r) * 2 + 1]) / C;
      float xv[8], o[8];
      unpack8(ldg16(x + at), xv);
      const float4 q0 = *reinterpret_cast<const float4*>(dxn_s + at);
      const float4 q1 = *reinterpret_cast<const float4*>(dxn_s + at + 4);
      const float dn[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xr = (xv[j] - mu) * rstd;
        o[j] = rstd * (dn[j] * sc[j] - m1 - xr * m2);
        dla[j] = fmaf(dn[j], xr, dla[j]);
        dlb[j] += dn[j];
      }
      *reinterpret_cast<uint4*>(dx + at) = pack8(o);
    }
    if (dln_p) {
      float4* o = reinterpret_cast<float4*>(dln_p + (size_t)tile * 2 * C + c);
      o[0] = make_float4(dla[0], dla[1], dla[2], dla[3]);
      o[1] = make_float4(dla[4], dla[5], dla[6], dla[7]);
      o = reinterpret_cast<float4*>(dln_p + ((size_t)tile * 2 + 1) * C + c);
      o[0] = make_float4(dlb[0], dlb[1], dlb[2], dlb[3]);
      o[1] = make_float4(dlb[4], dlb[5], dlb[6], dlb[7]);
    }
  }
}

// the weight gradients from the saved rows, when they are wanted (dw1 set)
static cudaError_t launch_weight_products(const float* xxx_s, const float* h_s,
                                          const float* dpre_s, const float* dm_s, float* dw1,
                                          float* dw2, int K, int C, int D, cudaStream_t s) {
  if (dw1 == nullptr) return cudaSuccess;
  const int D5 = 5 * D;
  cudaError_t e;
  // dw1 (C, 5D) = xxx^T dpre
  if ((e = launch_atb(xxx_s, C, 0, dpre_s, D5, 0, dw1, D5, 0, C, D5, K, 1, s)) != cudaSuccess)
    return e;
  // dw2[i] (D, C) = h_i^T dm_i
  return launch_atb(h_s, D5, D, dm_s, C, (long long)K * C, dw2, C, (long long)D * C, D, C, K,
                    5, s);
}

template <int D>
static cudaError_t launch_tc_bwd_d(const void* const* in, Cotangents cts, void* dx, void* dshift,
                                   void* const* scratch, int M, int T_len, int C, float eps,
                                   cudaStream_t s) {
  const size_t smem = BwdTcLayout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(prologue_bwd_tc_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (M + kTOwn - 1) / kTOwn;
  auto bf = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  prologue_bwd_tc_kernel<D><<<tiles, kTThreads, smem, s>>>(
      bf(in[0]), bf(in[1]), bf(in[2]), bf(in[3]), bf(in[4]), bf(in[5]), bf(in[7]), cts,
      static_cast<bf16*>(dx), f(dshift), f(scratch[0]), f(scratch[2]), f(scratch[3]),
      f(scratch[4]), f(scratch[5]), f(scratch[6]), f(scratch[7]), M, T_len, C, eps);
  return cudaGetLastError();
}

// scratch[0] holds dxn (B*T, C) fp32; scratch[1] is unused
static cudaError_t launch_tc_bwd(const void* const* in, Cotangents cts, void* dx, void* dshift,
                                 void* const* scratch, int M, int T_len, int C, int D, float eps,
                                 cudaStream_t s) {
  if (D == 32) return launch_tc_bwd_d<32>(in, cts, dx, dshift, scratch, M, T_len, C, eps, s);
  return launch_tc_bwd_d<64>(in, cts, dx, dshift, scratch, M, T_len, C, eps, s);
}

template <typename T>
static cudaError_t launch_prologue_bwd(const void* const* in, Cotangents cts,
                                       void* const* out, void* const* scratch, int B,
                                       int T_len, int C, int D, float eps, int body,
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
  cudaError_t e;
  if (body == kB5TensorCore) {
    if ((e = launch_tc_bwd(in, cts, dx, dshift, scratch, B * T_len, T_len, C, D, eps, s)) !=
        cudaSuccess)
      return e;
    return launch_weight_products(xxx_s, h_s, dpre_s, dm_s, dw1, dw2, B * T_len, C, D, s);
  }
  const size_t smem = chain_smem_bytes(C, D);
  e = cudaFuncSetAttribute(prologue_bwd_chain_kernel<T>,
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
  return launch_weight_products(xxx_s, h_s, dpre_s, dm_s, dw1, dw2, B * T_len, C, D, s);
}

}  // namespace rwkv

// Dynamic shared memory of a block of `body` at (C, D); the wrapper checks it
// against the card's opt-in limit before launching.
extern "C" long long rwkv_tmix_prologue_bwd_smem_bytes(int C, int D, int body) {
  using namespace rwkv;
  if (body == kB5TensorCore)
    return (long long)(D == 64 ? BwdTcLayout<64>::kBytes : BwdTcLayout<32>::kBytes);
  return (long long)chain_smem_bytes(C, D);
}

// in: x, shift, ln_scale, ln_bias, maa, w1, w1T (5D, C), w2, w2T (C, 5D), all
//   of `dtype`; d0..d4, dxln: cotangents of `dtype`, each may be null;
// out: dx (dtype), dshift (B, C) fp32, dw1 (C, 5D) fp32, dw2 (5, D, C) fp32;
// scratch (fp32): dxx, dxnp (B*T, C) (the tensor-core body: dxn and null);
//   xxx (B*T, C), h, dpre (B*T, 5D), dm (5, B*T, C), dmaa partials
//   (n_blocks, 6, C), dln partials (n_blocks, 2, C), n_blocks = B * ceil(T /
//   8) (the tensor-core body: ceil(B*T / 31) tiles). dw1, dw2 and the xxx, h,
//   dpre, dm and dmaa scratch are null together when no weight gradient is
//   wanted; the dln partials may be null on their own. body: kB5CudaCore or
//   kB5TensorCore.
extern "C" int rwkv_tmix_prologue_bwd(const void* x, const void* shift, const void* ln_scale,
                                      const void* ln_bias, const void* maa, const void* w1,
                                      const void* w1T, const void* w2, const void* w2T,
                                      const void* d0, const void* d1, const void* d2,
                                      const void* d3, const void* d4, const void* dxln,
                                      void* dx, void* dshift, void* dw1, void* dw2, void* dxx,
                                      void* dxnp, void* xxx_s, void* h_s, void* dpre_s,
                                      void* dm_s, void* dmaa_p, void* dln_p, int B, int T_len,
                                      int C, int D, float eps, int dtype, int body, void* stream) {
  using namespace rwkv;
  if (D <= 0 || D % kBwdUnroll != 0) return cudaErrorInvalidValue;
  if (body == kB5TensorCore &&
      (dtype != kBFloat16 || C % 8 != 0 || (D != 32 && D != 64) || dxnp != nullptr))
    return cudaErrorInvalidValue;
  if (body != kB5TensorCore && body != kB5CudaCore) return cudaErrorInvalidValue;
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
      return launch_prologue_bwd<float>(in, cts, out, scratch, B, T_len, C, D, eps, body, s);
    case kBFloat16:
      return launch_prologue_bwd<__nv_bfloat16>(in, cts, out, scratch, B, T_len, C, D, eps, body,
                                                s);
    default:
      return cudaErrorInvalidValue;
  }
}
