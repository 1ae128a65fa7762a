// The chunk factoring shared by the chunked bodies of K1 (wkv_fused.cu), of
// its backward B.6 / B.7 (wkv_fused_bwd.cu) and of the unfused B.8 (wkv.cu),
// and the forward walk over the chunks that K1, B.6 and B.8 all run
// (chunk_walk): chunks of kL steps, every
// decay factor exp of a sum of d = -exp(w) <= 0, fp32 operands sent to the
// bf16 tensor cores as two limbs.
//
// Within a chunk, c_t = d_0 + .. + d_{t-1} (c_0 = 0, c_L the whole chunk) per
// channel i, and the forward's scores below the diagonal are
//   A[t, s] = sum_i r_ti k_si exp(c_t,i - c_{s+1},i),   s < t,
// with the bonus r_t . (u k_t) on the diagonal.
#pragma once

#include "mma.cuh"

namespace rwkv {

typedef __nv_bfloat16 bf16;

constexpr int kL = 16;           // steps a chunk
constexpr int kAStride = 24;     // bf16 row stride of the (kL, kL) scores
constexpr int kScores = kL * (kL - 1) / 2;   // entries below the diagonal
constexpr float kLog2e = 1.4426950408889634f;

// 2^x to about 2^-22 of the result; 2^0 is exactly 1
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x as two bf16 limbs: the upper 16 bits of x, and what that cut left
__device__ __forceinline__ void store_limbs(float x, bf16* hi, bf16* lo) {
  const unsigned u = __float_as_uint(x);
  *reinterpret_cast<unsigned short*>(hi) = static_cast<unsigned short>(u >> 16);
  *lo = __float2bfloat16_rn(x - __uint_as_float(u & 0xffff0000u));
}

// four bf16 values (8 bytes, 8-byte aligned), widened
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

// Row strides of a block's (kL, N) tiles: odd multiples of 16 bytes, so the
// 16-byte words that eight lanes of an ldmatrix read from eight rows lie in
// different banks.
template <int N>
struct ChunkDims {
  static constexpr int kThreads = 2 * N;
  static constexpr int kBS = N + 8;       // bf16 row stride
  static constexpr int kFS = N + 4;       // fp32 row stride (16-byte rows)
  static constexpr int kSlices = N / 4;   // 4-channel slices of a score
  static constexpr int kPS = kSlices + 1; // row stride of the scores' partial sums
  static constexpr int kTile = kL * kBS * 2;   // bytes of one bf16 (kL, N) tile
};

// The scores A of one chunk, as two bf16 limbs (a_hi, a_lo: rows t, stride
// kAStride; entries above the diagonal are left as they are), from r and k
// (bf16 tiles, stride kBS), exp(d_t) (fp32, stride kFS), u, and the rows of
// the chunk that hold steps (len; the diagonal of the others is 0).
// Without an exponential: for a column s the factor exp(c_t - c_{s+1}) is
// the running product of exp(d_{s+1}) .. exp(d_{t-1}), so a thread walks t
// with q <- q exp(d_t) from q = k_s. A thread owns 4 channels of columns
// s = pair and s = kL - 2 - pair, kL steps together, and leaves one partial
// sum an entry in `part` ((kScores, kPS) fp32); entry (t, s) is number
// t (t - 1) / 2 + s. After a barrier the partial sums of an entry are added
// in a fixed order. The caller puts a barrier before (the inputs) and after
// (the scores).
template <int N>
__device__ __forceinline__ void chunk_scores(const bf16* rs, const bf16* ks, const float* ed,
                                             const float* uf, int len, float* part,
                                             bf16* a_hi, bf16* a_lo, int tid) {
  using D = ChunkDims<N>;
  constexpr int BS = D::kBS, FS = D::kFS, PS = D::kPS;
  {
    const int slice = tid % D::kSlices, pair = tid / D::kSlices;
    const int n_first = kL - 1 - pair;
    const int n_all = pair == kL / 2 - 1 ? n_first : kL;
    int s = pair, t = pair + 1;
    float4 q = load4(ks + s * BS + 4 * slice);
    for (int n = 0; n < n_all; ++n, ++t) {
      if (n == n_first) {
        s = kL - 2 - pair;
        t = s + 1;
        q = load4(ks + s * BS + 4 * slice);
      }
      const float4 r4 = load4(rs + t * BS + 4 * slice);
      const float4 e4 = *reinterpret_cast<const float4*>(ed + t * FS + 4 * slice);
      part[(t * (t - 1) / 2 + s) * PS + slice] =
          fmaf(r4.x, q.x, r4.y * q.y) + fmaf(r4.z, q.z, r4.w * q.w);
      q.x *= e4.x;
      q.y *= e4.y;
      q.z *= e4.z;
      q.w *= e4.w;
    }
  }
  __syncthreads();
  // the partial sums of an entry added in a fixed order; the bonus
  // r_t . (u k_t) on the diagonal
  for (int p = tid; p < kScores + kL; p += D::kThreads) {
    int t = 1, s;
    float a = 0.f;
    if (p < kScores) {
      while ((t + 1) * t / 2 <= p) ++t;
      s = p - t * (t - 1) / 2;
#pragma unroll
      for (int sl = 0; sl < D::kSlices; ++sl) a += part[p * PS + sl];
    } else {
      t = s = p - kScores;
      if (t < len) {
#pragma unroll 4
        for (int i = 0; i < N; i += 4) {
          const float4 r4 = load4(rs + t * BS + i), k4 = load4(ks + t * BS + i);
          const float4 u4 = *reinterpret_cast<const float4*>(uf + i);
          a = fmaf(r4.x * u4.x, k4.x, a);
          a = fmaf(r4.y * u4.y, k4.y, a);
          a = fmaf(r4.z * u4.z, k4.z, a);
          a = fmaf(r4.w * u4.w, k4.w, a);
        }
      }
    }
    store_limbs(a, a_hi + t * kAStride + s, a_lo + t * kAStride + s);
  }
}

// step s of a row's walk is time s, or n_steps - 1 - s in reverse
__device__ __forceinline__ int step_time(int s, int n_steps, int reverse) {
  return reverse ? n_steps - 1 - s : s;
}

// What a forward walk over the chunks (chunk_walk) writes.
enum ChunkMode {
  kChunkOutput = 0,    // K1: the gated output and the final state
  kChunkAdjoint = 1,   // B.6: the entry states and the GroupNorm/gate adjoint
  kChunkState = 2,     // B.6 without GroupNorm (B.8's backward): the entry states
  kChunkRaw = 3,       // B.8: the raw fp32 y and the final state, no GroupNorm, no gate
};

// Shared memory of a chunk_walk block, in bytes from the start. A chunk
// stages k, v, w, for the modes that form y r, and for the GroupNorm modes
// g (and dout).
template <int N, int kMode>
struct ChunkLayout : ChunkDims<N> {
  using D = ChunkDims<N>;
  static constexpr bool kY = kMode != kChunkState;   // forms y (scores, products)
  static constexpr bool kGN = kMode == kChunkOutput || kMode == kChunkAdjoint;
  static constexpr bool kSaveStates = kMode == kChunkAdjoint || kMode == kChunkState;
  static constexpr int kTiles = kMode == kChunkState ? 2
                                : kMode == kChunkRaw ? 3
                                : kMode == kChunkOutput ? 4 : 5;
  static constexpr int kStage = kTiles * D::kTile + kL * N * 4;   // the tiles and w
  static constexpr int kOffRd = 2 * kStage;                      // r exp(c): hi, lo
  static constexpr int kOffKd = kOffRd + 2 * D::kTile;           // k exp(c_L - c): hi, lo
  static constexpr int kOffA = kOffKd + 2 * D::kTile;            // scores: hi, lo
  // the scores' partial sums (kScores, kPS) fp32; once they are added up, y
  // (kL, kFS) fp32 in the same place, and at the end the dscale/dbias rows
  static constexpr int kOffPart = kOffA + 2 * kL * kAStride * 2;
  static constexpr int kPartBytes =
      (kScores * D::kPS > kL * D::kFS ? kScores * D::kPS : kL * D::kFS) * 4;
  static constexpr int kOffEd = kOffPart + kPartBytes;           // exp(d_t), (kL, kFS)
  static constexpr int kOffEv = kOffEd + kL * D::kFS * 4;        // exp(c_L)
  static constexpr int kOffU = kOffEv + N * 4;                   // u of this head
  static constexpr int kBytes = kOffU + N * 4;
  static_assert(D::kTile % 16 == 0 && kStage % 16 == 0 && kOffPart % 16 == 0 &&
                kOffEd % 16 == 0, "16-byte alignment");
};

// The chunked forward of one (b, h), one block of 2N threads, over the walk
// (each row's prefix of `lengths` steps in its direction; all T steps
// forwards without them). Warp m keeps rows j in [16m, 16m+16) of the
// TRANSPOSED state S^T[j][i] as fp32 mma accumulators for the whole walk;
// per chunk:
//   A  the scaled operands: half the threads walk a channel forward
//      (r exp(c_t), exp(c_L)), the other half backward (k exp(c_L - c_{t+1}),
//      exp(d_t)): running sums of d, no difference of two sums;
//   B  the scores below the diagonal (chunk_scores; the modes that form y);
//   C  y^T = S^T (r exp(c))^T + V^T A^T (the modes that form y), and
//      S^T <- S^T diag(exp(c_L)) + V^T (k exp(c_L - c));
//   D' kChunkRaw: y (fp32) to `y32` straight from the tile of phase C, 16
//      rows at once, each at its step's time; zeros at the times the walk
//      does not reach;
//   D  GroupNorm over the head for 16 rows at once, 8 channels of a row a
//      thread, then the gate (kChunkOutput: `out`) or the GroupNorm/gate
//      adjoint (kChunkAdjoint: dg, dy, and the (b, h) partials of dscale and
//      dbias, which each thread sums over its own rows and the block then over
//      its 16 rows in a fixed order).
// kChunkOutput and kChunkRaw write the final state to sT; the other modes
// write the state at every chunk's entry to `states` (B*H, ceil(T / kL), N,
// N) fp32 in (K, V) layout. s0, dout and (kChunkRaw) u may be null (zero).
// `y32` is kChunkAdjoint's dy or kChunkRaw's y. The next chunk's rows arrive
// by cp.async while this one is computed (two stages).
template <int N, int kMode>
__device__ __forceinline__ void chunk_walk(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const bf16* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ s0, const bf16* __restrict__ dout,
    const int* __restrict__ lengths, bf16* __restrict__ out, float* __restrict__ sT,
    float* __restrict__ states, float* __restrict__ y32, bf16* __restrict__ dg_out,
    float* __restrict__ dsc_p, float* __restrict__ dbi_p, int T_len, int H, float eps,
    int reverse, unsigned char* smem) {
  using L = ChunkLayout<N, kMode>;
  constexpr bool kY = L::kY, kGN = L::kGN;
  constexpr int BS = L::kBS, FS = L::kFS;
  constexpr int NT = N / 8;        // 8-wide tiles of i in a row of S^T
  constexpr int TPR = N / 8;       // threads per row in the copies and the epilogue
  bf16* rd_hi = reinterpret_cast<bf16*>(smem + L::kOffRd);
  bf16* rd_lo = rd_hi + kL * BS;
  bf16* kd_hi = reinterpret_cast<bf16*>(smem + L::kOffKd);
  bf16* kd_lo = kd_hi + kL * BS;
  bf16* a_hi = reinterpret_cast<bf16*>(smem + L::kOffA);
  bf16* a_lo = a_hi + kL * kAStride;
  float* part = reinterpret_cast<float*>(smem + L::kOffPart);
  float* ys = part;
  float* ed = reinterpret_cast<float*>(smem + L::kOffEd);
  float* ev = reinterpret_cast<float*>(smem + L::kOffEv);
  float* uf = reinterpret_cast<float*>(smem + L::kOffU);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int row = tid / TPR, col8 = (tid % TPR) * 8;   // this thread's 8 values of a (kL, N) tile
  // the four 8 x 8 matrices of an ldmatrix over a (16 rows) x (16 columns) patch:
  // rows (lane & 7) + 8 * (lane >> 4), columns 8 * ((lane >> 3) & 1)
  const int ld_row = (lane & 7) + ((lane >> 4) << 3), ld_col = ((lane >> 3) & 1) * 8;

  // S^T: st[nt][e] is row j = 16 warp + gq + 8 (e / 2), column i = 8 nt + 2 tig + e % 2
  float st[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = s0 ? s0[((size_t)bh * N + nt * 8 + 2 * tig + (e & 1)) * N + 16 * warp + gq +
                          8 * (e >> 1)]
                     : 0.f;
  float sc[8], bi[8], dsc[8], dbi[8];
  if (kGN) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      sc[q] = scale[h * N + col8 + q];
      bi[q] = bias[h * N + col8 + q];
      dsc[q] = dbi[q] = 0.f;
    }
  }
  if (kY) {
    if (tid < N) uf[tid] = u ? u[h * N + tid] : 0.f;
    // entries above the diagonal stay 0 for the whole walk
    for (int p = tid; p < kL * kAStride; p += L::kThreads) {
      a_hi[p] = __float2bfloat16_rn(0.f);
      a_lo[p] = __float2bfloat16_rn(0.f);
    }
  }

  const int n_steps = lengths ? min(max(lengths[b], 0), T_len) : T_len;
  const int n_chunks = (n_steps + kL - 1) / kL;
  float* st_out = L::kSaveStates ? states + (size_t)bh * ((T_len + kL - 1) / kL) * N * N : nullptr;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  // rows of chunk c into stage `sg`: k, v (r, g, dout), w; rows past the walk are zeros
  auto start_loads = [&](int c, int sg) {
    unsigned char* base = smem + sg * L::kStage;
    const int s = c * kL + row;
    const bool on = s < n_steps;
    const size_t at =
        (((size_t)b * T_len + (on ? step_time(s, n_steps, reverse) : 0)) * H + h) * N;
    const bf16* src[5] = {k, v, r, g, dout};
#pragma unroll
    for (int a = 0; a < L::kTiles; ++a) {
      bf16* d = reinterpret_cast<bf16*>(base + a * L::kTile) + row * BS + col8;
      if (on && src[a]) cp_async_16(d, src[a] + at + col8);
      else *reinterpret_cast<uint4*>(d) = zero4;
    }
    float* wd = reinterpret_cast<float*>(base + L::kTiles * L::kTile) + row * N + col8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (on) cp_async_16(wd + 4 * q, w + at + col8 + 4 * q);
      else *reinterpret_cast<uint4*>(wd + 4 * q) = zero4;
    }
  };

  if (n_chunks > 0) start_loads(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed, and everyone is done with chunk c - 1, whose stage
    // chunk c + 1 takes
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_chunks) start_loads(c + 1, (c + 1) & 1);
    const int len = min(kL, n_steps - c * kL);
    const unsigned char* base = smem + (c & 1) * L::kStage;
    const bf16* ks = reinterpret_cast<const bf16*>(base);
    const bf16* vs = ks + kL * BS;
    const bf16* rs = vs + kL * BS;
    const bf16* gs = rs + kL * BS;
    const bf16* dos = gs + kL * BS;
    const float* ws = reinterpret_cast<const float*>(base + L::kTiles * L::kTile);

    if (L::kSaveStates) {
      // the state at this chunk's entry
      float* sp = st_out + (size_t)c * N * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[(nt * 8 + 2 * tig + (e & 1)) * N + 16 * warp + gq + 8 * (e >> 1)] = st[nt][e];
    }

    // ---- A: the scaled operands
    {
      const int i = tid & (N - 1);
      float d[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) d[t] = t < len ? -fast_exp2(ws[t * N + i] * kLog2e) : 0.f;
      float run = 0.f;
      if (tid < N) {
        if (kY) {
#pragma unroll
          for (int t = 0; t < kL; ++t) {
            store_limbs(__bfloat162float(rs[t * BS + i]) * fast_exp2(run * kLog2e),
                        rd_hi + t * BS + i, rd_lo + t * BS + i);
            run += d[t];
          }
          ev[i] = expf(run);
        }
      } else {
#pragma unroll
        for (int t = kL - 1; t >= 0; --t) {
          store_limbs(__bfloat162float(ks[t * BS + i]) * fast_exp2(run * kLog2e),
                      kd_hi + t * BS + i, kd_lo + t * BS + i);
          ed[t * FS + i] = fast_exp2(d[t] * kLog2e);
          run += d[t];
        }
        if (!kY) ev[i] = expf(run);
      }
    }
    __syncthreads();

    // ---- B: the scores below the diagonal, without an exponential
    if (kY) {
      chunk_scores<N>(rs, ks, ed, uf, len, part, a_hi, a_lo, tid);
      __syncthreads();
    }

    // ---- C: the products. va = V^T[j][s], rows j of this warp.
    unsigned va[4];
    ldmatrix_x4_trans(va, vs + ld_row * BS + 16 * warp + ld_col);
    if (kY) {
      float y[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
      // y^T += S^T (r exp(c))^T, the state read from its accumulators
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        unsigned ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pair(st[2 * kk + (q >> 1)][2 * (q & 1)], st[2 * kk + (q >> 1)][2 * (q & 1) + 1],
                     ah[q], al[q]);
        unsigned bh_[4], bl_[4];
        ldmatrix_x4(bh_, rd_hi + ld_row * BS + kk * 16 + ld_col);
        ldmatrix_x4(bl_, rd_lo + ld_row * BS + kk * 16 + ld_col);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_m16n8k16(y[nt], ah[0], ah[1], ah[2], ah[3], bh_[2 * nt], bh_[2 * nt + 1]);
          mma_m16n8k16(y[nt], ah[0], ah[1], ah[2], ah[3], bl_[2 * nt], bl_[2 * nt + 1]);
          mma_m16n8k16(y[nt], al[0], al[1], al[2], al[3], bh_[2 * nt], bh_[2 * nt + 1]);
        }
      }
      // y^T += V^T A^T
      {
        unsigned bh_[4], bl_[4];
        ldmatrix_x4(bh_, a_hi + ld_row * kAStride + ld_col);
        ldmatrix_x4(bl_, a_lo + ld_row * kAStride + ld_col);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_m16n8k16(y[nt], va[0], va[1], va[2], va[3], bh_[2 * nt], bh_[2 * nt + 1]);
          mma_m16n8k16(y[nt], va[0], va[1], va[2], va[3], bl_[2 * nt], bl_[2 * nt + 1]);
        }
      }
      // y[nt][e] is step t = 8 nt + 2 tig + e % 2, channel j = 16 warp + gq + 8 (e / 2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ys[(nt * 8 + 2 * tig + (e & 1)) * FS + 16 * warp + gq + 8 * (e >> 1)] = y[nt][e];
    }
    // S^T <- S^T diag(exp(c_L)) + V^T (k exp(c_L - c))
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bh_[4], bl_[4];
      ldmatrix_x4_trans(bh_, kd_hi + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
      ldmatrix_x4_trans(bl_, kd_lo + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nt = 2 * np + q;
        const float e0 = ev[nt * 8 + 2 * tig], e1 = ev[nt * 8 + 2 * tig + 1];
        st[nt][0] *= e0;
        st[nt][1] *= e1;
        st[nt][2] *= e0;
        st[nt][3] *= e1;
        mma_m16n8k16(st[nt], va[0], va[1], va[2], va[3], bh_[2 * q], bh_[2 * q + 1]);
        mma_m16n8k16(st[nt], va[0], va[1], va[2], va[3], bl_[2 * q], bl_[2 * q + 1]);
      }
    }
    if (!kY) continue;
    __syncthreads();

    // ---- D': the raw y of the rows the walk holds, at their times
    if (kMode == kChunkRaw) {
      const int s = c * kL + row;
      if (s < n_steps) {
        const float4* src = reinterpret_cast<const float4*>(ys + row * FS + col8);
        float4* dst = reinterpret_cast<float4*>(
            y32 + (((size_t)b * T_len + step_time(s, n_steps, reverse)) * H + h) * N + col8);
        dst[0] = src[0];
        dst[1] = src[1];
      }
      continue;
    }

    // ---- D: GroupNorm, then the gate or its adjoint; a row past the walk
    // has g = dout = 0 and adds nothing
    {
      float yv[8], gv[8], o[8];
      const float4 y0 = *reinterpret_cast<const float4*>(ys + row * FS + col8);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + row * FS + col8 + 4);
      yv[0] = y0.x; yv[1] = y0.y; yv[2] = y0.z; yv[3] = y0.w;
      yv[4] = y1.x; yv[5] = y1.y; yv[6] = y1.z; yv[7] = y1.w;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += yv[q];
#pragma unroll
      for (int o_ = TPR / 2; o_ > 0; o_ >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      const float mu = sum * (1.f / N);
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        yv[q] -= mu;
        var = fmaf(yv[q], yv[q], var);
      }
#pragma unroll
      for (int o_ = TPR / 2; o_ > 0; o_ >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o_);
      const float rstd = rsqrtf(var * (1.f / N) + eps);
      unpack8(*reinterpret_cast<const uint4*>(gs + row * BS + col8), gv);
      const size_t at = (((size_t)b * T_len + c * kL + row) * H + h) * N + col8;
      if (kMode == kChunkOutput) {
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = fmaf(yv[q] * rstd, sc[q], bi[q]) * gv[q];
        if (row < len) *reinterpret_cast<uint4*>(out + at) = pack8(o);
      } else {
        float dov[8], dz[8];
        unpack8(*reinterpret_cast<const uint4*>(dos + row * BS + col8), dov);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float z = yv[q] * rstd;
          yv[q] = z;
          o[q] = dov[q] * fmaf(z, sc[q], bi[q]);          // dg
          const float dpre = dov[q] * gv[q];
          dsc[q] = fmaf(dpre, z, dsc[q]);
          dbi[q] += dpre;
          dz[q] = dpre * sc[q];
          m1 += dz[q];
          m2 = fmaf(dz[q], z, m2);
        }
#pragma unroll
        for (int o_ = TPR / 2; o_ > 0; o_ >>= 1) {
          m1 += __shfl_xor_sync(0xffffffffu, m1, o_);
          m2 += __shfl_xor_sync(0xffffffffu, m2, o_);
        }
        m1 *= 1.f / N;
        m2 *= 1.f / N;
        if (row < len) {
          *reinterpret_cast<uint4*>(dg_out + at) = pack8(o);
#pragma unroll
          for (int q = 0; q < 8; ++q) dz[q] = rstd * (dz[q] - m1 - yv[q] * m2);
          *reinterpret_cast<float4*>(y32 + at) = make_float4(dz[0], dz[1], dz[2], dz[3]);
          *reinterpret_cast<float4*>(y32 + at + 4) = make_float4(dz[4], dz[5], dz[6], dz[7]);
        }
      }
    }
  }

  if (kMode == kChunkRaw) {
    // y is zero at the times beyond the walk (the rows past lengths[b])
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = n_steps + row; t < T_len; t += kL) {
      float4* dst = reinterpret_cast<float4*>(y32 + (((size_t)b * T_len + t) * H + h) * N + col8);
      dst[0] = z;
      dst[1] = z;
    }
  }
  if (kMode == kChunkOutput || kMode == kChunkRaw) {
    float* sTp = sT + (size_t)bh * N * N;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sTp[(nt * 8 + 2 * tig + (e & 1)) * N + 16 * warp + gq + 8 * (e >> 1)] = st[nt][e];
  } else if (kMode == kChunkAdjoint) {
    // dscale and dbias of this (b, h): each thread's rows, then the block's 16
    // rows in order, through the y tile
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 8; ++q) ys[row * FS + col8 + q] = pass ? dbi[q] : dsc[q];
      __syncthreads();
      if (tid < N) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < kL; ++t) acc += ys[t * FS + tid];
        (pass ? dbi_p : dsc_p)[(size_t)b * H * N + h * N + tid] = acc;
      }
    }
  }
}

}  // namespace rwkv
