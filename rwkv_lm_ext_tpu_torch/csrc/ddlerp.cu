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
// Bound on the card: bytes. One call reads x once and writes six tensors of
// its size (0.94 GB at B=64, T=512, C=2048 in bf16: 0.28 ms at 3.35 TB/s);
// the two low-rank products are 43 GFLOP, 0.04 ms on the bf16 tensor cores
// but 0.64 ms as fp32 FMAs, so they belong on the tensor cores and the
// kernel should then be limited by its stores.
//
// Two bodies; the wrapper (ops/ddlerp.py) picks one from dtype and shape.
//
// Tensor-core body (bf16, C % 8 == 0, D = 32 or 64), tmix_prologue_tc_kernel.
//   * A block owns 64 flattened rows b*T + t, so a tile is full at T = 1 as
//     well; the predecessor (the row before, or shift_ln[b] at t = 0) is
//     chosen per row. The TPU kernel walked T blocks in order and carried the
//     last ln'd row in scratch; blocks here run in no order, so the tile
//     recomputes the LayerNorm statistics of the row before its first.
//   * h = tanh(xxx @ w1) is a 64 x C x 5D product of mma.sync m16n8k16: C is
//     walked in slabs of 64; xxx of a slab is made from x and the row
//     statistics in fp32 and goes into shared memory as two bf16 limbs (hi +
//     lo, about 16 bits): one limb, the TPU kernel's default-precision MXU
//     arithmetic, left xw close to its limit of 1e-2 of the largest value
//     against the fp32 plain version at C = 4096, D = 64; two keep the
//     first version's error, and the product is small beside the stores. h is
//     rounded to bf16 once; accumulation is fp32. The w1 slab arrives by
//     cp.async, double-buffered, so the weights are read once per 64 rows
//     (the first version read them once per 8).
//   * m_i = h_i @ w2[i] walks C in slabs of 64 columns again. The columns of
//     a w2 slab are permuted on their way into shared memory so that the
//     accumulators of one thread cover 8 neighbouring columns: the five
//     lerps, xn and the six stores are the product's epilogue at 16 bytes a
//     thread, a warp storing 64 contiguous bytes of each of 8 rows.
//   * Few tiles (T = 1: one): the column slabs of the second product are
//     spread over gridDim.y blocks, each repeating the small first product,
//     until about two blocks an SM are in flight.
// LayerNorm statistics, xx, the lerps and tanh stay fp32.
//
// CUDA-core body (fp32, and the bf16 shapes the other does not take),
// tmix_prologue_simt_kernel: the first version of this port, 8 rows of one
// batch row a block, both products as fp32 FMAs. It keeps the fp32
// instantiation within 1e-4 of the plain version; no served model runs it.
#include "ddlerp_rows.cuh"

namespace rwkv {

// ------------------------------------------------------------------------
// CUDA-core body
// ------------------------------------------------------------------------

constexpr int kRows = 8;          // rows of T per block
constexpr int kPrologueThreads = 256;
constexpr int kUnroll = 8;        // loads issued together in the product loops
static_assert(kRows == 8, "fma_rows handles exactly 8 rows");

// the transposed xxx is padded with zero columns to a multiple of kUnroll
__host__ __device__ inline int padded_cols(int C) {
  return (C + kUnroll - 1) / kUnroll * kUnroll;
}

static size_t simt_smem_bytes(int C, int D) {
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

// Per block: LayerNorm statistics of kRows + 1 rows (one warp per row), xxx
// of the tile kept transposed in shared memory ((C, kRows) fp32, so one
// float4 pair feeds all rows of a column), the C -> 5D product with one
// thread per output column, h kept transposed the same way, then the 5D -> C
// products and the five lerps with threads striding over C. w1 and w2 are
// read from L2 by every block, kUnroll loads at a time.
template <typename T>
__global__ void __launch_bounds__(kPrologueThreads, 3) tmix_prologue_simt_kernel(
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
static cudaError_t launch_simt(const void* x, const void* shift, const void* ln_scale,
                               const void* ln_bias, const void* maa, const void* w1,
                               const void* w2, void* out, int B, int T_len, int C, int D,
                               float eps, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(C, D);
  cudaError_t e = cudaFuncSetAttribute(
      tmix_prologue_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T_len + kRows - 1) / kRows, B);
  tmix_prologue_simt_kernel<T><<<grid, kPrologueThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(ln_scale), static_cast<const T*>(ln_bias),
      static_cast<const T*>(maa), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), B, T_len, C, D, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Tensor-core body
// ------------------------------------------------------------------------

constexpr int kTileRows = 64;     // flattened rows b*T + t a block owns
constexpr int kTcThreads = 256;   // 8 warps: 4 row tiles of 16 x 2 column halves
constexpr int kSlab = 64;         // columns of C a step of either product takes
// Row strides in shared memory are odd multiples of 16 bytes, so the eight
// rows an ldmatrix reads lie in different banks.
constexpr int kXStride = kSlab + 8;

template <int D>
struct TcLayout {
  static constexpr int kD5 = 5 * D;
  static constexpr int kHStride = kD5 + 8;
  // one staged weight slab: w1 rows [c][5D] or w2 rows [(i, d)][64 columns]
  static constexpr int kW1Elems = kSlab * kHStride;
  static constexpr int kW2Elems = kD5 * kXStride;
  static constexpr int kStageElems = kW1Elems > kW2Elems ? kW1Elems : kW2Elems;
  static constexpr int kXElems = 2 * kTileRows * kXStride;   // xxx of a slab: hi limb, lo limb
  static constexpr int kHElems = kTileRows * kHStride;
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kStageElems + 2 * kXElems + kHElems) + sizeof(float) * 2 * (kTileRows + 2);
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 32 ? 2 : 1) tmix_prologue_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ shift,
    const bf16* __restrict__ ln_scale, const bf16* __restrict__ ln_bias,
    const bf16* __restrict__ maa, const bf16* __restrict__ w1,
    const bf16* __restrict__ w2, bf16* __restrict__ out, int M, int T_len, int C, float eps) {
  using L = TcLayout<D>;
  constexpr int D5 = L::kD5, HS = L::kHStride;
  constexpr int NT1 = D5 / 16;      // 8-wide column tiles of h a warp owns
  static_assert(NT1 % 2 == 0, "column tiles are loaded in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);        // 2 x kStageElems
  bf16* sX = stage + 2 * L::kStageElems;                  // 2 x 2 limbs x (64, kXStride)
  bf16* sH = sX + 2 * L::kXElems;                         // (64, HS)
  float* stats = reinterpret_cast<float*>(sH + L::kHElems);   // (65, 2): mu, rstd

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kTileRows;
  const int n_slabs = (C + kSlab - 1) / kSlab;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  tile_stats(x, stats, m0, kTileRows, M, C, eps);
  __syncthreads();

  // ---- product 1: h = tanh(xxx @ w1) ------------------------------------
  // xxx of a slab: thread (row tid / 4, 16 columns) from two words of the row
  // and two of its predecessor, fetched one slab ahead
  const RowRef mine = make_row(x, shift, stats, m0, tid >> 2, M, T_len, C);
  const int cq = (tid & 3) * 16;
  uint4 xq[2], pq[2], scq[2], biq[2], mxq[2];
  auto fetch_x = [&](int slab) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = slab * kSlab + cq + hf * 8;
      const bool on = mine.valid && c < C;
      xq[hf] = on ? ldg16(mine.cur + c) : zero4;
      pq[hf] = on ? ldg16(mine.prev + c) : zero4;
      scq[hf] = on ? ldg16(ln_scale + c) : zero4;
      biq[hf] = on ? ldg16(ln_bias + c) : zero4;
      mxq[hf] = on ? ldg16(maa + c) : zero4;
    }
  };
  auto store_xxx = [&](int slab, bf16* dst) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = slab * kSlab + cq + hf * 8;
      float o[8], lo[8];
      if (mine.valid && c < C) {
        float sc[8], bi[8], mx[8], xn[8], xx[8];
        unpack8(scq[hf], sc);
        unpack8(biq[hf], bi);
        unpack8(mxq[hf], mx);
        ln_pair(mine, xq[hf], pq[hf], sc, bi, xn, xx);
#pragma unroll
        for (int j = 0; j < 8; ++j) split_bf16(fmaf(xx[j], mx[j], xn[j]), o[j], lo[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = lo[j] = 0.f;
      }
      bf16* d = dst + (tid >> 2) * kXStride + cq + hf * 8;
      *reinterpret_cast<uint4*>(d) = pack8(o);
      *reinterpret_cast<uint4*>(d + kTileRows * kXStride) = pack8(lo);
    }
  };
  // rows c of w1 (5D values each); rows past C are zeros
  auto stage_w1 = [&](int slab, bf16* dst) {
    constexpr int kChunks = D5 / 8;
    for (int idx = tid; idx < kSlab * kChunks; idx += kTcThreads) {
      const int kr = idx / kChunks, ch = idx - kr * kChunks;
      bf16* d = dst + kr * HS + ch * 8;
      const int c = slab * kSlab + kr;
      if (c < C) cp_async_16(d, w1 + (size_t)c * D5 + ch * 8);
      else *reinterpret_cast<uint4*>(d) = zero4;
    }
  };

  const int rt = warp & 3, half = warp >> 2;
  float acc1[NT1][4];
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[nt][e] = 0.f;

  stage_w1(0, stage);
  fetch_x(0);
  store_xxx(0, sX);
  for (int s = 0; s < n_slabs; ++s) {
    // slab s has landed and everyone is done with slab s - 1, whose buffers
    // slab s + 1 takes
    cp_async_wait_all();
    __syncthreads();
    const bf16* wS = stage + (s & 1) * L::kStageElems;
    const bf16* xS = sX + (s & 1) * L::kXElems;
    if (s + 1 < n_slabs) {
      stage_w1(s + 1, stage + ((s + 1) & 1) * L::kStageElems);
      fetch_x(s + 1);
    }
#pragma unroll
    for (int ks = 0; ks < kSlab / 16; ++ks) {
      unsigned a[4], al[4];
      const bf16* ap = xS + (rt * 16 + (lane & 15)) * kXStride + ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(a, ap);
      ldmatrix_x4(al, ap + kTileRows * kXStride);
#pragma unroll
      for (int np = 0; np < NT1 / 2; ++np) {
        unsigned bq[4];
        ldmatrix_x4_trans(bq, wS + (ks * 16 + (lane & 15)) * HS + half * NT1 * 8 + np * 16 +
                                  (lane >> 4) * 8);
        mma_m16n8k16(acc1[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(acc1[2 * np + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        mma_m16n8k16(acc1[2 * np], al[0], al[1], al[2], al[3], bq[0], bq[1]);
        mma_m16n8k16(acc1[2 * np + 1], al[0], al[1], al[2], al[3], bq[2], bq[3]);
      }
    }
    if (s + 1 < n_slabs) store_xxx(s + 1, sX + ((s + 1) & 1) * L::kXElems);
  }
#pragma unroll
  for (int nt = 0; nt < NT1; ++nt) {
    const int col = half * NT1 * 8 + nt * 8 + 2 * tig;
    *reinterpret_cast<unsigned*>(sH + (rt * 16 + g) * HS + col) =
        pack_bf16(tanhf(acc1[nt][0]), tanhf(acc1[nt][1]));
    *reinterpret_cast<unsigned*>(sH + (rt * 16 + g + 8) * HS + col) =
        pack_bf16(tanhf(acc1[nt][2]), tanhf(acc1[nt][3]));
  }
  __syncthreads();   // h is complete; the w1 buffers are free

  // ---- product 2 and the lerps ------------------------------------------
  // A slab holds 64 columns of every w2 row (i, d). Within each group of 32
  // columns, column c sits at position (c % 8 / 2) * 8 + 2 * (c / 8) + c % 2:
  // the accumulator (tile nt, pair e) of thread tig is then column
  // 8 * tig + 2 * nt + e, eight neighbours a thread.
  // A thread copies one pair of columns of every 8th row: its place in a row
  // and its source column are fixed, only the row moves.
  static_assert(kSlab / 2 == 32 && kTcThreads % 32 == 0 && D5 % (kTcThreads / 32) == 0,
                "a warp copies one row of column pairs");
  const int w2_c = 2 * lane;                      // column of the slab, 0 .. 62
  const int w2_at = (w2_c & 32) + (((w2_c & 31) & 7) >> 1) * 8 + 2 * ((w2_c & 31) >> 3);
  auto stage_w2 = [&](int slab, bf16* dst) {
    constexpr int kRowsAPass = kTcThreads / 32;
    const int col = slab * kSlab + w2_c;
    bf16* d = dst + warp * kXStride + w2_at;
    const bf16* src = w2 + (size_t)warp * C + col;
#pragma unroll 4
    for (int n = 0; n < D5 / kRowsAPass; ++n, d += kRowsAPass * kXStride, src += (size_t)kRowsAPass * C) {
      if (col < C) cp_async_4(d, src);
      else *reinterpret_cast<unsigned*>(d) = 0u;
    }
  };
  const RowRef rows[2] = {make_row(x, shift, stats, m0, rt * 16 + g, M, T_len, C),
                          make_row(x, shift, stats, m0, rt * 16 + g + 8, M, T_len, C)};
  const size_t plane = (size_t)M * C;

  int it = 0;
  if ((int)blockIdx.y < n_slabs) stage_w2(blockIdx.y, stage);
  for (int s = blockIdx.y; s < n_slabs; s += gridDim.y, ++it) {
    cp_async_wait_all();
    __syncthreads();
    const bf16* wS = stage + (it & 1) * L::kStageElems;
    if (s + (int)gridDim.y < n_slabs)
      stage_w2(s + gridDim.y, stage + ((it + 1) & 1) * L::kStageElems);

    const int c0 = s * kSlab + half * 32 + tig * 8;   // this thread's 8 columns
    const bool col_on = c0 < C;
    float xn[2][8], xx[2][8];
    // every word this slab's epilogue needs is asked for at once
    uint4 mq[5], xw[2], pw[2];
#pragma unroll
    for (int i = 0; i < 5; ++i) mq[i] = col_on ? ldg16(maa + (size_t)(i + 1) * C + c0) : zero4;
    if (col_on) {
      const uint4 scw = ldg16(ln_scale + c0), biw = ldg16(ln_bias + c0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        xw[rr] = rows[rr].valid ? ldg16(rows[rr].cur + c0) : zero4;
        pw[rr] = rows[rr].valid ? ldg16(rows[rr].prev + c0) : zero4;
      }
      float sc[8], bi[8];
      unpack8(scw, sc);
      unpack8(biw, bi);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool on = rows[rr].valid;
        ln_pair(rows[rr], xw[rr], pw[rr], sc, bi, xn[rr], xx[rr]);
        if (on)
          *reinterpret_cast<uint4*>(out + 5 * plane + (size_t)(m0 + rt * 16 + g + 8 * rr) * C + c0) =
              pack8(xn[rr]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, sH + (rt * 16 + (lane & 15)) * HS + i * D + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, wS + (i * D + ks * 16 + (lane & 15)) * kXStride + half * 32 +
                                    np * 16 + (lane >> 4) * 8);
          mma_m16n8k16(acc[2 * np], a[0], a[1], a[2], a[3], bq[0], bq[1]);
          mma_m16n8k16(acc[2 * np + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        }
      }
      if (col_on) {
        float mi[8];
        unpack8(mq[i], mi);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (rows[rr].valid) {
            float o[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              o[j] = fmaf(xx[rr][j], mi[j] + acc[j >> 1][2 * rr + (j & 1)], xn[rr][j]);
            *reinterpret_cast<uint4*>(out + i * plane +
                                      (size_t)(m0 + rt * 16 + g + 8 * rr) * C + c0) = pack8(o);
          }
        }
      }
      __syncwarp();   // the lanes meet again before the next mma
    }
  }
}

// blocks along y: 1 when the row tiles alone fill the card twice over
static int column_split(int tiles, int n_slabs) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 132;
  }
  int split = 2 * sms / tiles;
  if (split < 1) split = 1;
  return split < n_slabs ? split : n_slabs;
}

template <int D>
static cudaError_t launch_tc(const void* x, const void* shift, const void* ln_scale,
                             const void* ln_bias, const void* maa, const void* w1,
                             const void* w2, void* out, int B, int T_len, int C, float eps,
                             cudaStream_t stream) {
  const size_t smem = TcLayout<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      tmix_prologue_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int M = B * T_len;
  const int tiles = (M + kTileRows - 1) / kTileRows;
  const int n_slabs = (C + kSlab - 1) / kSlab;
  dim3 grid(tiles, column_split(tiles, n_slabs));
  tmix_prologue_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(shift),
      static_cast<const bf16*>(ln_scale), static_cast<const bf16*>(ln_bias),
      static_cast<const bf16*>(maa), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(out), M, T_len, C, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

// body codes shared with ops/ddlerp.py
enum { kBodySimt = 0, kBodyTensorCore = 1 };

// Dynamic shared memory one block of `body` needs at (C, D); the wrapper
// checks it against the card's opt-in limit before launching.
extern "C" long long rwkv_tmix_prologue_smem_bytes(int C, int D, int body) {
  if (body == kBodyTensorCore)
    return (long long)(D == 64 ? rwkv::TcLayout<64>::kBytes : rwkv::TcLayout<32>::kBytes);
  return (long long)rwkv::simt_smem_bytes(C, D);
}

extern "C" int rwkv_tmix_prologue(const void* x, const void* shift,
                                  const void* ln_scale, const void* ln_bias,
                                  const void* maa, const void* w1,
                                  const void* w2, void* out, int B, int T_len,
                                  int C, int D, float eps, int dtype, int body,
                                  void* stream) {
  using namespace rwkv;
  if (D <= 0 || D % kUnroll != 0) return cudaErrorInvalidValue;
  if (B <= 0 || T_len <= 0 || C <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (body == kBodyTensorCore) {
    if (dtype != kBFloat16 || C % 8 != 0 || (long long)B * T_len > 0x7fffff00LL)
      return cudaErrorInvalidValue;
    if (D == 32) return launch_tc<32>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, eps, s);
    if (D == 64) return launch_tc<64>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, eps, s);
    return cudaErrorInvalidValue;
  }
  if (body != kBodySimt) return cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return launch_simt<float>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, D, eps, s);
    case kBFloat16:
      return launch_simt<__nv_bfloat16>(x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T_len, C, D, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
