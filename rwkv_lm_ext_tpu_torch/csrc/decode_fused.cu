// B.10, B.11, B.12: the T=1 decode "glue" between the big projections, each
// as one wrapper call over (B, C) rows.
//
// Replace the TPU kernels of rwkv_lm_ext_tpu/ops/decode_fused.py:
//   B.10 _att_prep_kernel (:101, launched by att_prep_fused :159)
//        ln1 + token shift + ddlerp (tanh(xxx @ w1) @ w2 five ways) + the fp32
//        decay low-rank w = time_decay + tanh(xw @ dw1) @ dw2;
//   B.11 _ffn_prep_kernel (:251, ffn_prep_fused :270)
//        ln2 + token shift + the k and r mixes;
//   B.12 _ffn_block_kernel (:354, ffn_block_fused :416)
//        B.11, then k = relu(xk @ Wk)^2, kv = k @ Wv, r = xr @ Wr and
//        out = x + sigmoid(r) * kv.
//
// Precision, as the Pallas kernels: LayerNorm (variance max(E[x^2] - mu^2, 0)),
// the shift difference and every lerp add in fp32; the ddlerp low-rank on
// operands rounded to the compute dtype T with fp32 accumulation; the decay
// low-rank on fp32 operands (xw is never rounded); in B.12 k is rounded to T
// before relu^2 and after it, kv and r stay fp32, the residual add is fp32 and
// is cast once. No atomics anywhere: every sum has a fixed order, so two calls
// give the same bits.
//
// What the TPU versions work around and these do not: rows in multiples of 8,
// a VMEM row cap, C and F in multiples of 512, and a sequential grid that
// carries VMEM scratch from step to step. Here any B >= 1 runs; the widths the
// kernels need are stated at each entry point.
//
// Bounds on the card. B.10 and B.11 move a few (B, C) rows (B.10: 2 read, 6
// written, under 2 MB at B=64) and B.10 reads 1.8-2.3 MB of low-rank weights;
// neither is bound by bytes or operations but by the latency of dependent
// steps. B.10 has two bodies: the cluster body (bf16, every served width;
// design above att_prep_cluster_kernel), which spreads each row over the C
// slices of a thread-block cluster, and the row-pair body (fp32, and the bf16
// shapes the other does not take): two rows a block, 512 threads, every weight
// read with 16-byte loads that serve both rows; the two C-deep reductions
// (C -> 5D, C -> Dd) split C over thread groups and add the groups' partial
// sums in increasing order from shared memory; the two expansions (5 x D -> C,
// Dd -> C) are column-parallel. B.12 is bound by the bytes of its three weight
// matrices (2 C F + C C values, read once): its design is in the comment above
// ffn_stream_kernel.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <mutex>
#include <type_traits>

#include "mma.cuh"

namespace rwkv {

constexpr int kPrepRows = 2;        // rows a B.10 block takes
constexpr int kPrepThreads = 512;
constexpr int kPrepMaxGroups = 32;  // C-slices of a B.10 reduction

// 16 bytes of T or P values as floats
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// LayerNorm of one row into shared memory, fp32: xn = ln(x), xx = shift - xn.
// Every thread of the block calls it; ends with a barrier.
template <typename T, typename P>
__device__ __forceinline__ void ln_shift_row(const T* __restrict__ x,
                                             const float* __restrict__ shift,
                                             const P* __restrict__ ln_scale,
                                             const P* __restrict__ ln_bias, int C,
                                             float eps, float* xn, float* xx,
                                             float* red) {
  float s = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = to_f(x[c]);
    s += v;
    s2 = fmaf(v, v, s2);
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float mu = s / C;
  const float var = fmaxf(s2 / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float n = fmaf((to_f(x[c]) - mu) * rstd, to_f(ln_scale[c]), to_f(ln_bias[c]));
    xn[c] = n;
    xx[c] = shift[c] - n;
  }
  __syncthreads();
}

// out[r][j] = sum_c a[r][c] * w[c][j] for the block's rows, w (C, J) row-major
// of W values, J a multiple of Vec16<W>::kN. Thread groups take every G-th c;
// their partial sums go to `part` and are added in increasing group order.
// a: shared (kPrepRows, C) fp32. out: shared (kPrepRows, J). `fn` maps each sum.
template <typename W, typename Fn>
__device__ __forceinline__ void reduce_over_c(const float* a, const W* __restrict__ w,
                                              int C, int J, float* part, float* out,
                                              Fn fn) {
  constexpr int V = Vec16<W>::kN;
  const int P = J / V;                                    // column groups
  const int G = min(kPrepMaxGroups, (int)blockDim.x / P); // C-slices
  const int t = threadIdx.x;
  if (t < G * P) {
    const int g = t / P, j0 = (t % P) * V;
    float acc[kPrepRows][V];
#pragma unroll
    for (int r = 0; r < kPrepRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
#pragma unroll 4
    for (int c = g; c < C; c += G) {
      float wv[V];
      Vec16<W>::load(w + (size_t)c * J + j0, wv);
#pragma unroll
      for (int r = 0; r < kPrepRows; ++r) {
        const float av = a[r * C + c];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(av, wv[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < kPrepRows; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) part[(g * kPrepRows + r) * J + j0 + v] = acc[r][v];
  }
  __syncthreads();
  for (int o = t; o < kPrepRows * J; o += blockDim.x) {
    const int r = o / J, j = o % J;
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[(g * kPrepRows + r) * J + j];
    out[o] = fn(s);
  }
  __syncthreads();
}

// B.10, row-pair body. Grid: ceil(B / kPrepRows) blocks of kPrepThreads.
// Dynamic shared memory: att_prep_smem(C, D, Dd).
template <typename T, typename P>
__global__ void __launch_bounds__(kPrepThreads) att_prep_kernel(
    const T* __restrict__ x, const float* __restrict__ shift,
    const P* __restrict__ ln_scale, const P* __restrict__ ln_bias,
    const P* __restrict__ maas, const T* __restrict__ w1, const T* __restrict__ w2,
    const P* __restrict__ dw1, const P* __restrict__ dw2,
    const P* __restrict__ time_decay, T* __restrict__ xr, T* __restrict__ xk,
    T* __restrict__ xv, T* __restrict__ xg, float* __restrict__ w_out,
    float* __restrict__ xn_out, int B, int C, int D, int Dd, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kPrepThreads / 32];
  constexpr int R = kPrepRows;
  constexpr int VT = Vec16<T>::kN, VP = Vec16<P>::kN;
  const int J = 5 * D, Jmax = max(J, Dd);
  float* xn = smem;                 // (R, C) ln1 output
  float* xx = xn + R * C;           // (R, C) shift - xn
  float* xa = xx + R * C;           // (R, C) xxx rounded to T, then xw in fp32
  float* h = xa + R * C;            // (R, Jmax) tanh outputs
  float* part = h + R * Jmax;       // (groups, R, Jmax) partial sums
  const int row0 = blockIdx.x * R;
  const int t = threadIdx.x;

  for (int r = 0; r < R; ++r) {
    // a row beyond B repeats the last one; its outputs are not stored
    const size_t row = min(row0 + r, B - 1);
    ln_shift_row(x + row * C, shift + row * C, ln_scale, ln_bias, C, eps, xn + r * C,
                 xx + r * C, red);
  }
  for (int o = t; o < R * C; o += kPrepThreads) {
    const int c = o % C;
    xa[o] = to_f(from_f<T>(fmaf(xx[o], to_f(maas[c]), xn[o])));
  }
  __syncthreads();
  // h = tanh(xxx @ w1), rounded to T as the operand of the second product
  reduce_over_c<T>(xa, w1, C, J, part, h,
                   [](float s) { return to_f(from_f<T>(tanhf(s))); });

  // the five expansions m_i = h_i @ w2[i] and the mixes; xw stays in fp32
  const int CG = C / VT;
  for (int item = t; item < 5 * CG; item += kPrepThreads) {
    const int i = item / CG, c0 = (item % CG) * VT;
    float acc[R][VT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < VT; ++v) acc[r][v] = 0.f;
    const T* wp = w2 + (size_t)i * D * C + c0;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float wv[VT];
      Vec16<T>::load(wp + (size_t)d * C, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = h[r * J + i * D + d];
#pragma unroll
        for (int v = 0; v < VT; ++v) acc[r][v] = fmaf(hv, wv[v], acc[r][v]);
      }
    }
    T* dst = i == 1 ? xk : i == 2 ? xv : i == 3 ? xr : xg;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mixed[VT];
#pragma unroll
      for (int v = 0; v < VT; ++v) {
        const int c = c0 + v;
        mixed[v] = fmaf(xx[r * C + c], to_f(maas[(1 + i) * C + c]) + acc[r][v], xn[r * C + c]);
      }
      if (i == 0) {
#pragma unroll
        for (int v = 0; v < VT; ++v) xa[r * C + c0 + v] = mixed[v];
      } else if (row0 + r < B) {
        Vec16<T>::store(dst + (size_t)(row0 + r) * C + c0, mixed);
      }
    }
  }
  __syncthreads();
  // hw = tanh(xw @ dw1) on fp32 operands
  reduce_over_c<P>(xa, dw1, C, Dd, part, h, [](float s) { return tanhf(s); });

  // w = time_decay + hw @ dw2; the ln1 rows go out unrounded
  const int CGp = C / VP;
  for (int item = t; item < CGp; item += kPrepThreads) {
    const int c0 = item * VP;
    float acc[R][VP];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < VP; ++v) acc[r][v] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dd; ++d) {
      float wv[VP];
      Vec16<P>::load(dw2 + (size_t)d * C + c0, wv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float hv = h[r * Dd + d];
#pragma unroll
        for (int v = 0; v < VP; ++v) acc[r][v] = fmaf(hv, wv[v], acc[r][v]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r >= B) break;
#pragma unroll
      for (int v = 0; v < VP; ++v)
        w_out[(size_t)(row0 + r) * C + c0 + v] = to_f(time_decay[c0 + v]) + acc[r][v];
    }
  }
  for (int o = t; o < R * C; o += kPrepThreads) {
    const int r = o / C;
    if (row0 + r < B) xn_out[(size_t)row0 * C + o] = xn[o];
  }
}

static size_t att_prep_smem(int C, int D, int Dd) {
  const size_t jmax = (size_t)(5 * D > Dd ? 5 * D : Dd);
  return sizeof(float) * kPrepRows * (3 * (size_t)C + jmax * (1 + kPrepMaxGroups));
}

// ---- B.10, cluster body (bf16, the shapes att_prep_cluster_takes names) ----
//
// The row-pair body above walks all the low-rank weights (1.8 MB at the 1B6
// widths) in every block through four serial phases of dependent loads, so it
// takes the same ~60 us at B=1 as at B=64. Here a cluster of kPrepSlices
// blocks takes a group of up to kClusterRows rows, and block q of the cluster
// owns columns [q C/S, (q+1) C/S) of every phase:
//   * at entry each block starts the tensor-memory-accelerator copies of its
//     own weight slices (w1 rows, w2 columns, dw1 rows, dw2 columns) into a
//     ring of kPrepSlots slabs, each slab a few 64-column boxes with the
//     128-byte swizzle; none depends on x, so the first slabs land while the
//     LayerNorm runs, and each slab consumed frees a slot for the next. (On
//     an H100, 16-byte cp.async from every thread, and one bulk copy a row,
//     each cost more than the work they fed; a few boxes a slab do not.)
//   * the three reductions over C (the row sums of x and x^2, the partial
//     h = xxx @ w1 and the partial xw @ dw1) are exchanged through
//     distributed shared memory and summed in rank order after a cluster
//     barrier, so every block holds the same bits;
//   * each block then expands its own columns: the five h_i @ w2[i] with the
//     mixes and the stores, and w = time_decay + tanh(xw @ dw1) @ dw2.
// All four products run on mma.sync: the rows are the 16 x 16 A operand (at
// most 8 of them live), a weight slab the B operand through ldmatrix. The
// decay products keep fp32 operands: xw and tanh(xw @ dw1) enter as three
// bf16 limbs each, which hold an fp32 value exactly, against the bf16
// weights, so every product is exact and only the fp32 sums round. A cluster
// moves C/S of the weights per block; the row groups are sized so that one
// wave of clusters takes all B rows (B=1: one cluster, B=64: eight). What is
// left is latency: each phase is a chain of dependent shared-memory and
// tensor-core steps behind a slab barrier, so blocks have 16 warps (8 were
// slower on an H100) and warp 0, which also refills the ring, takes the
// fewest columns.
constexpr int kPrepSlices = 8;       // blocks of a cluster (the portable size)
constexpr int kClusterRows = 8;      // most rows a cluster takes
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kPrepSlots = 5;        // slabs of the weight ring
constexpr int kPrepSlot = 16384;     // bytes of a slab
constexpr int kMaxJPairs = 2;        // 16-column pairs of 5D a warp owns: 5D <= 384
constexpr int kMaxSliceCols = 512;   // C / kPrepSlices
constexpr int kMaxDecayRank = 128;   // Dd
// the (C,) parameters a block stages: maas (6 rows), ln_scale, ln_bias, time_decay
constexpr int kPrepVecs = 9;

// rows a cluster takes: as many clusters as the card runs at once
// (`clusters`), up to kClusterRows rows each
__host__ __device__ inline int att_prep_cluster_rows(int B, int clusters) {
  const int r = (B + clusters - 1) / clusters;
  return r < 1 ? 1 : r > kClusterRows ? kClusterRows : r;
}

__host__ __device__ inline bool att_prep_cluster_takes(int C, int D, int Dd) {
  return C % (16 * kPrepSlices) == 0 && C / kPrepSlices <= kMaxSliceCols && D > 0 &&
         D % 8 == 0 && 5 * D <= 16 * kClusterWarps * kMaxJPairs && Dd > 0 && Dd % 16 == 0 &&
         Dd <= kMaxDecayRank;
}

// Shared memory of the cluster body, in bytes from a 1024-byte aligned start.
// The four weight streams: 0 = w1 rows (C/S of them, 5D columns), 1 = w2 rows
// (i, d) over the block's C/S columns, 2 = dw1 rows (C/S, Dd columns), 3 =
// dw2 rows (Dd) over the block's columns. A slab of stream p is slab_rows[p]
// rows of boxes[p] boxes of 64 columns, box after box, each row 128 bytes.
struct PrepLayout {
  int Cs, J, xas, hs, ds;
  int rows[4], boxes[4], slab_rows[4], slabs[4], first[4], total;
  int o_ring, o_bars, o_vec, o_xn, o_xx, o_xa, o_xw, o_h, o_hw, o_hp, o_hwp, o_part, o_stats;
  int o_rowstat;
  int bytes;
};

__host__ __device__ inline PrepLayout prep_layout(int C, int D, int Dd) {
  PrepLayout L;
  L.Cs = C / kPrepSlices;
  L.J = 5 * D;
  L.xas = L.Cs + 8;                        // bf16 row stride of the xxx and xw tiles
  L.hs = (L.J + 15) / 16 * 16 + 8;         // of the h tile
  L.ds = Dd + 8;                           // of the tanh(xw @ dw1) tile
  const int rows[4] = {L.Cs, (L.J + 15) / 16 * 16, L.Cs, Dd};
  const int cols[4] = {L.J, L.Cs, Dd, L.Cs};
  L.total = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    L.rows[p] = rows[p];
    L.boxes[p] = (cols[p] + 63) / 64;
    int sr = kPrepSlot / (128 * L.boxes[p]) / 16 * 16;
    sr = sr > 256 ? 256 : sr;                        // a box holds at most 256 rows
    sr = sr > rows[p] ? rows[p] : sr;                // rows[p] is a multiple of 16
    L.slab_rows[p] = sr;
    L.slabs[p] = (rows[p] + sr - 1) / sr;
    L.first[p] = L.total;
    L.total += L.slabs[p];
  }
  const int fr = 4 * kClusterRows * L.Cs;  // bytes of one (rows, C/S) fp32 buffer
  int o = 0;
  L.o_ring = o; o += kPrepSlots * kPrepSlot;
  L.o_bars = o; o += 16 * kPrepSlots;     // 8 bytes a barrier; the buffers stay 16-byte aligned
  L.o_vec = o; o += 2 * kPrepVecs * L.Cs;  // the block's columns of the (C,) parameters
  L.o_xn = o; o += fr;
  L.o_xx = o; o += fr;
  L.o_xa = o;                              // xxx, then limb 0 of xw
  L.o_xw = o; o += 3 * 2 * 16 * L.xas;
  L.o_h = o; o += 2 * 16 * L.hs;
  L.o_hw = o; o += 3 * 2 * 16 * L.ds;
  L.o_hp = o; o += 4 * kClusterRows * L.J;
  L.o_hwp = o; o += 4 * kClusterRows * Dd;
  L.o_part = o; o += 4 * kClusterRows * 2 * kMaxDecayRank;
  L.o_stats = o; o += 4 * 2 * kClusterRows;
  L.o_rowstat = o; o += 4 * 2 * kClusterRows;
  L.bytes = o + 1024;                      // room to align the start
  return L;
}

// A barrier of the whole cluster that orders each block's shared-memory
// writes before the other blocks' reads after it (release / acquire at
// cluster scope, without the device-wide fence of cluster_group::sync).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// x = l0 + l1 + l2 exactly: three bf16 limbs hold an fp32 significand
__device__ __forceinline__ void split3(float x, __nv_bfloat16& l0, __nv_bfloat16& l1,
                                       __nv_bfloat16& l2) {
  l0 = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(l0);
  l1 = __float2bfloat16_rn(r);
  l2 = __float2bfloat16_rn(r - __bfloat162float(l1));
}

// The B operand of mma.sync for 16 slab rows from `row` and the 16 columns
// from `col0` (a pair of 8-column tiles), from a slab of 64-column boxes
__device__ __forceinline__ void slab_b(unsigned* bq, const unsigned char* slab, int slab_rows,
                                       int row, int col0, int lane) {
  const int col = col0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(bq, slab + (col >> 6) * slab_rows * 128 +
                            swz(row + (lane & 15), (col & 63) >> 3));
}

// The tensor maps of one B.10 call: w1 (C, 5D), w2 as (5D, C), dw1 (C, Dd),
// dw2 (Dd, C), in boxes of 64 columns by the slab rows of their stream.
struct PrepMaps {
  CUtensorMap w1, w2, dw1, dw2;
};

// Grid (kPrepSlices, ceil(B / R)), clusters of (kPrepSlices, 1, 1), blocks
// of kClusterThreads, dynamic shared memory prep_layout(...).bytes. A row
// beyond B repeats the last one; its outputs are not stored.
__global__ void __launch_bounds__(kClusterThreads) att_prep_cluster_kernel(
    const __grid_constant__ PrepMaps maps, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ ln_scale,
    const __nv_bfloat16* __restrict__ ln_bias, const __nv_bfloat16* __restrict__ maas,
    const __nv_bfloat16* __restrict__ time_decay, __nv_bfloat16* __restrict__ xr,
    __nv_bfloat16* __restrict__ xk, __nv_bfloat16* __restrict__ xv,
    __nv_bfloat16* __restrict__ xg, float* __restrict__ w_out, float* __restrict__ xn_out,
    int B, int C, int D, int Dd, int R, float eps) {
  using bf16 = __nv_bfloat16;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const PrepLayout L = prep_layout(C, D, Dd);
  const int Cs = L.Cs, J = L.J, XAS = L.xas, HS = L.hs, DS = L.ds;
  const int q = (int)cluster.block_rank(), c0 = q * Cs;
  const int row0 = blockIdx.y * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the column pairs of the products go to the warps from the last: warp 0
  // also refills the ring, so it takes the fewest
  const int wr = kClusterWarps - 1 - warp;
  const int g = lane >> 2, tig = lane & 3;
  unsigned char* ring = sm + L.o_ring;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm + L.o_bars);
  bf16* vec = reinterpret_cast<bf16*>(sm + L.o_vec);        // (9, Cs) maas, ln, time_decay
  float* xn = reinterpret_cast<float*>(sm + L.o_xn);        // (8, Cs) ln1 rows
  float* xx = reinterpret_cast<float*>(sm + L.o_xx);        // (8, Cs) shift - xn
  bf16* xa = reinterpret_cast<bf16*>(sm + L.o_xa);          // (16, XAS) xxx in bf16
  bf16* xwl = reinterpret_cast<bf16*>(sm + L.o_xw);         // 3 x (16, XAS) limbs of xw
  bf16* hT = reinterpret_cast<bf16*>(sm + L.o_h);           // (16, HS) tanh(xxx @ w1)
  bf16* hwl = reinterpret_cast<bf16*>(sm + L.o_hw);         // 3 x (16, DS) limbs of tanh(xw @ dw1)
  float* hp = reinterpret_cast<float*>(sm + L.o_hp);        // (8, J) this block's part of xxx @ w1
  float* hwp = reinterpret_cast<float*>(sm + L.o_hwp);      // (8, Dd) its part of xw @ dw1
  float* part = reinterpret_cast<float*>(sm + L.o_part);    // k groups' partial sums
  float* stats = reinterpret_cast<float*>(sm + L.o_stats);        // (8, 2) its row sums
  float* rowstat = reinterpret_cast<float*>(sm + L.o_rowstat);    // (8, 2) mu, rstd

  // The weight ring: slab s of the four streams in order goes to slot
  // s % kPrepSlots; the slot's barrier completes a phase when its boxes have
  // landed. Thread 0 issues.
  if (tid == 0) {
    for (int i = 0; i < kPrepSlots; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // warp 0 refills: lane 0 expects the slab's bytes, lane b copies box b
  auto issue = [&](int s) {
    if (s >= L.total) return;
    const int p = s >= L.first[3] ? 3 : s >= L.first[2] ? 2 : s >= L.first[1] ? 1 : 0;
    const CUtensorMap* map = p == 0 ? &maps.w1 : p == 1 ? &maps.w2 : p == 2 ? &maps.dw1 : &maps.dw2;
    const int sr = p == 0 ? L.slab_rows[0] : p == 1 ? L.slab_rows[1] : p == 2 ? L.slab_rows[2] : L.slab_rows[3];
    const int nb = p == 0 ? L.boxes[0] : p == 1 ? L.boxes[1] : p == 2 ? L.boxes[2] : L.boxes[3];
    const int fs = p == 0 ? L.first[0] : p == 1 ? L.first[1] : p == 2 ? L.first[2] : L.first[3];
    const int r0 = (s - fs) * sr;
    // streams 0 and 2 are rows of the block's own C slice; 1 and 3 columns of it
    const int row = (p == 0 || p == 2) ? c0 + r0 : r0, col = (p == 1 || p == 3) ? c0 : 0;
    unsigned char* dst = ring + (s % kPrepSlots) * kPrepSlot;
    unsigned long long* bar = bars + s % kPrepSlots;
    if (lane == 0) mbar_expect_tx(bar, (unsigned)(nb * sr * 128));
    __syncwarp();
    if (lane < nb) tma_load_2d(dst + lane * sr * 128, map, col + 64 * lane, row, bar);
  };
  // slab s has landed and every thread is done with the slab before it,
  // whose slot now takes the slab kPrepSlots - 1 ahead
  auto acquire = [&](int s) -> const unsigned char* {
    mbar_wait(bars + s % kPrepSlots, (s / kPrepSlots) & 1);
    __syncthreads();
    if (warp == 0) issue(s + kPrepSlots - 1);
    return ring + (s % kPrepSlots) * kPrepSlot;
  };
  if (warp == 0)
    for (int s = 0; s < kPrepSlots - 1; ++s) issue(s);
  // the block's columns of maas, ln_scale, ln_bias and time_decay
  for (int i = tid; i < kPrepVecs * Cs / 8; i += kClusterThreads) {
    const int v = i / (Cs / 8), cl = (i - v * (Cs / 8)) * 8;
    const bf16* src = v < 6 ? maas + (size_t)v * C : v == 6 ? ln_scale : v == 7 ? ln_bias : time_decay;
    *reinterpret_cast<uint4*>(vec + v * Cs + cl) = __ldg(reinterpret_cast<const uint4*>(src + c0 + cl));
  }

  // ---- row sums over the block's columns; warp r takes row r
  if (warp < R) {
    const size_t row = min(row0 + warp, B - 1);
    float s1 = 0.f, s2 = 0.f;
    for (int cl = lane * 8; cl < Cs; cl += 256) {
      float v[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(x + row * C + c0 + cl)), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xn[warp * Cs + cl + e] = v[e];
        s1 += v[e];
        s2 = fmaf(v[e], v[e], s2);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      stats[2 * warp] = s1;
      stats[2 * warp + 1] = s2;
    }
  }
  // the A tiles: rows beyond R are zeros (and h's columns beyond 5D)
  for (int l = 0; l < 3; ++l) {
    unsigned* t = reinterpret_cast<unsigned*>(xwl + l * 16 * XAS + R * XAS);
    for (int i = tid; i < (16 - R) * XAS / 2; i += kClusterThreads) t[i] = 0u;
    t = reinterpret_cast<unsigned*>(hwl + l * 16 * DS + R * DS);
    for (int i = tid; i < (16 - R) * DS / 2; i += kClusterThreads) t[i] = 0u;
  }
  for (int i = tid; i < 16 * HS / 2; i += kClusterThreads) reinterpret_cast<unsigned*>(hT)[i] = 0u;
  cluster_barrier();
  if (tid < R) {
    float s1 = 0.f, s2 = 0.f;
    for (int rank = 0; rank < kPrepSlices; ++rank) {
      const float* st = cluster.map_shared_rank(stats, rank);
      s1 += st[2 * tid];
      s2 += st[2 * tid + 1];
    }
    const float mu = s1 / C;
    rowstat[2 * tid] = mu;
    rowstat[2 * tid + 1] = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);
  }
  __syncthreads();
  for (int o = tid; o < R * Cs; o += kClusterThreads) {
    const int r = o / Cs, cl = o - r * Cs, c = c0 + cl;
    const size_t row = min(row0 + r, B - 1);
    const float n = fmaf((xn[o] - rowstat[2 * r]) * rowstat[2 * r + 1], to_f(vec[6 * Cs + cl]),
                         to_f(vec[7 * Cs + cl]));
    const float d = shift[row * C + c] - n;
    xn[o] = n;
    xx[o] = d;
    xa[r * XAS + cl] = __float2bfloat16_rn(fmaf(d, to_f(vec[cl]), n));
    if (row0 + r < B) xn_out[(size_t)(row0 + r) * C + c] = n;
  }
  __syncthreads();

  // ---- this block's part of xxx @ w1: warp 15 - w takes the column pairs w, w + 16, ..
  const int NP = (J + 15) / 16;
  {
    float acc[kMaxJPairs][2][4] = {};
    for (int j = 0; j < L.slabs[0]; ++j) {
      const unsigned char* slab = acquire(L.first[0] + j);
      const int r0 = j * L.slab_rows[0];
      const int steps = min(L.slab_rows[0], Cs - r0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, xa + (lane & 15) * XAS + r0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pi = 0; pi < kMaxJPairs; ++pi) {
          const int p = wr + pi * kClusterWarps;
          if (p >= NP) continue;
          unsigned bq[4];
          slab_b(bq, slab, L.slab_rows[0], ks * 16, p * 16, lane);
          mma_m16n8k16(acc[pi][0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
          mma_m16n8k16(acc[pi][1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        }
      }
    }
    // accumulator (pi, h, e < 2): row g, column (wr + 16 pi) 16 + 8 h + 2 tig + e
#pragma unroll
    for (int pi = 0; pi < kMaxJPairs; ++pi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = (wr + pi * kClusterWarps) * 16 + h * 8 + 2 * tig;
        if (g < R && n < J) {
          hp[g * J + n] = acc[pi][h][0];
          hp[g * J + n + 1] = acc[pi][h][1];
        }
      }
  }
  cluster_barrier();
  for (int o = tid; o < R * J; o += kClusterThreads) {
    float s = 0.f;
    for (int rank = 0; rank < kPrepSlices; ++rank) s += cluster.map_shared_rank(hp, rank)[o];
    const int r = o / J;
    hT[r * HS + o - r * J] = __float2bfloat16_rn(tanhf(s));
  }
  __syncthreads();

  // ---- the five expansions h_i @ w2[i] over the block's columns, each
  // followed by its mix: xw as three limbs into shared memory, the other
  // four stored. Warp 15 - w takes the column pairs w, w + 16, ..
  const int NPC = Cs / 16;
  {
    float acc[kMaxSliceCols / (16 * kClusterWarps)][2][4];
    int cur = 0;
    auto zero = [&] {
#pragma unroll
      for (int pi = 0; pi < kMaxSliceCols / (16 * kClusterWarps); ++pi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[pi][h][e] = 0.f;
    };
    auto flush = [&](int i) {
      bf16* dst = i == 1 ? xk : i == 2 ? xv : i == 3 ? xr : xg;
#pragma unroll
      for (int pi = 0; pi < kMaxSliceCols / (16 * kClusterWarps); ++pi) {
        if (wr + pi * kClusterWarps >= NPC || g >= R) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cl = (wr + pi * kClusterWarps) * 16 + h * 8 + 2 * tig, c = c0 + cl;
          float mixed[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mixed[e] = fmaf(xx[g * Cs + cl + e], to_f(vec[(1 + i) * Cs + cl + e]) + acc[pi][h][e],
                            xn[g * Cs + cl + e]);
          if (i == 0) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              split3(mixed[e], xwl[g * XAS + cl + e], xwl[16 * XAS + g * XAS + cl + e],
                     xwl[32 * XAS + g * XAS + cl + e]);
          } else if (row0 + g < B) {
            *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row0 + g) * C + c) =
                __floats2bfloat162_rn(mixed[0], mixed[1]);
          }
        }
      }
    };
    zero();
    for (int j = 0; j < L.slabs[1]; ++j) {
      const unsigned char* slab = acquire(L.first[1] + j);
      const int r0 = j * L.slab_rows[1];
      const int steps = min(L.slab_rows[1], L.rows[1] - r0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        const int kk = r0 + ks * 16;      // row (i, d) = i D + d of the step's first
        unsigned a[4];
        ldmatrix_x4(a, hT + (lane & 15) * HS + kk + (lane >> 4) * 8);
        const int i_hi = min(4, (kk + 15) / D);
        for (int i = kk / D; i <= i_hi; ++i) {
          if (i != cur) {
            flush(cur);
            zero();
            cur = i;
          }
          // a step that straddles two of the five: keep the k of expansion i
          const int k_lo = kk + 2 * tig, k_hi = k_lo + 8;
          const bool on_lo = k_lo >= i * D && k_lo < (i + 1) * D;
          const bool on_hi = k_hi >= i * D && k_hi < (i + 1) * D;
          const unsigned a0 = on_lo ? a[0] : 0u, a1 = on_lo ? a[1] : 0u;
          const unsigned a2 = on_hi ? a[2] : 0u, a3 = on_hi ? a[3] : 0u;
#pragma unroll
          for (int pi = 0; pi < kMaxSliceCols / (16 * kClusterWarps); ++pi) {
            const int p = wr + pi * kClusterWarps;
            if (p >= NPC) continue;
            unsigned bq[4];
            slab_b(bq, slab, L.slab_rows[1], ks * 16, p * 16, lane);
            mma_m16n8k16(acc[pi][0], a0, a1, a2, a3, bq[0], bq[1]);
            mma_m16n8k16(acc[pi][1], a0, a1, a2, a3, bq[2], bq[3]);
          }
        }
      }
    }
    flush(cur);
  }
  __syncthreads();

  // ---- this block's part of xw @ dw1: warp 15 - w takes column pair w % (Dd
  // / 16) and every G-th k step from w / (Dd / 16); the G groups' tiles are
  // added in order
  {
    const int NPD = Dd / 16, G = kClusterWarps / NPD, pd = wr % NPD, grp = wr / NPD;
    float acc[2][4] = {};
    for (int j = 0; j < L.slabs[2]; ++j) {
      const unsigned char* slab = acquire(L.first[2] + j);
      const int r0 = j * L.slab_rows[2];
      const int steps = min(L.slab_rows[2], Cs - r0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        if ((r0 / 16 + ks) % G != grp) continue;
        unsigned bq[4];
        slab_b(bq, slab, L.slab_rows[2], ks * 16, pd * 16, lane);
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          unsigned a[4];
          ldmatrix_x4(a, xwl + l * 16 * XAS + (lane & 15) * XAS + r0 + ks * 16 + (lane >> 4) * 8);
          mma_m16n8k16(acc[0], a[0], a[1], a[2], a[3], bq[0], bq[1]);
          mma_m16n8k16(acc[1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = pd * 16 + h * 8 + 2 * tig;
      if (g < R) {
        part[(grp * kClusterRows + g) * Dd + n] = acc[h][0];
        part[(grp * kClusterRows + g) * Dd + n + 1] = acc[h][1];
      }
    }
    __syncthreads();
    for (int o = tid; o < R * Dd; o += kClusterThreads) {
      float s = 0.f;
      for (int gi = 0; gi < G; ++gi) s += part[gi * kClusterRows * Dd + o];
      hwp[o] = s;
    }
  }
  cluster_barrier();
  for (int o = tid; o < R * Dd; o += kClusterThreads) {
    float s = 0.f;
    for (int rank = 0; rank < kPrepSlices; ++rank) s += cluster.map_shared_rank(hwp, rank)[o];
    const int r = o / Dd, j = o - r * Dd;
    split3(tanhf(s), hwl[r * DS + j], hwl[16 * DS + r * DS + j], hwl[32 * DS + r * DS + j]);
  }
  __syncthreads();

  // ---- w = time_decay + tanh(xw @ dw1) @ dw2 over the block's columns:
  // warp 15 - w takes the column pairs w, w + 16, ..
  {
    float acc[kMaxSliceCols / (16 * kClusterWarps)][2][4] = {};
    for (int j = 0; j < L.slabs[3]; ++j) {
      const unsigned char* slab = acquire(L.first[3] + j);
      const int r0 = j * L.slab_rows[3];
      const int steps = min(L.slab_rows[3], Dd - r0) / 16;
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[3][4];
#pragma unroll
        for (int l = 0; l < 3; ++l)
          ldmatrix_x4(a[l], hwl + l * 16 * DS + (lane & 15) * DS + r0 + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pi = 0; pi < kMaxSliceCols / (16 * kClusterWarps); ++pi) {
          const int p = wr + pi * kClusterWarps;
          if (p >= NPC) continue;
          unsigned bq[4];
          slab_b(bq, slab, L.slab_rows[3], ks * 16, p * 16, lane);
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            mma_m16n8k16(acc[pi][0], a[l][0], a[l][1], a[l][2], a[l][3], bq[0], bq[1]);
            mma_m16n8k16(acc[pi][1], a[l][0], a[l][1], a[l][2], a[l][3], bq[2], bq[3]);
          }
        }
      }
    }
#pragma unroll
    for (int pi = 0; pi < kMaxSliceCols / (16 * kClusterWarps); ++pi) {
      if (wr + pi * kClusterWarps >= NPC || g >= R || row0 + g >= B) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cl = (wr + pi * kClusterWarps) * 16 + h * 8 + 2 * tig, c = c0 + cl;
        *reinterpret_cast<float2*>(w_out + (size_t)(row0 + g) * C + c) =
            make_float2(to_f(vec[8 * Cs + cl]) + acc[pi][h][0], to_f(vec[8 * Cs + cl + 1]) + acc[pi][h][1]);
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster_barrier();
}

// B.11, and the first phase of B.12 (kSignal: let the key product start
// streaming its weights at once). One block a row; a row is read once and
// its work is one global round trip and one block barrier deep:
//   * at entry every thread issues all its loads, none of which depends on
//     the statistics: a chunk of eight values of x, of shift (fp32) and of
//     the four (C,) vectors, 16 or 32 bytes each (kVec), into registers;
//   * the row sums (s, s2) of its chunk, then one float2 shuffle tree a warp,
//     the warp partials through shared memory and one barrier, after which
//     every thread adds the partials in increasing warp order (so all hold
//     the same bits, and no second barrier is needed);
//   * LayerNorm, the shift difference and both mixes from registers, stored
//     as 16-byte words.
// The block has ffn_prep_threads(C) threads, one chunk each up to C = 8 x
// kFfnPrepMaxThreads. Without kVec (C % 8 != 0, a longer row, or a pointer
// not 16-byte aligned) thread t takes chunks t, t + threads, ... with scalar
// loads and reads x twice; the sums keep the same order (a thread's chunks in
// turn, eight values each, then the same trees), which
// ops/decode_fused.py:ffn_prep_warp_order_plain repeats.
constexpr int kFfnPrepMaxThreads = 512;

__host__ __device__ inline int ffn_prep_threads(int C) {
  const int warps = ((C + 7) / 8 + 31) / 32;
  return warps * 32 > kFfnPrepMaxThreads ? kFfnPrepMaxThreads : warps * 32;
}

// eight values of T, P or fp32 as floats: one or two 16-byte words
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
#pragma unroll
  for (int i = 0; i < 8; i += Vec16<T>::kN) Vec16<T>::load(p + i, f + i);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* f) {
#pragma unroll
  for (int i = 0; i < 8; i += Vec16<T>::kN) Vec16<T>::store(p + i, f + i);
}

template <typename T, typename P, bool kSignal, bool kVec>
__global__ void __launch_bounds__(kFfnPrepMaxThreads) ffn_prep_kernel(
    const T* __restrict__ x, const float* __restrict__ shift,
    const P* __restrict__ ln_scale, const P* __restrict__ ln_bias,
    const P* __restrict__ maa_k, const P* __restrict__ maa_r, T* __restrict__ xk,
    T* __restrict__ xr, float* __restrict__ xn_out, int C, float eps) {
  __shared__ float2 part[kFfnPrepMaxThreads / 32];
  if (kSignal) grid_dependents_launch();
  const size_t base = (size_t)blockIdx.x * C;
  const int t = threadIdx.x, threads = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  float2 s = make_float2(0.f, 0.f);
  // kVec: this thread's chunk, every load issued here
  const int c0 = 8 * t;
  const bool mine = kVec && c0 < C;
  float xv[8], sh[8], sc[8], bi[8], mk[8], mr[8];
  if (mine) {
    load8(x + base + c0, xv);
    load8(shift + base + c0, sh);
    load8(ln_scale + c0, sc);
    load8(ln_bias + c0, bi);
    load8(maa_k + c0, mk);
    load8(maa_r + c0, mr);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s.x += xv[e];
      s.y = fmaf(xv[e], xv[e], s.y);
    }
  }
  if (!kVec) {
    for (int c = 8 * t; c < C; c += 8 * threads)
      for (int e = c; e < c + 8 && e < C; ++e) {
        const float v = to_f(x[base + e]);
        s.x += v;
        s.y = fmaf(v, v, s.y);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
  }
  if (lane == 0) part[warp] = s;
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  for (int i = 0; i < threads / 32; ++i) {
    total.x += part[i].x;
    total.y += part[i].y;
  }
  const float mu = total.x / C;
  const float var = fmaxf(total.y / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (mine) {
    float n[8], ok[8], orr[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      n[e] = fmaf((xv[e] - mu) * rstd, sc[e], bi[e]);
      const float d = sh[e] - n[e];
      ok[e] = fmaf(d, mk[e], n[e]);
      orr[e] = fmaf(d, mr[e], n[e]);
    }
    store8(xk + base + c0, ok);
    store8(xr + base + c0, orr);
    store8(xn_out + base + c0, n);
  }
  if (!kVec) {
    for (int c = t; c < C; c += threads) {
      const float n = fmaf((to_f(x[base + c]) - mu) * rstd, to_f(ln_scale[c]), to_f(ln_bias[c]));
      const float d = shift[base + c] - n;
      xk[base + c] = from_f<T>(fmaf(d, to_f(maa_k[c]), n));
      xr[base + c] = from_f<T>(fmaf(d, to_f(maa_r[c]), n));
      xn_out[base + c] = n;
    }
  }
}

// B.12's products, bf16. All three have the form out[b][n] = sum_k X[b][k] W[n][k]
// with torch-layout weights W (N, K), both operands contiguous along k and B
// small: the weights' 67 MB (1B6) set the time, so every weight byte comes
// from device memory once and each SM keeps enough of them in flight.
//
// The grid-wide dependency (kv needs every F tile of k) is met by separate
// launches behind one wrapper: (1) ffn_prep_kernel, (2) the key product, whose
// epilogue rounds to bf16, applies relu^2 and stores k (B, F) in bf16 as
// scratch (0.9 MB at B=64), (3) the value product split over F into
// ffn_value_splits slices plus, as more blocks of the same launch, the
// receptance product, each slice storing an fp32 (B, C) partial, (4)
// ffn_out_kernel, which adds the kv slices in increasing order and writes
// x + sigmoid(r) * kv. Launches (2)-(4) are programmatic dependent launches:
// each starts while the one before it runs, streams the first stages of its
// weights (which depend on nothing) and waits for its predecessor's results
// only before it reads them.
//
// A block owns 64 weight rows (outputs), 16 (B <= 16) or 64 batch rows and
// one k slice. k advances in stages of 256: a stage holds the 64 weight rows
// and the batch rows as tensor-map boxes of 64 values with the 128-byte
// swizzle (rows and k past the tensors arrive as zeros), issued by one thread
// and counted on the stage's mbarrier, in a ring of 5 (16 batch rows) or 3
// stages of 40 or 64 KB. Stages this wide are what set the rate: each stage
// costs the block a barrier, and with narrower ones the barriers, not the
// bytes, took the time on an H100. Each
// activation stage is read once per block from L2, so activation traffic is
// (N / 64) times the activations, at most the weight bytes. 8 warps: with 64
// batch rows, warp w takes weight rows (w % 4) 16.. +16 and batch rows (w / 4)
// 32.. +32; with 16, the k steps of parity w / 4, the two parities' tiles
// added in order at the end. The products run on mma.sync m16n8k16, the
// weight tile as the A operand (ldmatrix) and the activations as B (ldmatrix,
// k-contiguous rows are B's column layout). The fp32 tile goes out through
// shared memory in rows of 256 contiguous bytes. The value product's slices
// are chosen so that value and receptance blocks together about fill the SMs
// once, with about the same weight bytes per block.
constexpr int kGemmThreads = 256;
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr int kStreamRows = 64;       // weight rows (outputs) a block owns
constexpr int kStreamBoxes = 4;       // boxes of kBoxCols k values a stage holds an operand
constexpr int kStreamK = kStreamBoxes * kBoxCols;
constexpr int kSplitK = 4;            // most slices of the value product

// A block's batch rows (16 for B <= 16, else 64) set its stage size and the
// stages that fit in about 200 KB: 4 or 2 in flight while one is consumed.
template <int kXRows>
struct StreamShape {
  static constexpr int kStageBytes = (kStreamRows + kXRows) * 128 * kStreamBoxes;
  static constexpr int kStages = kXRows == 16 ? 5 : 3;
  // stages (1024-byte aligned for the 128-byte swizzle), then a barrier each
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 8 * kStages;
};

// One product: out = X W^T over one k slice, X (B, K) and W (N, K) reached
// through tensor maps of 64-value boxes (W: 64 rows, X: kXRows rows) with the
// 128-byte swizzle; rows and k beyond the tensors come in as zeros.
struct StreamProblem {
  CUtensorMap tw, tx;
  void* out;                // kKey: (B, N) bf16; else (slices + 1, B, N) fp32
  int K, N;
  int tiles;                // ceil(N / kStreamRows)
  int splits;               // k slices
  int slot0;                // partial of slice 0
};

// slice s of `splits` over ceil(K / kStreamK) stages: [s per, min(stages, (s + 1) per))
__host__ __device__ inline int stream_slice_begin(int stages, int splits, int s) {
  const int per = (stages + splits - 1) / splits;
  const int b = s * per;
  return b < stages ? b : stages;
}

// Grid (units, ceil(B / kXRows)): units of p0 (tile-major, then slice) and
// then of p1. kKey: store relu(round(acc))^2 as bf16; else the fp32 partial.
template <bool kKey, int kXRows>
__global__ void __launch_bounds__(kGemmThreads) ffn_stream_kernel(
    const __grid_constant__ StreamProblem p0, const __grid_constant__ StreamProblem p1, int B) {
  using Shape = StreamShape<kXRows>;
  constexpr int S = Shape::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tiles =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);   // 1024-byte aligned
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(tiles + S * Shape::kStageBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  int unit = blockIdx.x;
  const bool second = unit >= p0.tiles * p0.splits;
  const StreamProblem& p = second ? p1 : p0;
  if (second) unit -= p0.tiles * p0.splits;
  const int tile = unit / p.splits, slice = unit - tile * p.splits;
  const int n0 = tile * kStreamRows, b0 = blockIdx.y * kXRows;
  const int stages = (p.K + kStreamK - 1) / kStreamK;
  const int k_begin = stream_slice_begin(stages, p.splits, slice);
  const int steps = stream_slice_begin(stages, p.splits, slice + 1) - k_begin;

  // Stage s: the weight box (64 rows from n0, k from (k_begin + s) 64) and
  // the activation box (kXRows rows from b0), both counted on the stage's
  // barrier. Thread 0 issues; the weights need nothing from the kernel
  // ahead, so their first stages go out before the wait.
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue_w = [&](int s) {
    if (s >= steps) return;
    unsigned long long* bar = bars + s % S;
    mbar_expect_tx(bar, Shape::kStageBytes);
    for (int j = 0; j < kStreamBoxes; ++j)
      tma_load_2d(tiles + (s % S) * Shape::kStageBytes + j * kStreamRows * 128, &p.tw,
                  (k_begin + s) * kStreamK + j * kBoxCols, n0, bar);
  };
  auto issue_x = [&](int s) {
    if (s >= steps) return;
    for (int j = 0; j < kStreamBoxes; ++j)
      tma_load_2d(tiles + (s % S) * Shape::kStageBytes + (kStreamBoxes * kStreamRows + j * kXRows) * 128,
                  &p.tx, (k_begin + s) * kStreamK + j * kBoxCols, b0, bars + s % S);
  };
  if (tid == 0)
    for (int s = 0; s < S - 1; ++s) issue_w(s);
  grid_dependency_wait();
  grid_dependents_launch();
  if (tid == 0)
    for (int s = 0; s < S - 1; ++s) issue_x(s);

  // 64 batch rows: warp w takes weight rows (w % 4) 16.. +16 and batch rows
  // (w / 4) 32.. +32, every k step. 16 batch rows: weight rows (w % 4) 16..
  // +16, all 16 batch rows, the k steps of parity w / 4; the two parities'
  // tiles are added in order at the end.
  constexpr int NT = kXRows == 64 ? 4 : 2;    // 8-row batch tiles a warp holds
  const int wm = (warp & 3) * 16;
  const int wb = kXRows == 64 ? (warp >> 2) * 32 : 0;
  const int par = kXRows == 64 ? 0 : warp >> 2;
  const bool live = b0 + wb < B;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int s = 0; s < steps; ++s) {
    mbar_wait(bars + s % S, (s / S) & 1);
    __syncthreads();                  // every warp is done with stage s - 1's slot
    if (tid == 0) {
      issue_w(s + S - 1);
      issue_x(s + S - 1);
    }
    const unsigned char* sw = tiles + (s % S) * Shape::kStageBytes;
    const unsigned char* sx = sw + kStreamBoxes * kStreamRows * 128;
    if (!live) continue;
#pragma unroll
    for (int ks = 0; ks < kStreamK / 16; ++ks) {
      if (kXRows == 16 && (ks & 1) != par) continue;
      unsigned a[4];
      // k step ks lies in box ks / 4, its 16-byte chunks 2 (ks % 4) and + 1
      const int box = ks >> 2, kc = (ks & 3) * 2;
      ldmatrix_x4(a, sw + box * kStreamRows * 128 + swz(wm + (lane & 15), kc + (lane >> 4)));
#pragma unroll
      for (int bp = 0; bp < NT / 2; ++bp) {
        // matrices (batch 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        unsigned bq[4];
        ldmatrix_x4(bq, sx + box * kXRows * 128 +
                            swz(wb + bp * 16 + (lane & 7) + ((lane >> 4) << 3), kc + ((lane >> 3) & 1)));
        mma_m16n8k16(acc[2 * bp], a[0], a[1], a[2], a[3], bq[0], bq[1]);
        mma_m16n8k16(acc[2 * bp + 1], a[0], a[1], a[2], a[3], bq[2], bq[3]);
      }
    }
  }
  __syncthreads();

  // fp32 tiles (parity, batch row, weight row) through shared memory;
  // accumulator (t, e): weight row wm + g + 8 (e / 2), batch row wb + 8 t + 2 tig + e % 2
  constexpr int OS = kStreamRows + 4;
  constexpr int kParities = kXRows == 64 ? 1 : 2;
  float* o = reinterpret_cast<float*>(tiles);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[(par * kXRows + wb + 8 * t + 2 * tig + (e & 1)) * OS + wm + g + 8 * (e >> 1)] = acc[t][e];
  __syncthreads();
  for (int i = tid; i < kXRows * (kStreamRows / 4); i += kGemmThreads) {
    const int bl = i / (kStreamRows / 4), nl = (i % (kStreamRows / 4)) * 4;
    const int b = b0 + bl, n = n0 + nl;
    if (b >= B || n >= p.N) continue;
    float4 v = *reinterpret_cast<const float4*>(o + bl * OS + nl);
    if (kParities == 2) {
      const float4 w = *reinterpret_cast<const float4*>(o + (kXRows + bl) * OS + nl);
      v = make_float4(v.x + w.x, v.y + w.y, v.z + w.z, v.w + w.w);
    }
    if (kKey) {
      float f[4] = {v.x, v.y, v.z, v.w};
      __nv_bfloat162 h[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float k0 = fmaxf(to_f(__float2bfloat16_rn(f[2 * j])), 0.f);
        const float k1 = fmaxf(to_f(__float2bfloat16_rn(f[2 * j + 1])), 0.f);
        h[j] = __floats2bfloat162_rn(k0 * k0, k1 * k1);
      }
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + (size_t)b * p.N + n) =
          *reinterpret_cast<const uint2*>(h);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                 ((size_t)(p.slot0 + slice) * B + b) * p.N + n) = v;
    }
  }
}

// Slices of the value product: enough that value and receptance blocks
// together about fill `sms` SMs once, at most kSplitK.
__host__ __device__ inline int ffn_value_splits(int C, int F, int sms) {
  const int tiles = (C + kStreamRows - 1) / kStreamRows;
  int s = (2 * (sms - tiles) + tiles) / (2 * tiles);   // round((sms - tiles) / tiles)
  s = s < 1 ? 1 : s > kSplitK ? kSplitK : s;
  const int stages = (F + kStreamK - 1) / kStreamK;
  return s > stages ? stages : s;
}

// The same products for fp32 models, on fp32 FMAs. A warp owns 4 weight rows
// and 8 batch rows; its lanes stride over k with 16-byte loads and the 32
// sums meet in a shuffle tree. Grid: (ceil(N / 32), 1 or 2, ceil(B / 8)); the
// second y is the receptance product. One slice each, so ffn_out_kernel sees
// kv in slice 0 and r in slice 1.
constexpr int kF32Rows = 4, kF32Batch = 8;

template <bool kKey>
__global__ void __launch_bounds__(kGemmThreads) ffn_gemm_f32_kernel(
    const float* __restrict__ X0, const float* __restrict__ W0, int K0,
    const float* __restrict__ X1, const float* __restrict__ W1, int K1,
    float* __restrict__ out, int B, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* X = blockIdx.y ? X1 : X0;
  const float* W = blockIdx.y ? W1 : W0;
  const int K = blockIdx.y ? K1 : K0;
  const int n0 = (blockIdx.x * kGemmWarps + warp) * kF32Rows, b0 = blockIdx.z * kF32Batch;
  if (n0 >= N) return;
  float acc[kF32Rows][kF32Batch];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
    for (int j = 0; j < kF32Batch; ++j) acc[i][j] = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    float4 wv[kF32Rows];
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + (size_t)min(n0 + i, N - 1) * K + k);
#pragma unroll
    for (int j = 0; j < kF32Batch; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(X + (size_t)min(b0 + j, B - 1) * K + k);
#pragma unroll
      for (int i = 0; i < kF32Rows; ++i) {
        float s = acc[i][j];
        s = fmaf(wv[i].x, xv.x, s);
        s = fmaf(wv[i].y, xv.y, s);
        s = fmaf(wv[i].z, xv.z, s);
        s = fmaf(wv[i].w, xv.w, s);
        acc[i][j] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
#pragma unroll
    for (int j = 0; j < kF32Batch; ++j) {
      const float s = warp_sum(acc[i][j]);
      const int n = n0 + i, b = b0 + j;
      if (lane == 0 && n < N && b < B) {
        if (kKey) {
          const float kf = fmaxf(s, 0.f);
          out[(size_t)b * N + n] = kf * kf;
        } else {
          out[((size_t)blockIdx.y * B + b) * N + n] = s;
        }
      }
    }
}

// out = x + sigmoid(r) * kv, kv the sum of `slices` partials in increasing
// order, r the partial after them. partials: (slices + 1, B, C) fp32. In the
// bf16 route a dependent launch: it waits for the products here.
template <typename T>
__global__ void __launch_bounds__(256) ffn_out_kernel(const T* __restrict__ x,
                                                      const float* __restrict__ partials,
                                                      T* __restrict__ out, size_t total,
                                                      int slices) {
  grid_dependency_wait();
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float kv = 0.f;
  for (int s = 0; s < slices; ++s) kv += partials[(size_t)s * total + i];
  const float r = partials[(size_t)slices * total + i];
  out[i] = from_f<T>(fmaf(1.f / (1.f + expf(-r)), kv, to_f(x[i])));
}

// A tensor map of a row-major bf16 (rows, cols) tensor in boxes of 64 values
// by box_rows rows, the 128-byte swizzle, zeros beyond its edges. Encoded by
// cuTensorMapEncodeTiled, which the runtime hands out, so the library links
// no libcuda; kept in a table keyed by address and shape, because every
// decode step asks for the same ones again.
static cudaError_t stream_map(CUtensorMap* map, const void* base, int rows, int cols,
                              int box_rows) {
  // ctypes lets go of Python's lock during a call: two threads may be here
  static std::mutex lock;
  const std::lock_guard<std::mutex> held(lock);
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  struct Entry {
    const void* base;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 1024, kProbe = 8;
  static Entry cache[kEntries];
  const size_t key = reinterpret_cast<size_t>(base) / 256 * 31 + (size_t)rows * 131 +
                     (size_t)cols * 7 + (size_t)box_rows;
  const int home = (int)(key % kEntries);
  for (int i = 0; i < kProbe; ++i) {
    const Entry& e = cache[(home + i) % kEntries];
    if (e.base == base && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  int slot = home;                         // the first free probe, else the home slot
  for (int i = 0; i < kProbe; ++i)
    if (!cache[(home + i) % kEntries].base) {
      slot = (home + i) % kEntries;
      break;
    }
  cache[slot] = Entry{base, rows, cols, box_rows, *map};
  return cudaSuccess;
}

// B.10's bodies, by the codes of ops/decode_fused.py B10_BODIES
enum { kPrepBodyRowPairs = 0, kPrepBodyCluster = 1 };

static int att_prep_auto_body(int C, int D, int Dd, int dtype, int pdtype) {
  return dtype == kBFloat16 && pdtype == kBFloat16 && att_prep_cluster_takes(C, D, Dd)
             ? kPrepBodyCluster
             : kPrepBodyRowPairs;
}

static cudaError_t launch_att_prep_cluster(const void* x, const void* shift, const void* ln_scale,
                                           const void* ln_bias, const void* maas, const void* w1,
                                           const void* w2, const void* dw1, const void* dw2,
                                           const void* time_decay, void* xr, void* xk, void* xv,
                                           void* xg, void* w_out, void* xn_out, int B, int C,
                                           int D, int Dd, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const PrepLayout L = prep_layout(C, D, Dd);
  cudaError_t err = cudaFuncSetAttribute(att_prep_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  PrepMaps maps;
  err = stream_map(&maps.w1, w1, C, 5 * D, L.slab_rows[0]);
  if (err == cudaSuccess) err = stream_map(&maps.w2, w2, 5 * D, C, L.slab_rows[1]);
  if (err == cudaSuccess) err = stream_map(&maps.dw1, dw1, C, Dd, L.slab_rows[2]);
  if (err == cudaSuccess) err = stream_map(&maps.dw2, dw2, Dd, C, L.slab_rows[3]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPrepSlices, 1);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPrepSlices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters the card runs at once with this much shared memory, asked once
  // per device and size: the row groups are sized so that one wave holds them
  static std::mutex lock;
  static int cached_device = -1, cached_bytes = -1, cached_clusters = 1;
  int device = 0, clusters = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    const std::lock_guard<std::mutex> held(lock);
    if (device != cached_device || L.bytes != cached_bytes) {
      err = cudaOccupancyMaxActiveClusters(&clusters, att_prep_cluster_kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      cached_device = device;
      cached_bytes = L.bytes;
      cached_clusters = clusters;
    }
    clusters = cached_clusters;
  }
  const int R = att_prep_cluster_rows(B, clusters);
  cfg.gridDim = dim3(kPrepSlices, (B + R - 1) / R);
  err = cudaLaunchKernelEx(
      &cfg, att_prep_cluster_kernel, maps, static_cast<const bf*>(x),
      static_cast<const float*>(shift), static_cast<const bf*>(ln_scale),
      static_cast<const bf*>(ln_bias), static_cast<const bf*>(maas),
      static_cast<const bf*>(time_decay), static_cast<bf*>(xr), static_cast<bf*>(xk),
      static_cast<bf*>(xv), static_cast<bf*>(xg), static_cast<float*>(w_out),
      static_cast<float*>(xn_out), B, C, D, Dd, R, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename P>
static cudaError_t launch_att_prep(const void* x, const void* shift, const void* ln_scale,
                                   const void* ln_bias, const void* maas, const void* w1,
                                   const void* w2, const void* dw1, const void* dw2,
                                   const void* time_decay, void* xr, void* xk, void* xv,
                                   void* xg, void* w_out, void* xn_out, int B, int C, int D,
                                   int Dd, float eps, int body, cudaStream_t stream) {
  if (body == kPrepBodyCluster) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && std::is_same<P, __nv_bfloat16>::value)
      return launch_att_prep_cluster(x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2,
                                        time_decay, xr, xk, xv, xg, w_out, xn_out, B, C, D, Dd,
                                        eps, stream);
    return cudaErrorInvalidValue;
  }
  if (body != kPrepBodyRowPairs) return cudaErrorInvalidValue;
  const size_t smem = att_prep_smem(C, D, Dd);
  cudaError_t err = cudaFuncSetAttribute(att_prep_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  att_prep_kernel<T, P><<<(B + kPrepRows - 1) / kPrepRows, kPrepThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(shift),
      static_cast<const P*>(ln_scale), static_cast<const P*>(ln_bias),
      static_cast<const P*>(maas), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const P*>(dw1), static_cast<const P*>(dw2),
      static_cast<const P*>(time_decay), static_cast<T*>(xr), static_cast<T*>(xk),
      static_cast<T*>(xv), static_cast<T*>(xg), static_cast<float*>(w_out),
      static_cast<float*>(xn_out), B, C, D, Dd, eps);
  return cudaGetLastError();
}

// a launch that may start before the kernel ahead of it ends (see
// grid_dependency_wait in mma.cuh)
template <typename... Params, typename... Args>
static cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// B.12's key product, then its value and receptance products, both as
// dependent launches
// B.12's key product, then its value and receptance products, both as
// dependent launches

// B.12's launches after its host work (the tensor maps, the attributes):
// prep() launches the prologue, then the key product and the value and
// receptance products follow as dependent launches, so that the key
// product's weights start streaming while the prologue runs.
template <int kXRows, typename Prep>
static cudaError_t launch_ffn_products(Prep prep, const void* xk, const void* xr, const void* wk,
                                       const void* wv, const void* wr, void* k, void* partials,
                                       int B, int C, int F, int splits, cudaStream_t s) {
  constexpr int smem = StreamShape<kXRows>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(ffn_stream_kernel<true, kXRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ffn_stream_kernel<false, kXRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned bz = (B + kXRows - 1) / kXRows;
  const int tiles_f = (F + kStreamRows - 1) / kStreamRows, tiles_c = (C + kStreamRows - 1) / kStreamRows;
  StreamProblem key{}, value{}, recept{};
  key.out = k, key.K = C, key.N = F, key.tiles = tiles_f, key.splits = 1, key.slot0 = 0;
  value.out = partials, value.K = F, value.N = C, value.tiles = tiles_c, value.splits = splits,
  value.slot0 = 0;
  recept.out = partials, recept.K = C, recept.N = C, recept.tiles = tiles_c, recept.splits = 1,
  recept.slot0 = splits;
  if (err == cudaSuccess) err = stream_map(&key.tw, wk, F, C, kStreamRows);
  if (err == cudaSuccess) err = stream_map(&key.tx, xk, B, C, kXRows);
  if (err == cudaSuccess) err = stream_map(&value.tw, wv, C, F, kStreamRows);
  if (err == cudaSuccess) err = stream_map(&value.tx, k, B, F, kXRows);
  if (err == cudaSuccess) err = stream_map(&recept.tw, wr, C, C, kStreamRows);
  if (err == cudaSuccess) err = stream_map(&recept.tx, xr, B, C, kXRows);
  if (err != cudaSuccess) return err;
  err = prep();
  if (err != cudaSuccess) return err;
  err = launch_dependent(ffn_stream_kernel<true, kXRows>, dim3(tiles_f, bz), kGemmThreads, smem, s,
                         key, key, B);
  if (err != cudaSuccess) return err;
  return launch_dependent(ffn_stream_kernel<false, kXRows>, dim3(tiles_c * (splits + 1), bz),
                          kGemmThreads, smem, s, value, recept, B);
}

template <typename T, typename P, bool kSignal = false>
static cudaError_t launch_ffn_prep(const void* x, const void* shift, const void* ln_scale,
                                   const void* ln_bias, const void* maa_k, const void* maa_r,
                                   void* xk, void* xr, void* xn_out, int B, int C, float eps,
                                   cudaStream_t stream) {
  const int threads = ffn_prep_threads(C);
  bool vec = C % 8 == 0 && C <= 8 * threads;
  for (const void* p : {x, shift, ln_scale, ln_bias, maa_k, maa_r,
                        static_cast<const void*>(xk), static_cast<const void*>(xr),
                        static_cast<const void*>(xn_out)})
    vec = vec && reinterpret_cast<size_t>(p) % 16 == 0;
  auto kernel = vec ? ffn_prep_kernel<T, P, kSignal, true> : ffn_prep_kernel<T, P, kSignal, false>;
  kernel<<<B, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(shift),
      static_cast<const P*>(ln_scale), static_cast<const P*>(ln_bias),
      static_cast<const P*>(maa_k), static_cast<const P*>(maa_r), static_cast<T*>(xk),
      static_cast<T*>(xr), static_cast<float*>(xn_out), C, eps);
  return cudaGetLastError();
}

}  // namespace rwkv

// dispatch on (activation dtype, parameter dtype)
#define RWKV_TP_DISPATCH(FN, ...)                                                      \
  if (dtype == kFloat32 && pdtype == kFloat32) return FN<float, float>(__VA_ARGS__);   \
  if (dtype == kFloat32 && pdtype == kBFloat16)                                        \
    return FN<float, __nv_bfloat16>(__VA_ARGS__);                                      \
  if (dtype == kBFloat16 && pdtype == kFloat32)                                        \
    return FN<__nv_bfloat16, float>(__VA_ARGS__);                                      \
  if (dtype == kBFloat16 && pdtype == kBFloat16)                                       \
    return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                              \
  return cudaErrorInvalidValue

// The larger of the two bodies' needs at (C, D, Dd); the wrapper checks it
// against the card's opt-in limit.
extern "C" long long rwkv_att_prep_smem_bytes(int C, int D, int Dd) {
  using namespace rwkv;
  long long bytes = (long long)att_prep_smem(C, D, Dd);
  if (att_prep_cluster_takes(C, D, Dd)) {
    const long long cl = prep_layout(C, D, Dd).bytes;
    bytes = cl > bytes ? cl : bytes;
  }
  return bytes;
}

// B.10 by the body `body` (kPrepBodyRowPairs or kPrepBodyCluster). x (B, C)
// and w1 (C, 5D), w2 (5, D, C) in `dtype`; shift (B, C) fp32; ln_scale,
// ln_bias, time_decay (C,), maas (6, C), dw1 (C, Dd), dw2 (Dd, C) in
// `pdtype`. Both need C, 5 D and Dd in multiples of 8 (16-byte loads); the
// cluster body takes bf16 activations and parameters and the shapes
// att_prep_cluster_takes names.
extern "C" int rwkv_att_prep_body(const void* x, const void* shift, const void* ln_scale,
                                  const void* ln_bias, const void* maas, const void* w1,
                                  const void* w2, const void* dw1, const void* dw2,
                                  const void* time_decay, void* xr, void* xk, void* xv, void* xg,
                                  void* w_out, void* xn_out, int B, int C, int D, int Dd,
                                  float eps, int dtype, int pdtype, int body, void* stream) {
  using namespace rwkv;
  if (B <= 0) return cudaSuccess;
  if (C % 8 || (5 * D) % 8 || Dd % 8 || D <= 0 || Dd <= 0) return cudaErrorInvalidValue;
  if (5 * D / 4 > kPrepThreads || Dd / 4 > kPrepThreads) return cudaErrorInvalidValue;
  if (body == kPrepBodyCluster && att_prep_auto_body(C, D, Dd, dtype, pdtype) != kPrepBodyCluster)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  RWKV_TP_DISPATCH(launch_att_prep, x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2,
                   time_decay, xr, xk, xv, xg, w_out, xn_out, B, C, D, Dd, eps, body, s);
}

// B.10 by the body att_prep_auto_body picks: the cluster body for bf16
// activations and parameters at the shapes it takes, the row-pair body
// otherwise.
extern "C" int rwkv_att_prep(const void* x, const void* shift, const void* ln_scale,
                             const void* ln_bias, const void* maas, const void* w1,
                             const void* w2, const void* dw1, const void* dw2,
                             const void* time_decay, void* xr, void* xk, void* xv, void* xg,
                             void* w_out, void* xn_out, int B, int C, int D, int Dd,
                             float eps, int dtype, int pdtype, void* stream) {
  return rwkv_att_prep_body(x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, xr,
                            xk, xv, xg, w_out, xn_out, B, C, D, Dd, eps, dtype, pdtype,
                            rwkv::att_prep_auto_body(C, D, Dd, dtype, pdtype), stream);
}

// B.11. Any B and C.
extern "C" int rwkv_ffn_prep(const void* x, const void* shift, const void* ln_scale,
                             const void* ln_bias, const void* maa_k, const void* maa_r,
                             void* xk, void* xr, void* xn_out, int B, int C, float eps,
                             int dtype, int pdtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || C <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  RWKV_TP_DISPATCH(launch_ffn_prep, x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr,
                   xn_out, B, C, eps, s);
}

// the most value slices of B.12 in `dtype`: the size of its partials
extern "C" int rwkv_ffn_block_slices(int dtype) {
  return dtype == rwkv::kBFloat16 ? rwkv::kSplitK : 1;
}

// the value slices a bf16 B.12 call uses at (C, F) on a card of `sms` SMs
extern "C" long long rwkv_ffn_value_splits(int C, int F, int sms) {
  return rwkv::ffn_value_splits(C, F, sms);
}

// B.12. x (B, C), wk (F, C), wv (C, F), wr (C, C) in `dtype`, torch layout
// (out, in); the vectors in `pdtype`. Scratch from the caller: xk, xr (B, C)
// and k (B, F) in `dtype`, partials (rwkv_ffn_block_slices(dtype) + 1, B, C)
// fp32. Needs C and F in multiples of 32 (one k stage of the products).
extern "C" int rwkv_ffn_block(const void* x, const void* shift, const void* ln_scale,
                              const void* ln_bias, const void* maa_k, const void* maa_r,
                              const void* wk, const void* wv, const void* wr, void* out,
                              void* xn_out, void* xk, void* xr, void* k, void* partials,
                              int B, int C, int F, float eps, int dtype, int pdtype,
                              void* stream) {
  using namespace rwkv;
  if (B <= 0) return cudaSuccess;
  if (C <= 0 || F <= 0 || C % 32 || F % 32) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)B * C;
  const unsigned out_blocks = (unsigned)((total + 255) / 256);
  if (dtype == kBFloat16) {
    using bf = __nv_bfloat16;
    if (pdtype != kBFloat16 && pdtype != kFloat32) return cudaErrorInvalidValue;
    auto prep = [&]() -> cudaError_t {
      return pdtype == kBFloat16
          ? launch_ffn_prep<bf, bf, true>(x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr,
                                          xn_out, B, C, eps, s)
          : launch_ffn_prep<bf, float, true>(x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr,
                                             xn_out, B, C, eps, s);
    };
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int splits = ffn_value_splits(C, F, sms);
    err = B <= 16 ? launch_ffn_products<16>(prep, xk, xr, wk, wv, wr, k, partials, B, C, F, splits, s)
                  : launch_ffn_products<64>(prep, xk, xr, wk, wv, wr, k, partials, B, C, F, splits, s);
    if (err != cudaSuccess) return err;
    err = launch_dependent(ffn_out_kernel<bf>, dim3(out_blocks), 256, 0, s,
                           static_cast<const bf*>(x), static_cast<const float*>(partials),
                           static_cast<bf*>(out), total, splits);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    const int prep = rwkv_ffn_prep(x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr, xn_out,
                                   B, C, eps, dtype, pdtype, stream);
    if (prep != cudaSuccess) return prep;
    const unsigned bz = (B + kF32Batch - 1) / kF32Batch;
    const int rows = kGemmWarps * kF32Rows;
    auto xkf = static_cast<const float*>(xk);
    auto kf = static_cast<float*>(k);
    ffn_gemm_f32_kernel<true><<<dim3((F + rows - 1) / rows, 1, bz), kGemmThreads, 0, s>>>(
        xkf, static_cast<const float*>(wk), C, xkf, static_cast<const float*>(wk), C, kf, B, F);
    ffn_gemm_f32_kernel<false><<<dim3((C + rows - 1) / rows, 2, bz), kGemmThreads, 0, s>>>(
        kf, static_cast<const float*>(wv), F, static_cast<const float*>(xr),
        static_cast<const float*>(wr), C, static_cast<float*>(partials), B, C);
    ffn_out_kernel<float><<<out_blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<const float*>(partials),
                                                     static_cast<float*>(out), total, 1);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
