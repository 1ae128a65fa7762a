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
// written, under 2 MB at B=64) and B.10 re-reads 1.8-2.3 MB of low-rank weights
// from L2 for every block; they are bound by latency, not by bytes or
// operations. B.10's design: two rows a block, 512 threads, every weight read
// with 16-byte loads that serve both rows; the two C-deep reductions (C -> 5D,
// C -> Dd) split C over thread groups and add the groups' partial sums in
// increasing order from shared memory; the two expansions (5 x D -> C, Dd -> C)
// are column-parallel. B.12 is bound by the bytes of its three weight matrices
// (2 C F + C C values, read once): its design is in the comment above
// ffn_gemm_bf16_kernel.
#include "common.cuh"

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

// B.10. Grid: ceil(B / kPrepRows) blocks of kPrepThreads. Dynamic shared
// memory: att_prep_smem_bytes(C, D, Dd).
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

// B.11, and the first phase of B.12. One block a row.
constexpr int kFfnPrepThreads = 256;

template <typename T, typename P>
__global__ void __launch_bounds__(kFfnPrepThreads) ffn_prep_kernel(
    const T* __restrict__ x, const float* __restrict__ shift,
    const P* __restrict__ ln_scale, const P* __restrict__ ln_bias,
    const P* __restrict__ maa_k, const P* __restrict__ maa_r, T* __restrict__ xk,
    T* __restrict__ xr, float* __restrict__ xn_out, int C, float eps) {
  __shared__ float red[kFfnPrepThreads / 32];
  const size_t row = blockIdx.x;
  const T* xp = x + row * C;
  float s = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += kFfnPrepThreads) {
    const float v = to_f(xp[c]);
    s += v;
    s2 = fmaf(v, v, s2);
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float mu = s / C;
  const float var = fmaxf(s2 / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < C; c += kFfnPrepThreads) {
    const float n = fmaf((to_f(xp[c]) - mu) * rstd, to_f(ln_scale[c]), to_f(ln_bias[c]));
    const float d = shift[row * C + c] - n;
    xk[row * C + c] = from_f<T>(fmaf(d, to_f(maa_k[c]), n));
    xr[row * C + c] = from_f<T>(fmaf(d, to_f(maa_r[c]), n));
    xn_out[row * C + c] = n;
  }
}

// B.12's products. All three have the form out[b][n] = sum_k X[b][k] W[n][k]
// with torch-layout weights W (N, K), both operands contiguous along k, B
// small: the weights' bytes decide the time, so every weight byte must come
// from device memory exactly once and the grid must keep all SMs loading.
//
// The grid-wide dependency (kv needs every F tile of k) is met by separate
// launches behind one wrapper: (1) ffn_prep_kernel, (2) the key product, whose
// epilogue rounds to bf16, applies relu^2 and stores k (B, F) in bf16 as
// scratch (0.9 MB at B=64), (3) the value product split over F into kSplitK
// slices plus, as one more slice of the same launch, the receptance product,
// each slice storing an fp32 (B, C) partial, (4) ffn_out_kernel, which adds
// the kv slices in increasing order and writes x + sigmoid(r) * kv. The
// partials are (kSplitK + 1) B C floats, 2.6 MB at B=64 against 67 MB of
// weights.
//
// One block of 8 warps owns 32 weight rows and up to 64 batch rows. The
// product runs on the tensor cores as out^T = W X^T with mma.sync m16n8k16:
// the weight tile is the 16 x 16 A operand and 8 batch rows are the B operand.
// Both are loaded straight from global memory with 16-byte loads: a lane reads
// 8 consecutive k of its row, and since a sum over k has no order to keep,
// those 8 values fill the lane's slots of two mma operations, the same way
// for A and for B. A warp takes every 8th 32-wide k chunk; the warps' fp32
// tiles are added in warp order through shared memory.
constexpr int kGemmThreads = 256;
constexpr int kGemmWarps = kGemmThreads / 32;
constexpr int kGemmRows = 32;    // weight rows (outputs) a block owns
constexpr int kGemmBatch = 64;   // batch rows a block owns
constexpr int kSplitK = 4;       // slices of the value product
constexpr int kRedStride = kGemmRows + 1;

struct GemmProblem {
  const __nv_bfloat16* X;   // (B, K)
  const __nv_bfloat16* W;   // (N, K)
  int K;
  int splits;
};

__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// kKey: store relu(round(acc))^2 as bf16 into out (B, N). Otherwise store the
// fp32 partial of slice blockIdx.y into out (slices, B, N); slices at and
// beyond main.splits belong to `extra` (the receptance product).
template <bool kKey>
__global__ void __launch_bounds__(kGemmThreads, 2) ffn_gemm_bf16_kernel(
    GemmProblem main, GemmProblem extra, void* __restrict__ out, int B, int N) {
  extern __shared__ __align__(16) float red[];   // (warps, kGemmBatch, kRedStride)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bool is_extra = (int)blockIdx.y >= main.splits;
  const GemmProblem p = is_extra ? extra : main;
  const int slice = is_extra ? blockIdx.y - main.splits : blockIdx.y;
  const int n0 = blockIdx.x * kGemmRows, b0 = blockIdx.z * kGemmBatch;
  const int chunks = p.K / 32;
  const int per = (chunks + p.splits - 1) / p.splits;
  const int c_begin = slice * per, c_end = min(chunks, c_begin + per);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int chunk = c_begin + warp; chunk < c_end; chunk += kGemmWarps) {
    const size_t k = (size_t)chunk * 32 + tig * 8;
    uint4 a[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + mt * 16 + hf * 8 + g;
        a[mt][hf] = n < N ? __ldg(reinterpret_cast<const uint4*>(p.W + (size_t)n * p.K + k)) : zero;
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int b = b0 + nt * 8 + g;
      const uint4 xb = b < B ? __ldg(reinterpret_cast<const uint4*>(p.X + (size_t)b * p.K + k)) : zero;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y, a[mt][1].y, xb.x, xb.y);
        mma_bf16(acc[mt][nt], a[mt][0].z, a[mt][1].z, a[mt][0].w, a[mt][1].w, xb.z, xb.w);
      }
    }
  }

  // accumulator (mt, nt, e): weight row mt*16 + g + 8*(e/2), batch row nt*8 + 2*tig + e%2
  float* mine = red + (size_t)warp * kGemmBatch * kRedStride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(nt * 8 + 2 * tig + (e & 1)) * kRedStride + mt * 16 + g + 8 * (e >> 1)] = acc[mt][nt][e];
  __syncthreads();
  for (int o = threadIdx.x; o < kGemmBatch * kGemmRows; o += kGemmThreads) {
    const int bl = o / kGemmRows, nl = o % kGemmRows;
    const int b = b0 + bl, n = n0 + nl;
    if (b >= B || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemmWarps; ++w) s += red[((size_t)w * kGemmBatch + bl) * kRedStride + nl];
    if (kKey) {
      const float kf = fmaxf(to_f(__float2bfloat16_rn(s)), 0.f);
      static_cast<__nv_bfloat16*>(out)[(size_t)b * N + n] = __float2bfloat16_rn(kf * kf);
    } else {
      static_cast<float*>(out)[((size_t)blockIdx.y * B + b) * N + n] = s;
    }
  }
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
// order, r the partial after them. partials: (slices + 1, B, C) fp32.
template <typename T>
__global__ void __launch_bounds__(256) ffn_out_kernel(const T* __restrict__ x,
                                                      const float* __restrict__ partials,
                                                      T* __restrict__ out, size_t total,
                                                      int slices) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float kv = 0.f;
  for (int s = 0; s < slices; ++s) kv += partials[(size_t)s * total + i];
  const float r = partials[(size_t)slices * total + i];
  out[i] = from_f<T>(fmaf(1.f / (1.f + expf(-r)), kv, to_f(x[i])));
}

template <typename T, typename P>
static cudaError_t launch_att_prep(const void* x, const void* shift, const void* ln_scale,
                                   const void* ln_bias, const void* maas, const void* w1,
                                   const void* w2, const void* dw1, const void* dw2,
                                   const void* time_decay, void* xr, void* xk, void* xv,
                                   void* xg, void* w_out, void* xn_out, int B, int C, int D,
                                   int Dd, float eps, cudaStream_t stream) {
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

template <typename T, typename P>
static cudaError_t launch_ffn_prep(const void* x, const void* shift, const void* ln_scale,
                                   const void* ln_bias, const void* maa_k, const void* maa_r,
                                   void* xk, void* xr, void* xn_out, int B, int C, float eps,
                                   cudaStream_t stream) {
  ffn_prep_kernel<T, P><<<B, kFfnPrepThreads, 0, stream>>>(
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

extern "C" long long rwkv_att_prep_smem_bytes(int C, int D, int Dd) {
  return (long long)rwkv::att_prep_smem(C, D, Dd);
}

// B.10. x (B, C) and w1 (C, 5D), w2 (5, D, C) in `dtype`; shift (B, C) fp32;
// ln_scale, ln_bias, time_decay (C,), maas (6, C), dw1 (C, Dd), dw2 (Dd, C) in
// `pdtype`. Needs C, 5 D and Dd in multiples of 8 (16-byte loads).
extern "C" int rwkv_att_prep(const void* x, const void* shift, const void* ln_scale,
                             const void* ln_bias, const void* maas, const void* w1,
                             const void* w2, const void* dw1, const void* dw2,
                             const void* time_decay, void* xr, void* xk, void* xv, void* xg,
                             void* w_out, void* xn_out, int B, int C, int D, int Dd,
                             float eps, int dtype, int pdtype, void* stream) {
  using namespace rwkv;
  if (B <= 0) return cudaSuccess;
  if (C % 8 || (5 * D) % 8 || Dd % 8 || D <= 0 || Dd <= 0) return cudaErrorInvalidValue;
  if (5 * D / 4 > kPrepThreads || Dd / 4 > kPrepThreads) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  RWKV_TP_DISPATCH(launch_att_prep, x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2,
                   time_decay, xr, xk, xv, xg, w_out, xn_out, B, C, D, Dd, eps, s);
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

extern "C" int rwkv_ffn_block_slices(int dtype) {
  return dtype == rwkv::kBFloat16 ? rwkv::kSplitK : 1;
}

// B.12. x (B, C), wk (F, C), wv (C, F), wr (C, C) in `dtype`, torch layout
// (out, in); the vectors in `pdtype`. Scratch from the caller: xk, xr (B, C)
// and k (B, F) in `dtype`, partials (rwkv_ffn_block_slices(dtype) + 1, B, C)
// fp32. Needs C and F in multiples of 32 (one k chunk of the products).
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
  const int prep = rwkv_ffn_prep(x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr, xn_out,
                                 B, C, eps, dtype, pdtype, stream);
  if (prep != cudaSuccess) return prep;
  const size_t total = (size_t)B * C;
  const unsigned out_blocks = (unsigned)((total + 255) / 256);
  if (dtype == kBFloat16) {
    using bf = __nv_bfloat16;
    const size_t smem = sizeof(float) * kGemmWarps * kGemmBatch * kRedStride;
    cudaError_t err = cudaFuncSetAttribute(ffn_gemm_bf16_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ffn_gemm_bf16_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned bz = (B + kGemmBatch - 1) / kGemmBatch;
    const GemmProblem key{static_cast<const bf*>(xk), static_cast<const bf*>(wk), C, 1};
    ffn_gemm_bf16_kernel<true><<<dim3((F + kGemmRows - 1) / kGemmRows, 1, bz), kGemmThreads,
                                 smem, s>>>(key, key, k, B, F);
    const GemmProblem value{static_cast<const bf*>(k), static_cast<const bf*>(wv), F, kSplitK};
    const GemmProblem recept{static_cast<const bf*>(xr), static_cast<const bf*>(wr), C, 1};
    ffn_gemm_bf16_kernel<false><<<dim3((C + kGemmRows - 1) / kGemmRows, kSplitK + 1, bz),
                                  kGemmThreads, smem, s>>>(value, recept, partials, B, C);
    ffn_out_kernel<bf><<<out_blocks, 256, 0, s>>>(static_cast<const bf*>(x),
                                                  static_cast<const float*>(partials),
                                                  static_cast<bf*>(out), total, kSplitK);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
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
