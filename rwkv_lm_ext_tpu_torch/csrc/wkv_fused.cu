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
// fp32 instantiation within 1e-4 of the plain version; no served model runs
// it. Neither body needs the JAX package's exact/rescale dispatch.
#include "mma.cuh"

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
  __shared__ float red_mu[N / 32], red_var[N / 32];
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
// Chunked body
// ------------------------------------------------------------------------

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

// Shared memory of one block, in bytes from the start. Row strides are odd
// multiples of 16 bytes, so the 16-byte words that eight lanes read together
// from eight different rows (an ldmatrix) lie in different banks.
template <int N>
struct ChunkLayout {
  static constexpr int kThreads = 2 * N;
  static constexpr int kBS = N + 8;       // bf16 row stride
  static constexpr int kFS = N + 4;       // fp32 row stride (16-byte rows)
  static constexpr int kSlices = N / 4;   // 4-channel slices of a score
  static constexpr int kPS = kSlices + 1; // row stride of the scores' partial sums
  static constexpr int kTile = kL * kBS * 2;            // one bf16 (kL, N) tile
  static constexpr int kStage = 4 * kTile + kL * N * 4; // r, k, v, g, w of a chunk
  static constexpr int kOffRd = 2 * kStage;             // r exp(c): hi, lo
  static constexpr int kOffKd = kOffRd + 2 * kTile;     // k exp(c_L - c): hi, lo
  static constexpr int kOffA = kOffKd + 2 * kTile;      // scores: hi, lo
  // the scores' partial sums (kScores, kPS) fp32, and once they are added up,
  // y (kL, kFS) fp32 in the same place
  static constexpr int kOffPart = kOffA + 2 * kL * kAStride * 2;
  static constexpr int kPartBytes = (kScores * kPS > kL * kFS ? kScores * kPS : kL * kFS) * 4;
  static constexpr int kOffEd = kOffPart + kPartBytes;           // exp(d_t), (kL, kFS)
  static constexpr int kOffEv = kOffEd + kL * kFS * 4;           // exp(c_L)
  static constexpr int kOffU = kOffEv + N * 4;                   // u of this head
  static constexpr int kBytes = kOffU + N * 4;
  static_assert(kTile % 16 == 0 && kStage % 16 == 0 && kOffPart % 16 == 0 && kOffEd % 16 == 0,
                "16-byte alignment");
};

template <int N>
__global__ void __launch_bounds__(2 * N, 4) wkv6_chunked_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const bf16* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    bf16* __restrict__ out, float* __restrict__ sT, int T_len, int H, float eps) {
  using L = ChunkLayout<N>;
  constexpr int BS = L::kBS, FS = L::kFS, YS = L::kFS, PS = L::kPS;
  constexpr int NT = N / 8;        // 8-wide tiles of i in a row of S^T
  constexpr int TPR = N / 8;       // threads per row in the copies and the epilogue
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
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
  const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = s0p[(nt * 8 + 2 * tig + (e & 1)) * N + 16 * warp + gq + 8 * (e >> 1)];

  float sc[8], bi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    sc[q] = scale[h * N + col8 + q];
    bi[q] = bias[h * N + col8 + q];
  }
  if (tid < N) uf[tid] = u[h * N + tid];
  // entries above the diagonal stay 0 for the whole sequence
  for (int p = tid; p < kL * kAStride; p += kThreads) {
    a_hi[p] = __float2bfloat16_rn(0.f);
    a_lo[p] = __float2bfloat16_rn(0.f);
  }

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  // rows [t0, t0 + kL) of r, k, v, g, w into stage `sg`; rows past T are zeros
  auto start_loads = [&](int t0, int sg) {
    unsigned char* base = smem + sg * L::kStage;
    const size_t at = (((size_t)b * T_len + t0 + row) * H + h) * N;
    const bool on = t0 + row < T_len;
    const bf16* src[4] = {r, k, v, g};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bf16* d = reinterpret_cast<bf16*>(base + a * L::kTile) + row * BS + col8;
      if (on) cp_async_16(d, src[a] + at + col8);
      else *reinterpret_cast<uint4*>(d) = zero4;
    }
    float* wd = reinterpret_cast<float*>(base + 4 * L::kTile) + row * N + col8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (on) cp_async_16(wd + 4 * q, w + at + col8 + 4 * q);
      else *reinterpret_cast<uint4*>(wd + 4 * q) = zero4;
    }
  };

  const int n_chunks = (T_len + kL - 1) / kL;
  if (n_chunks > 0) start_loads(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed, and everyone is done with chunk c - 1, whose stage
    // chunk c + 1 takes
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < n_chunks) start_loads((c + 1) * kL, (c + 1) & 1);
    const int t0 = c * kL;
    const int len = min(kL, T_len - t0);
    const unsigned char* base = smem + (c & 1) * L::kStage;
    const bf16* rs = reinterpret_cast<const bf16*>(base);
    const bf16* ks = rs + kL * BS;
    const bf16* vs = ks + kL * BS;
    const bf16* gs = vs + kL * BS;
    const float* ws = reinterpret_cast<const float*>(base + 4 * L::kTile);

    // ---- A: the scaled operands. Half the threads walk a channel forward
    // (r exp(c_t), exp(c_L)), the other half backward (k exp(c_L - c_{t+1}),
    // exp(d_t)): running sums of d, no difference of two sums.
    {
      const int i = tid & (N - 1);
      float d[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) d[t] = t < len ? -fast_exp2(ws[t * N + i] * kLog2e) : 0.f;
      float run = 0.f;
      if (tid < N) {
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          store_limbs(__bfloat162float(rs[t * BS + i]) * fast_exp2(run * kLog2e),
                      rd_hi + t * BS + i, rd_lo + t * BS + i);
          run += d[t];
        }
        ev[i] = expf(run);
      } else {
#pragma unroll
        for (int t = kL - 1; t >= 0; --t) {
          store_limbs(__bfloat162float(ks[t * BS + i]) * fast_exp2(run * kLog2e),
                      kd_hi + t * BS + i, kd_lo + t * BS + i);
          ed[t * FS + i] = fast_exp2(d[t] * kLog2e);
          run += d[t];
        }
      }
    }
    __syncthreads();

    // ---- B: the scores below the diagonal, without an exponential:
    // A[t, s] = sum_i r_ti q_i with q = k_s at t = s + 1 and q <- q exp(d_t)
    // from one t to the next. A thread owns 4 channels of columns s = pair
    // and s = kL - 2 - pair, kL steps together, and leaves one partial sum
    // an entry; entry (t, s) is number t (t - 1) / 2 + s.
    {
      const int slice = tid % L::kSlices, pair = tid / L::kSlices;
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
    for (int p = tid; p < kScores + kL; p += kThreads) {
      int t = 1, s;
      float a = 0.f;
      if (p < kScores) {
        while ((t + 1) * t / 2 <= p) ++t;
        s = p - t * (t - 1) / 2;
#pragma unroll
        for (int sl = 0; sl < L::kSlices; ++sl) a += part[p * PS + sl];
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
    __syncthreads();

    // ---- C: the products. va = V^T[j][s], rows j of this warp.
    unsigned va[4];
    ldmatrix_x4_trans(va, vs + ld_row * BS + 16 * warp + ld_col);
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
    // y[nt][e] is step t = 8 nt + 2 tig + e % 2, channel j = 16 warp + gq + 8 (e / 2)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(nt * 8 + 2 * tig + (e & 1)) * YS + 16 * warp + gq + 8 * (e >> 1)] = y[nt][e];
    __syncthreads();

    // ---- D: GroupNorm over the head and the gate, 8 channels of a step a thread
    {
      float yv[8], gv[8], o[8];
      const float4 y0 = *reinterpret_cast<const float4*>(ys + row * YS + col8);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + row * YS + col8 + 4);
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
#pragma unroll
      for (int q = 0; q < 8; ++q) o[q] = fmaf(yv[q] * rstd, sc[q], bi[q]) * gv[q];
      if (row < len)
        *reinterpret_cast<uint4*>(out + (((size_t)b * T_len + t0 + row) * H + h) * N + col8) = pack8(o);
    }
  }

  float* sTp = sT + (size_t)bh * N * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sTp[(nt * 8 + 2 * tig + (e & 1)) * N + 16 * warp + gq + 8 * (e >> 1)] = st[nt][e];
}

template <int N>
static cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* w,
                                  const void* u, const void* g, const void* scale,
                                  const void* bias, const void* s0, void* out, void* sT, int B,
                                  int T_len, int H, float eps, cudaStream_t stream) {
  constexpr int smem = ChunkLayout<N>::kBytes;
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
                             ChunkLayout<64>::kBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_chunked_kernel<64>, 128,
                                                        ChunkLayout<64>::kBytes);
  } else if (N == 32) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_chunked_kernel<32>, 64,
                                                      ChunkLayout<32>::kBytes);
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
  if (dtype == kFloat32 && N == 32) RWKV_WKV6_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_WKV6_CASE(float, 64);
  if (dtype == kBFloat16 && N == 32) RWKV_WKV6_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_WKV6_CASE(__nv_bfloat16, 64);
#undef RWKV_WKV6_CASE
  return cudaErrorInvalidValue;
}
