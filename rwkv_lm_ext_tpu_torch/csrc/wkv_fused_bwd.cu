// B.6 + B.7: backward of K1 (RWKV-6 WKV + per-head GroupNorm(ln_x) + gate).
//
// Replaces the TPU kernels rwkv_lm_ext_tpu/ops/wkv_pallas.py:1132
// _wkv_gn_fwd_save_kernel (B.6, pass 1) and :1209 _wkv_gn_bwd_kernel (B.7,
// pass 2), both launched by _fused_bwd_pallas (:945) under the custom_vjp of
// _wkv_fused. Given the forward's inputs and the cotangents (dout of the
// gated output, dsT of the final state), they give dr, dk, dv, dg (inputs'
// dtypes), dw (fp32), du, dln_scale, dln_bias and ds0.
//
// Forward, per (b, h), key index i, value index j (ops/wkv_reference.py):
//   y_t[j]    = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   S_t[i,j]  = a_t[i] S_{t-1}[i,j] + k_t[i] v_t[j],  a = exp(lw), lw = -exp(w)
//   out_t     = (GroupNorm(y_t) * scale + bias) * g_t
// Adjoint, with dS_t = dL/dS_t and dS_T = dsT:
//   dS_{t-1}  = a_t dS_t + r_t dy_t^T
//   dk_t[i]   = dk'_t[i] + r_t[i] u[i] (v_t . dy_t),  dk'_t[i] = sum_j dS_t[i,j] v_t[j]
//   dv_t[j]   = sum_i dS_t[i,j] k_t[i] + dy_t[j] sum_i r_t[i] u[i] k_t[i]
//   dr_t[i]   = dr'_t[i] + u[i] k_t[i] (v_t . dy_t),  dr'_t[i] = sum_j S_{t-1}[i,j] dy_t[j]
//   du[i]     = sum_t r_t[i] k_t[i] (v_t . dy_t),      ds0 = dS_0
// The sequential identity for the decay needs no stored state. dL/dlw_m[i] = sum_j dS_m[i,j] S_{m-1}[i,j]
// a_m[i] = c_m[i] - k_m[i] dk'_m[i] with c_m[i] = sum_j dS_m[i,j] S_m[i,j],
// and c_{m-1} = c_m - k_m dk'_m + r_m dr'_m, so
//   dL/dlw_m[i] = c_T[i] + sum_{t>m} r_t[i] dr'_t[i] - sum_{s>=m} k_s[i] dk'_s[i]
// with c_T[i] = sum_j S_T[i,j] dsT[i,j]; dw = dL/dlw * lw. This is the
// sequential form of the suffix scan that the Pallas kernel runs per chunk
// as a triangular product.
//
// Two bodies; the wrappers (ops/wkv_fused.py wkv_bwd_body) pick one from the
// dtype and the head size, and both passes run the same body.
//
// Chunked body (bf16, N of 32 or 64): K1's chunk factoring (wkv_chunk.cuh),
// the split of the TPU kernels. Pass 1 (wkv6_bwd_forward_chunked_kernel) is
// K1's chunked forward, the same device function (chunk_walk) in another
// mode: it writes the state at every chunk's entry and,
// per row, the GroupNorm/gate adjoint (dy, dg, the (b, h) partials of
// dscale/dbias). Pass 2 (wkv6_bwd_reverse_chunked_kernel) walks the chunks
// in reverse with the adjoint state dS in mma accumulators. Within a chunk,
// with c_t = d_0 + .. + d_{t-1} (d = lw), M[t,s] = exp(c_t - c_{s+1}) for
// s < t, the scores B[t,s] = dy_t . v_s and S_in, dS_out the state at the
// chunk's entry and the adjoint at its exit:
//   dr'_t = e^{c_t} S_in dy_t + sum_{s<t} M[t,s] k_s B[t,s]
//   dk'_s = e^{c_L-c_{s+1}} dS_out v_s + sum_{t>s} M[t,s] r_t B[t,s]
//   dv_t  = (k_t e^{c_L-c_{t+1}}) dS_out + sum_{s>=t} A[s,t] dy_s
//   dS_in = e^{c_L} dS_out + sum_t (r_t e^{c_t}) dy_t^T
// (A the forward's scores, the bonus on their diagonal; the bonus terms of
// dr, dk ride on M[t,t] = u). The products run on the tensor cores; the
// terms below the diagonal, whose decay M depends on the channel that
// comes out, run on the CUDA cores as running products down each row.
// Precision is where a chunked backward can fail. The sequential identity
// above cancels where a_m is tiny: dL/dlw_m = c_m - k_m dk'_m subtracts two
// values of the size of the state from each other to leave one of the size
// of a_m ~ 2e-9, then scales it by |lw| ~ 20, and the fp32 sequential body
// missed autograd by 2.7e-4 of the largest value (the JAX package's
// chunked backward, which takes the same identity per chunk in fp32, misses
// fp64 autograd by up to 5e-2 of max at w in [2.5, 3.2]). The chunked
// body takes the decay gradient from terms that each hold the decay of step
// m, so nothing cancels:
//   dL/dlw_m = e^{c_L} X + sum_{s<m} k_s (e^{c_L-c_{s+1}} dS_out v_s)
//            + sum_{t>m} r_t (e^{c_t} S_in dy_t) + sum_{s<m<t} M[t,s] r_t k_s B[t,s]
// with X = sum_j dS_out[i,j] S_in[i,j]: the state and its adjoint never
// meet anywhere else, hence the saved entry states. Every scale is exp of a
// sum of d <= 0 (never a positive exponent), and every fp32 operand goes to
// the bf16 tensor cores as two limbs, so the body is fp32-grade at any
// decay and needs no fp64: within 2e-2 of max|plain| in bf16 for the bf16
// gradients (on an H100 the worst sits at 0.18 of that limit, the rounding
// of the bf16 outputs) and 1e-3 for the fp32 ones (dw at w in [2.5, 3.2]
// 3.2e-5; chip_smoke.py phase 2 prints each gradient's error).
// Sequential body (fp32, and N = 16): the first version below. The two
// passes are sequential recurrences inside one block per (b, h), exact at
// any decay, and no per-step state is stored:
//   pass 1: K1's forward again, thread j holding column S[:, j] in
//     registers. Each step recomputes y_t and its GroupNorm statistics,
//     applies the GroupNorm/gate adjoint (dg, dy, and the (b, h) partials of
//     dscale/dbias), and forms dr'_t from S_{t-1} while it is live: the row
//     sums need values from every thread, so each thread writes S[i][j] dy[j]
//     into a padded (N, N+1) shared tile and thread i sums row i. At the end
//     c_T goes through the same tile. Writes dy (fp32), dr' (fp64), dg.
//   pass 2: reverse time, thread i holding row dS[i, :] in registers:
//     dk' is a local dot product, dv' goes through the shared tile, and the
//     decay gradient carries c_m itself, c_{m-1} = c_m - k_m dk'_m + r_m dr'_m.
// Its running c_m holds only if S and dS obey their recurrences to the last
// bit that survives the cancellation, so S (pass 1), dS (pass 2), the
// products that feed them, dr', dk', c_T and c_m are all fp64: N doubles of
// registers a thread and an fp64 shared tile in pass 1 (N = 128 would need
// 132 KB of it, more than static shared memory holds).
// Cross-(b, h) sums (du, dscale, dbias) are per-(b, h) partials in both
// bodies; the wrapper reduces them with rwkv_sum_partials in a fixed order.
// No atomics: two calls on the same inputs give bit-identical gradients.
//
// Bound on the card: bytes. At B=8, T=512, H=32, N=64, pass 1 reads r, k, v,
// g, dout and w and writes dy and dg (0.05 ms at 3.35 TB/s), pass 2 reads r,
// k, v, w and dy and writes dr, dk, dv and dw (0.06 ms); their chunked
// products are 2.4 and 7 GFLOP (a few microseconds at the bf16 rate). The
// sequential body is bound by its serial T loop (512 dependent steps, two
// to six block barriers each), not by either; the chunked one by
// instruction issue and the chunk's barriers, like K1's (PERF.md).
//
// The unfused WKV (B.8, csrc/wkv.cu) shares this backward, as the JAX package
// runs the same two kernels with the GroupNorm/gate stages compiled out
// (gn=False, ops/wkv_pallas.py:597-602). Its cotangent is dy itself, so its
// pass 1 only carries the state forward (wkv6_bwd_state_chunked_kernel: the
// entry states; wkv6_bwd_state_kernel: dr' and c_T), and pass 2 is the one
// above. B.8 may walk each row's valid prefix
// (`lengths`) in either direction (`reverse`); both passes then map the same
// step index s to the time t that the forward mapped it to, pass 2 walks s
// downwards, and the rows at and beyond the prefix get zero gradients.
#include "wkv_chunk.cuh"

namespace rwkv {

// element (b, t, h, n) of a (B, T, H, N) tensor
__device__ __forceinline__ size_t bthn(int b, int t, int h, int n, int T_len, int H, int N) {
  return (((size_t)b * T_len + t) * H + h) * N + n;
}

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_bwd_forward_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const T* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ s0,
    const T* __restrict__ dout, const float* __restrict__ dsT,
    float* __restrict__ dy_out, double* __restrict__ drp_out, T* __restrict__ dg_out,
    float* __restrict__ dsc_p, float* __restrict__ dbi_p, double* __restrict__ cT,
    int T_len, int H, float eps) {
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float ew_s[N];
  __shared__ __align__(16) float uk_s[N];
  __shared__ float red[4][(N + 31) / 32];
  __shared__ double tile[N][N + 1];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  double S[N];
  const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0p[i * N + j];
  const float u_j = u[h * N + j];
  const float sc_j = scale[h * N + j], bi_j = bias[h * N + j];
  float dsc = 0.f, dbi = 0.f;

  for (int t = 0; t < T_len; ++t) {
    const size_t cur = bthn(b, t, h, j, T_len, H, N);
    const float r_j = to_f(r[cur]), k_j = to_f(k[cur]), v_j = to_f(v[cur]);
    const float g_j = to_f(g[cur]);
    const float do_j = dout ? to_f(dout[cur]) : 0.f;
    // The stage is rewritten only after every thread passed this step's
    // tile barrier, which follows its last read of the stage; the tile is
    // rewritten only after the next step's stage barrier, which follows
    // every thread's read of the tile. red[q] is rewritten a step later,
    // after the stage barrier.
    r_s[j] = r_j;
    k_s[j] = k_j;
    ew_s[j] = expf(-expf(w[cur]));
    uk_s[j] = u_j * k_j;
    __syncthreads();

    double yS = 0.0;
    float ruk = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      yS = fma((double)r_s[i], S[i], yS);
      ruk = fmaf(r_s[i], uk_s[i], ruk);
    }
    const float y = fmaf(ruk, v_j, (float)yS);

    // GroupNorm over the head, then its adjoint and the gate's
    const float mu = block_sum_nowait(y, red[0]) * (1.f / N);
    const float d = y - mu;
    const float var = block_sum_nowait(d * d, red[1]) * (1.f / N);
    const float rstd = rsqrtf(var + eps);
    const float z = d * rstd;
    const float dg = do_j * fmaf(z, sc_j, bi_j);
    const float dpre = do_j * g_j;
    dsc = fmaf(dpre, z, dsc);
    dbi += dpre;
    const float dz = dpre * sc_j;
    const float m1 = block_sum_nowait(dz, red[2]) * (1.f / N);
    const float m2 = block_sum_nowait(dz * z, red[3]) * (1.f / N);
    const float dy = rstd * (dz - m1 - z * m2);

    // dr'_t[i] = sum_j S_{t-1}[i][j] dy[j] through the tile; then S_t
#pragma unroll
    for (int i = 0; i < N; ++i) {
      tile[i][j] = S[i] * (double)dy;
      S[i] = fma(S[i], (double)ew_s[i], (double)k_s[i] * (double)v_j);
    }
    __syncthreads();
    double drp = 0.0;
#pragma unroll
    for (int jj = 0; jj < N; ++jj) drp += tile[j][jj];   // thread j as row i = j
    drp_out[cur] = drp;
    dy_out[cur] = dy;
    dg_out[cur] = from_f<T>(dg);
  }
  dsc_p[(size_t)b * H * N + h * N + j] = dsc;
  dbi_p[(size_t)b * H * N + h * N + j] = dbi;

  // c_T[i] = sum_j S_T[i][j] dsT[i][j], in fp64: the tile holds thread
  // j's column of S_T, and thread i forms the products of its row
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) tile[i][j] = S[i];
  __syncthreads();
  const float* dsTp = dsT ? dsT + ((size_t)bh * N + j) * N : nullptr;
  double c = 0.0;
  if (dsTp)
#pragma unroll
    for (int jj = 0; jj < N; ++jj) c = fma(tile[j][jj], (double)dsTp[jj], c);
  cT[(size_t)bh * N + j] = c;
}

// Pass 1 without the GroupNorm and the gate: B.8's forward state again, given
// dy. Writes dr'_t[i] = sum_j S_{t-1}[i,j] dy_t[j] (fp64) for the steps of the
// walk and c_T[i] = sum_j S_T[i,j] dsT[i,j]; nothing beyond the prefix, where
// pass 2 reads nothing.
template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_bwd_state_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ s0, const float* __restrict__ dy_in,
    const float* __restrict__ dsT, const int* __restrict__ lengths,
    double* __restrict__ drp_out, double* __restrict__ cT, int T_len, int H, int reverse) {
  __shared__ float k_s[N];
  __shared__ float ew_s[N];
  __shared__ double tile[N][N + 1];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  double S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 ? s0[((size_t)bh * N + i) * N + j] : 0.f;
  const int L = lengths ? min(max(lengths[b], 0), T_len) : T_len;

  for (int s = 0; s < L; ++s) {
    const size_t cur = bthn(b, reverse ? L - 1 - s : s, h, j, T_len, H, N);
    const float k_j = to_f(k[cur]), v_j = to_f(v[cur]);
    const double dy = dy_in[cur];
    // the stage is read only before the tile barrier and rewritten after it;
    // the tile is read only after its barrier and rewritten after the next
    // step's stage barrier
    k_s[j] = k_j;
    ew_s[j] = expf(-expf(w[cur]));
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
      tile[i][j] = S[i] * dy;
      S[i] = fma(S[i], (double)ew_s[i], (double)k_s[i] * (double)v_j);
    }
    __syncthreads();
    double drp = 0.0;
#pragma unroll
    for (int jj = 0; jj < N; ++jj) drp += tile[j][jj];   // thread j as row i = j
    drp_out[cur] = drp;
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) tile[i][j] = S[i];
  __syncthreads();
  const float* dsTp = dsT ? dsT + ((size_t)bh * N + j) * N : nullptr;
  double c = 0.0;
  if (dsTp)
#pragma unroll
    for (int jj = 0; jj < N; ++jj) c = fma(tile[j][jj], (double)dsTp[jj], c);
  cT[(size_t)bh * N + j] = c;
}

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_bwd_reverse_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ dy_in, const double* __restrict__ drp_in,
    const double* __restrict__ cT, const float* __restrict__ dsT,
    const int* __restrict__ lengths,
    T* __restrict__ dr_out, T* __restrict__ dk_out, T* __restrict__ dv_out,
    float* __restrict__ dw_out, float* __restrict__ du_p, float* __restrict__ ds0,
    int T_len, int H, int reverse) {
  __shared__ __align__(16) float v_s[N];
  __shared__ __align__(16) float dy_s[N];
  __shared__ __align__(16) float ruk_s[N];
  __shared__ float tile[N][N + 1];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int i = threadIdx.x;   // row i of dS; also column j = i of the tile sums

  double dS[N];
  const float* dsTp = dsT ? dsT + ((size_t)bh * N + i) * N : nullptr;
#pragma unroll
  for (int jj = 0; jj < N; ++jj) dS[jj] = dsTp ? dsTp[jj] : 0.f;
  const float u_i = u ? u[h * N + i] : 0.f;
  double c = cT[(size_t)bh * N + i];   // c_m[i], from c_T down
  float du = 0.f;
  const int L = lengths ? min(max(lengths[b], 0), T_len) : T_len;

  // no gradient reaches the rows that the forward did not walk
  for (int t = L; t < T_len; ++t) {
    const size_t cur = bthn(b, t, h, i, T_len, H, N);
    dr_out[cur] = dk_out[cur] = dv_out[cur] = from_f<T>(0.f);
    dw_out[cur] = 0.f;
  }
  for (int s = L - 1; s >= 0; --s) {
    const size_t cur = bthn(b, reverse ? L - 1 - s : s, h, i, T_len, H, N);
    const float r_i = to_f(r[cur]), k_i = to_f(k[cur]), v_i = to_f(v[cur]);
    const float w_i = w[cur];
    const float dy_i = dy_in[cur];
    const double drp_i = drp_in[cur];
    // stage and tile hazards as in the forward pass: the stage is read only
    // before the tile barrier, the tile only after it
    v_s[i] = v_i;
    dy_s[i] = dy_i;
    ruk_s[i] = r_i * u_i * k_i;
    __syncthreads();

    float vdy = 0.f, ruk = 0.f;
    double dkp_d = 0.0;
#pragma unroll
    for (int jj = 0; jj < N; ++jj) {
      vdy = fmaf(v_s[jj], dy_s[jj], vdy);
      ruk += ruk_s[jj];
      dkp_d = fma(dS[jj], (double)v_s[jj], dkp_d);
    }
    const float dkp = (float)dkp_d;
    const float lw = -expf(w_i);
    const float a_i = expf(lw);
    // dv'[j] = sum_i dS_t[i][j] k[i] through the tile; then dS_{t-1}
#pragma unroll
    for (int jj = 0; jj < N; ++jj) {
      tile[i][jj] = (float)(dS[jj] * (double)k_i);
      dS[jj] = fma((double)a_i, dS[jj], (double)r_i * (double)dy_s[jj]);
    }
    __syncthreads();
    float dvp = 0.f;
#pragma unroll
    for (int ii = 0; ii < N; ++ii) dvp += tile[ii][i];   // thread i as column j = i

    const double dlw = c - (double)k_i * dkp_d;
    c = fma((double)r_i, drp_i, dlw);
    du = fmaf(r_i * k_i, vdy, du);
    dr_out[cur] = from_f<T>(fmaf(u_i * k_i, vdy, (float)drp_i));
    dk_out[cur] = from_f<T>(fmaf(r_i * u_i, vdy, dkp));
    dv_out[cur] = from_f<T>(fmaf(dy_i, ruk, dvp));
    dw_out[cur] = (float)(dlw * lw);
  }
  du_p[(size_t)b * H * N + h * N + i] = du;
  float* ds0p = ds0 + ((size_t)bh * N + i) * N;
#pragma unroll
  for (int jj = 0; jj < N; ++jj) ds0p[jj] = (float)dS[jj];
}

// ------------------------------------------------------------------------
// Chunked bodies (bf16): see the header. Chunks of kL steps (wkv_chunk.cuh).
// ------------------------------------------------------------------------

// Pass 1 of the chunked backward, one block of 2N threads per (b, h): K1's
// chunked forward (chunk_walk, wkv_chunk.cuh) over the walk, which writes the
// state at every chunk's entry; the fused form also the GroupNorm/gate
// adjoint of every row (dy, dg, the partials of dscale and dbias).
template <int N>
__global__ void __launch_bounds__(2 * N, 4) wkv6_bwd_forward_chunked_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const bf16* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ s0, const bf16* __restrict__ dout, float* __restrict__ states,
    float* __restrict__ dy_out, bf16* __restrict__ dg_out, float* __restrict__ dsc_p,
    float* __restrict__ dbi_p, int T_len, int H, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_walk<N, kChunkAdjoint>(r, k, v, w, u, g, scale, bias, s0, dout, nullptr, nullptr, nullptr,
                               states, dy_out, dg_out, dsc_p, dbi_p, T_len, H, eps, 0, smem);
}

template <int N>
__global__ void __launch_bounds__(2 * N, 4) wkv6_bwd_state_chunked_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ s0, const int* __restrict__ lengths, float* __restrict__ states,
    int T_len, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  chunk_walk<N, kChunkState>(nullptr, k, v, w, nullptr, nullptr, nullptr, nullptr, s0, nullptr,
                             lengths, nullptr, nullptr, states, nullptr, nullptr, nullptr, nullptr,
                             T_len, H, 0.f, reverse, smem);
}

// Shared memory of a pass-2 block, in bytes from the start.
template <int N>
struct Pass2Layout : ChunkDims<N> {
  using D = ChunkDims<N>;
  static constexpr int kBsS = kL + 4;                              // row stride of B[t][s]
  static constexpr int kRow = kL * D::kFS * 4;                     // one (kL, kFS) fp32 array
  static constexpr int kStage = 3 * D::kTile + 2 * kL * N * 4;     // r, k, v; w, dy
  static constexpr int kOffRd = 2 * kStage;                        // r exp(c_t): hi, lo
  static constexpr int kOffKd = kOffRd + 2 * D::kTile;             // k exp(c_L - c_{t+1}): hi, lo
  static constexpr int kOffDy = kOffKd + 2 * D::kTile;             // dy: hi, lo
  static constexpr int kOffA = kOffDy + 2 * D::kTile;              // scores: hi, lo
  static constexpr int kOffEd = kOffA + 2 * kL * kAStride * 2;     // exp(d_t)
  static constexpr int kOffEin = kOffEd + kRow;                    // exp(c_t)
  static constexpr int kOffEout = kOffEin + kRow;                  // exp(c_L - c_{t+1})
  static constexpr int kOffB = kOffEout + kRow;                    // B[t][s] = dy_t . v_s
  static constexpr int kOffEv = kOffB + kL * kBsS * 4;             // exp(c_L)
  static constexpr int kOffU = kOffEv + N * 4;                     // u of this head
  static constexpr int kOffX = kOffU + N * 4;                      // X[i]
  // eight (kL, kFS) arrays: dr'^in, dk'^out, dv, dr'^intra (+ bonus), the
  // two halves' dk'^intra and G; the scores' partial sums before them
  static constexpr int kOffOut = kOffX + N * 4;
  static constexpr int kBytes = kOffOut + 8 * kRow;
  static_assert(kScores * D::kPS * 4 <= 8 * kRow, "the partial sums fit the outputs' place");
  static_assert(kStage % 16 == 0 && kOffEd % 16 == 0 && kOffOut % 16 == 0, "16-byte alignment");
};

// The row t of a chunk that half `half` of the channel threads takes q-th:
// half 0 rows 15, 12, 11, 8, 7, 4, 3, 0; half 1 rows 14, 13, 10, 9, 6, 5, 2,
// 1: each half 60 of the 120 pairs below the diagonal.
__host__ __device__ constexpr int half_row(int half, int q) {
  return kL - 1 - 4 * (q >> 1) - (half == 0 ? ((q & 1) ? 3 : 0) : ((q & 1) ? 2 : 1));
}

// Phase H of pass 2 for channel i and the rows of one half: with
// W[t, s] = M[t, s] B[t, s] (M the decay between steps s and t, u on the
// diagonal), dr'^intra_t += sum_{s<=t} W k_s, dk'^intra_s += sum_{t>=s} W r_t,
// G_m += sum_{s<m<t} W r_t k_s (row prefix sums), du += r_t k_t B[t, t].
// M runs as a product down each row, M[t, s-1] = M[t, s] exp(d_s).
template <int N, int kHalf>
__device__ __forceinline__ void channel_pairs(const float* Bs, const bf16* rs, const bf16* ks,
                                              const float* ed, int i, float u_i, float* drp_a,
                                              float* dkp_h, float* g_h, float& du) {
  using L = Pass2Layout<N>;
  constexpr int BS = L::kBS, FS = L::kFS;
  float kf[kL], ef[kL], dkp[kL], G[kL];
#pragma unroll
  for (int s = 0; s < kL; ++s) {
    kf[s] = __bfloat162float(ks[s * BS + i]);
    ef[s] = ed[s * FS + i];
    dkp[s] = G[s] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < kL / 2; ++q) {
    const int t = half_row(kHalf, q);
    const float rt = __bfloat162float(rs[t * BS + i]);
    const float bd = Bs[t * L::kBsS + t];
    float x = bd * u_i;
    float drp = kf[t] * x;
    dkp[t] = fmaf(rt, x, dkp[t]);
    du = fmaf(rt * kf[t], bd, du);
    float W[kL];
    float m = 1.f;
#pragma unroll
    for (int s = t - 1; s >= 0; --s) {
      x = Bs[t * L::kBsS + s] * m;
      const float wk = kf[s] * x;
      drp += wk;
      dkp[s] = fmaf(rt, x, dkp[s]);
      W[s] = rt * wk;
      m *= ef[s];
    }
    float pre = 0.f;
#pragma unroll
    for (int s = 0; s + 2 <= t; ++s) {
      pre += W[s];
      G[s + 1] += pre;
    }
    drp_a[t * FS + i] = drp;
  }
#pragma unroll
  for (int s = 0; s < kL; ++s) {
    dkp_h[s * FS + i] = dkp[s];
    g_h[s * FS + i] = G[s];
  }
}

// Pass 2 of the chunked backward (B.7), one block of 2N threads per (b, h),
// chunks in reverse. Warp m holds rows [16m, 16m + 16) of the adjoint state
// dS (rows i) and of dS^T (rows j) as mma accumulators for the whole walk,
// each updated by its own product, so both are A operands where a product
// needs them. Per chunk, with c, M and B of the header:
//   E  the scaled operands (r e^{c_t}, k e^{c_L-c_{t+1}}, their scales,
//      exp(d_t), exp(c_L)) and dy as two bf16 limbs;
//   F  the forward's scores A (chunk_scores, bonus on the diagonal);
//   G  the products: B = dy v^T; dr'^in = e^{c_t} (dy S_in^T) with S_in from
//      `states` straight into B-operand registers; dk'^out = e^{c_L-c_{t+1}}
//      (dS v^T); X = rowsum(dS . S_in) from the same registers;
//      dv = dS^T (k e^{c_L-c})^T + dy^T A, the bonus riding on A's diagonal;
//      then dS <- e^{c_L} dS + (r e^c)^T dy and dS^T likewise;
//   H  the pairs below the diagonal on the CUDA cores (channel_pairs);
//   I  per channel, in step order: dL/dd_m = e^{c_L} X + sum_{s<m} k_s
//      dk'^out_s + sum_{t>m} r_t dr'^in_t + G_m, dw = dL/dd d, and dr, dk, dv.
// Steps past a row's walk are zero operands with d = 0; times past it get
// zero gradients.
template <int N>
__global__ void __launch_bounds__(2 * N, 2) wkv6_bwd_reverse_chunked_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dy_in,
    const float* __restrict__ states, const float* __restrict__ dsT,
    const int* __restrict__ lengths, bf16* __restrict__ dr_out, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, float* __restrict__ dw_out, float* __restrict__ du_p,
    float* __restrict__ ds0, int T_len, int H, int reverse) {
  using L = Pass2Layout<N>;
  constexpr int BS = L::kBS, FS = L::kFS, BSS = L::kBsS;
  constexpr int NT = N / 8;
  constexpr int TPR = N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* rd_hi = reinterpret_cast<bf16*>(smem + L::kOffRd);
  bf16* rd_lo = rd_hi + kL * BS;
  bf16* kd_hi = reinterpret_cast<bf16*>(smem + L::kOffKd);
  bf16* kd_lo = kd_hi + kL * BS;
  bf16* dy_hi = reinterpret_cast<bf16*>(smem + L::kOffDy);
  bf16* dy_lo = dy_hi + kL * BS;
  bf16* a_hi = reinterpret_cast<bf16*>(smem + L::kOffA);
  bf16* a_lo = a_hi + kL * kAStride;
  float* ed = reinterpret_cast<float*>(smem + L::kOffEd);
  float* ein = reinterpret_cast<float*>(smem + L::kOffEin);
  float* eout = reinterpret_cast<float*>(smem + L::kOffEout);
  float* Bs = reinterpret_cast<float*>(smem + L::kOffB);
  float* ev = reinterpret_cast<float*>(smem + L::kOffEv);
  float* uf = reinterpret_cast<float*>(smem + L::kOffU);
  float* xs = reinterpret_cast<float*>(smem + L::kOffX);
  float* outs = reinterpret_cast<float*>(smem + L::kOffOut);
  float* part = outs;
  float* drp_in = outs;
  float* dkp_out = drp_in + kL * FS;
  float* dvs = dkp_out + kL * FS;
  float* drp_a = dvs + kL * FS;
  float* dkp_h = drp_a + kL * FS;        // two halves
  float* g_h = dkp_h + 2 * kL * FS;      // two halves

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int row = tid / TPR, col8 = (tid % TPR) * 8;
  const int ld_row = (lane & 7) + ((lane >> 4) << 3), ld_col = ((lane >> 3) & 1) * 8;
  const int ci = tid & (N - 1), half = tid / N;   // the channel of phases E, H, I

  // dS[nt][e]: row i = 16 warp + gq + 8 (e / 2), column j = 8 nt + 2 tig + e % 2;
  // dsT_[nt][e]: row j = 16 warp + gq + 8 (e / 2), column i = 8 nt + 2 tig + e % 2
  float dS[NT][4], dST[NT][4];
  const float* dsp = dsT ? dsT + (size_t)bh * N * N : nullptr;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = 16 * warp + gq + 8 * (e >> 1), c = nt * 8 + 2 * tig + (e & 1);
      dS[nt][e] = dsp ? dsp[a * N + c] : 0.f;
      dST[nt][e] = dsp ? dsp[c * N + a] : 0.f;
    }
  if (tid < N) uf[tid] = u ? u[h * N + tid] : 0.f;
  for (int p = tid; p < kL * kAStride; p += L::kThreads) {
    a_hi[p] = __float2bfloat16_rn(0.f);
    a_lo[p] = __float2bfloat16_rn(0.f);
  }
  float du = 0.f;

  const int n_steps = lengths ? min(max(lengths[b], 0), T_len) : T_len;
  const int n_chunks = (n_steps + kL - 1) / kL;
  const float* st_in = states + (size_t)bh * ((T_len + kL - 1) / kL) * N * N;
  auto at = [&](int s, int i) {
    return (((size_t)b * T_len + step_time(s, n_steps, reverse)) * H + h) * N + i;
  };
  // no gradient reaches the times that the forward did not walk
  for (int p = tid; p < (T_len - n_steps) * N; p += L::kThreads) {
    const size_t o = (((size_t)b * T_len + n_steps + p / N) * H + h) * N + p % N;
    dr_out[o] = dk_out[o] = dv_out[o] = __float2bfloat16_rn(0.f);
    dw_out[o] = 0.f;
  }

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  auto start_loads = [&](int c, int sg) {
    unsigned char* base = smem + sg * L::kStage;
    const int s = c * kL + row;
    const bool on = s < n_steps;
    const size_t o = on ? at(s, col8) : 0;
    const bf16* src[3] = {r, k, v};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bf16* d = reinterpret_cast<bf16*>(base + a * L::kTile) + row * BS + col8;
      if (on) cp_async_16(d, src[a] + o);
      else *reinterpret_cast<uint4*>(d) = zero4;
    }
    const float* fsrc[2] = {w, dy_in};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float* d = reinterpret_cast<float*>(base + 3 * L::kTile) + a * kL * N + row * N + col8;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (on) cp_async_16(d + 4 * q, fsrc[a] + o + 4 * q);
        else *reinterpret_cast<uint4*>(d + 4 * q) = zero4;
      }
    }
  };

  if (n_chunks > 0) start_loads(n_chunks - 1, 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int c = n_chunks - 1 - it;
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_chunks) start_loads(c - 1, (it + 1) & 1);
    const int len = min(kL, n_steps - c * kL);
    const unsigned char* base = smem + (it & 1) * L::kStage;
    const bf16* rs = reinterpret_cast<const bf16*>(base);
    const bf16* ks = rs + kL * BS;
    const bf16* vs = ks + kL * BS;
    const float* ws = reinterpret_cast<const float*>(base + 3 * L::kTile);
    const float* dys = ws + kL * N;

    // S_in at the positions of dS: sin[nt][e] = S_in[i][j] (see dS)
    float sin[NT][4];
    {
      const float* sp = st_in + (size_t)c * N * N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 p2 = *reinterpret_cast<const float2*>(
              sp + (16 * warp + gq + 8 * hh) * N + nt * 8 + 2 * tig);
          sin[nt][2 * hh] = p2.x;
          sin[nt][2 * hh + 1] = p2.y;
        }
    }

    // ---- E: the scaled operands: running sums of d, forward for r e^{c_t}
    // and e^{c_L}, backward for k e^{c_L - c_{t+1}} and e^{d_t}; dy in limbs
    {
      float d[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) d[t] = t < len ? -fast_exp2(ws[t * N + ci] * kLog2e) : 0.f;
      float run = 0.f;
      if (half == 0) {
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          const float e = fast_exp2(run * kLog2e);
          ein[t * FS + ci] = e;
          store_limbs(__bfloat162float(rs[t * BS + ci]) * e, rd_hi + t * BS + ci,
                      rd_lo + t * BS + ci);
          run += d[t];
        }
        ev[ci] = expf(run);
      } else {
#pragma unroll
        for (int t = kL - 1; t >= 0; --t) {
          const float e = fast_exp2(run * kLog2e);
          eout[t * FS + ci] = e;
          store_limbs(__bfloat162float(ks[t * BS + ci]) * e, kd_hi + t * BS + ci,
                      kd_lo + t * BS + ci);
          ed[t * FS + ci] = fast_exp2(d[t] * kLog2e);
          run += d[t];
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        store_limbs(dys[row * N + col8 + q], dy_hi + row * BS + col8 + q,
                    dy_lo + row * BS + col8 + q);
    }
    __syncthreads();

    // ---- F: the forward's scores
    chunk_scores<N>(rs, ks, ed, uf, len, part, a_hi, a_lo, tid);
    __syncthreads();

    // ---- G: the products
    {
      float bacc[4] = {0.f, 0.f, 0.f, 0.f};     // B[t][s], s in [8 warp, 8 warp + 8), warps 0, 1
      float pacc[2][4], kacc[2][4], vacc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[n][e] = kacc[n][e] = vacc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        // A: dy (t, j); B: v^T (j, s) and (j, t)
        unsigned yh[4], yl[4], vb[4];
        ldmatrix_x4(yh, dy_hi + (lane & 15) * BS + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(yl, dy_lo + (lane & 15) * BS + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(vb, vs + ld_row * BS + kk * 16 + ld_col);
        if (warp < 2) {
          mma_m16n8k16(bacc, yh[0], yh[1], yh[2], yh[3], vb[2 * warp], vb[2 * warp + 1]);
          mma_m16n8k16(bacc, yl[0], yl[1], yl[2], yl[3], vb[2 * warp], vb[2 * warp + 1]);
        }
        // dr'^in (t, i) = dy S_in^T: B[j][i] = S_in[i][j], i = 16 warp + 8 n + gq
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          unsigned sh0, sl0, sh1, sl1;
          split_pair(sin[2 * kk][2 * n], sin[2 * kk][2 * n + 1], sh0, sl0);
          split_pair(sin[2 * kk + 1][2 * n], sin[2 * kk + 1][2 * n + 1], sh1, sl1);
          mma_m16n8k16(pacc[n], yh[0], yh[1], yh[2], yh[3], sh0, sh1);
          mma_m16n8k16(pacc[n], yh[0], yh[1], yh[2], yh[3], sl0, sl1);
          mma_m16n8k16(pacc[n], yl[0], yl[1], yl[2], yl[3], sh0, sh1);
        }
        // dk'^out (i, t) = dS v^T, dS from its accumulators
        unsigned ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pair(dS[2 * kk + (q >> 1)][2 * (q & 1)], dS[2 * kk + (q >> 1)][2 * (q & 1) + 1],
                     ah[q], al[q]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_m16n8k16(kacc[n], ah[0], ah[1], ah[2], ah[3], vb[2 * n], vb[2 * n + 1]);
          mma_m16n8k16(kacc[n], al[0], al[1], al[2], al[3], vb[2 * n], vb[2 * n + 1]);
        }
        // dv^T (j, t) += dS^T (k e^{c_L-c})^T
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pair(dST[2 * kk + (q >> 1)][2 * (q & 1)], dST[2 * kk + (q >> 1)][2 * (q & 1) + 1],
                     ah[q], al[q]);
        unsigned kh[4], kl[4];
        ldmatrix_x4(kh, kd_hi + ld_row * BS + kk * 16 + ld_col);
        ldmatrix_x4(kl, kd_lo + ld_row * BS + kk * 16 + ld_col);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_m16n8k16(vacc[n], ah[0], ah[1], ah[2], ah[3], kh[2 * n], kh[2 * n + 1]);
          mma_m16n8k16(vacc[n], ah[0], ah[1], ah[2], ah[3], kl[2 * n], kl[2 * n + 1]);
          mma_m16n8k16(vacc[n], al[0], al[1], al[2], al[3], kh[2 * n], kh[2 * n + 1]);
        }
      }
      // dv^T (j, t) += dy^T (j, s) A (s, t): A's rows s, the bonus on its diagonal
      unsigned th[4], tl[4];
      ldmatrix_x4_trans(th, dy_hi + ld_row * BS + 16 * warp + ld_col);
      ldmatrix_x4_trans(tl, dy_lo + ld_row * BS + 16 * warp + ld_col);
      {
        unsigned abh[4], abl[4];
        ldmatrix_x4_trans(abh, a_hi + (lane & 15) * kAStride + (lane >> 4) * 8);
        ldmatrix_x4_trans(abl, a_lo + (lane & 15) * kAStride + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_m16n8k16(vacc[n], th[0], th[1], th[2], th[3], abh[2 * n], abh[2 * n + 1]);
          mma_m16n8k16(vacc[n], th[0], th[1], th[2], th[3], abl[2 * n], abl[2 * n + 1]);
          mma_m16n8k16(vacc[n], tl[0], tl[1], tl[2], tl[3], abh[2 * n], abh[2 * n + 1]);
        }
      }
      if (warp < 2)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Bs[(gq + 8 * (e >> 1)) * BSS + 8 * warp + 2 * tig + (e & 1)] = bacc[e];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = gq + 8 * (e >> 1), i = 16 * warp + 8 * n + 2 * tig + (e & 1);
          drp_in[t * FS + i] = pacc[n][e] * ein[t * FS + i];
          const int t2 = 8 * n + 2 * tig + (e & 1), i2 = 16 * warp + gq + 8 * (e >> 1);
          dkp_out[t2 * FS + i2] = kacc[n][e] * eout[t2 * FS + i2];
          dvs[t2 * FS + i2] = vacc[n][e];
        }
      // X[i] = sum_j dS_out[i][j] S_in[i][j]: this thread's columns, then the quad's
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          x = fmaf(dS[nt][2 * hh], sin[nt][2 * hh], x);
          x = fmaf(dS[nt][2 * hh + 1], sin[nt][2 * hh + 1], x);
        }
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (tig == 0) xs[16 * warp + gq + 8 * hh] = x;
      }
      // dS <- e^{c_L} dS + (r e^c)^T dy: A = (r e^c)^T (i, t), B = dy (t, j)
      {
        const float e0 = ev[16 * warp + gq], e1 = ev[16 * warp + gq + 8];
        unsigned rh[4], rl[4];
        ldmatrix_x4_trans(rh, rd_hi + ld_row * BS + 16 * warp + ld_col);
        ldmatrix_x4_trans(rl, rd_lo + ld_row * BS + 16 * warp + ld_col);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bh_[4], bl_[4];
          ldmatrix_x4_trans(bh_, dy_hi + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
          ldmatrix_x4_trans(bl_, dy_lo + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int nt = 2 * np + q;
            dS[nt][0] *= e0;
            dS[nt][1] *= e0;
            dS[nt][2] *= e1;
            dS[nt][3] *= e1;
            mma_m16n8k16(dS[nt], rh[0], rh[1], rh[2], rh[3], bh_[2 * q], bh_[2 * q + 1]);
            mma_m16n8k16(dS[nt], rh[0], rh[1], rh[2], rh[3], bl_[2 * q], bl_[2 * q + 1]);
            mma_m16n8k16(dS[nt], rl[0], rl[1], rl[2], rl[3], bh_[2 * q], bh_[2 * q + 1]);
          }
        }
      }
      // dS^T <- dS^T e^{c_L} + dy^T (r e^c): A = dy^T (j, t), B = r e^c (t, i)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bh_[4], bl_[4];
        ldmatrix_x4_trans(bh_, rd_hi + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(bl_, rd_lo + (lane & 15) * BS + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nt = 2 * np + q;
          const float e0 = ev[nt * 8 + 2 * tig], e1 = ev[nt * 8 + 2 * tig + 1];
          dST[nt][0] *= e0;
          dST[nt][1] *= e1;
          dST[nt][2] *= e0;
          dST[nt][3] *= e1;
          mma_m16n8k16(dST[nt], th[0], th[1], th[2], th[3], bh_[2 * q], bh_[2 * q + 1]);
          mma_m16n8k16(dST[nt], th[0], th[1], th[2], th[3], bl_[2 * q], bl_[2 * q + 1]);
          mma_m16n8k16(dST[nt], tl[0], tl[1], tl[2], tl[3], bh_[2 * q], bh_[2 * q + 1]);
        }
      }
    }
    __syncthreads();

    // ---- H: the pairs below the diagonal, per channel and half
    if (half == 0)
      channel_pairs<N, 0>(Bs, rs, ks, ed, ci, uf[ci], drp_a, dkp_h, g_h, du);
    else
      channel_pairs<N, 1>(Bs, rs, ks, ed, ci, uf[ci], drp_a, dkp_h + kL * FS, g_h + kL * FS, du);
    __syncthreads();

    // ---- I: per channel in step order; half 0 dr and dw, half 1 dk and dv
    if (half == 0) {
      float after[kL];
      float acc = 0.f;
#pragma unroll
      for (int t = kL - 1; t >= 0; --t) {
        after[t] = acc;
        acc = fmaf(__bfloat162float(rs[t * BS + ci]), drp_in[t * FS + ci], acc);
      }
      const float base_x = ev[ci] * xs[ci];
      float before = 0.f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        const float dldd = base_x + before + after[t] + (g_h[t * FS + ci] + g_h[(kL + t) * FS + ci]);
        before = fmaf(__bfloat162float(ks[t * BS + ci]), dkp_out[t * FS + ci], before);
        if (t < len) {
          const size_t o = at(c * kL + t, ci);
          dw_out[o] = dldd * -fast_exp2(ws[t * N + ci] * kLog2e);
          dr_out[o] = __float2bfloat16_rn(drp_in[t * FS + ci] + drp_a[t * FS + ci]);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kL; ++t)
        if (t < len) {
          const size_t o = at(c * kL + t, ci);
          dk_out[o] = __float2bfloat16_rn(
              dkp_out[t * FS + ci] + (dkp_h[t * FS + ci] + dkp_h[(kL + t) * FS + ci]));
          dv_out[o] = __float2bfloat16_rn(dvs[t * FS + ci]);
        }
    }
  }

  // du of this (b, h): each half's rows, half 0 + half 1; ds0 = dS
  __syncthreads();
  if (half == 1) xs[ci] = du;
  __syncthreads();
  if (half == 0) du_p[(size_t)b * H * N + h * N + ci] = du + xs[ci];
  float* ds0p = ds0 + (size_t)bh * N * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds0p[(16 * warp + gq + 8 * (e >> 1)) * N + nt * 8 + 2 * tig + (e & 1)] = dS[nt][e];
}

// out[m] = sum_{p < P} in[p * M + m], p in increasing order
__global__ void sum_partials_kernel(const float* __restrict__ in, float* __restrict__ out,
                                    int P, long long M) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += in[p * M + m];
  out[m] = s;
}

}  // namespace rwkv

extern "C" int rwkv_wkv6_bwd_forward(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* g,
                                     const void* scale, const void* bias, const void* s0,
                                     const void* dout, const void* dsT, void* dy, void* drp,
                                     void* dg, void* dsc_p, void* dbi_p, void* cT, int B,
                                     int T_len, int H, int N, float eps, int dtype,
                                     void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_BWD1_CASE(TYPE, NN)                                                            \
  do {                                                                                      \
    wkv6_bwd_forward_kernel<TYPE, NN><<<B * H, NN, 0, s>>>(                                  \
        static_cast<const TYPE*>(r), static_cast<const TYPE*>(k),                           \
        static_cast<const TYPE*>(v), static_cast<const float*>(w),                          \
        static_cast<const float*>(u), static_cast<const TYPE*>(g),                          \
        static_cast<const float*>(scale), static_cast<const float*>(bias),                  \
        static_cast<const float*>(s0), static_cast<const TYPE*>(dout),                      \
        static_cast<const float*>(dsT), static_cast<float*>(dy), static_cast<double*>(drp),  \
        static_cast<TYPE*>(dg), static_cast<float*>(dsc_p), static_cast<float*>(dbi_p),     \
        static_cast<double*>(cT), T_len, H, eps);                                            \
    return cudaGetLastError();                                                              \
  } while (0)
  if (dtype == kFloat32 && N == 16) RWKV_BWD1_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_BWD1_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_BWD1_CASE(float, 64);
  if (dtype == kBFloat16 && N == 16) RWKV_BWD1_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_BWD1_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_BWD1_CASE(__nv_bfloat16, 64);
#undef RWKV_BWD1_CASE
  return cudaErrorInvalidValue;
}

extern "C" int rwkv_wkv6_bwd_state(const void* k, const void* v, const void* w,
                                   const void* s0, const void* dy, const void* dsT,
                                   const void* lengths, void* drp, void* cT, int B,
                                   int T_len, int H, int N, int reverse, int dtype,
                                   void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_BWD1S_CASE(TYPE, NN)                                                           \
  do {                                                                                      \
    wkv6_bwd_state_kernel<TYPE, NN><<<B * H, NN, 0, s>>>(                                    \
        static_cast<const TYPE*>(k), static_cast<const TYPE*>(v),                           \
        static_cast<const float*>(w), static_cast<const float*>(s0),                        \
        static_cast<const float*>(dy), static_cast<const float*>(dsT),                      \
        static_cast<const int*>(lengths), static_cast<double*>(drp),                        \
        static_cast<double*>(cT), T_len, H, reverse);                                        \
    return cudaGetLastError();                                                              \
  } while (0)
  if (dtype == kFloat32 && N == 16) RWKV_BWD1S_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_BWD1S_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_BWD1S_CASE(float, 64);
  if (dtype == kBFloat16 && N == 16) RWKV_BWD1S_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_BWD1S_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_BWD1S_CASE(__nv_bfloat16, 64);
#undef RWKV_BWD1S_CASE
  return cudaErrorInvalidValue;
}

// u and lengths may be null (no bonus; every row walks all T steps).
extern "C" int rwkv_wkv6_bwd_reverse(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* dy,
                                     const void* drp, const void* cT, const void* dsT,
                                     const void* lengths, void* dr, void* dk, void* dv,
                                     void* dw, void* du_p, void* ds0, int B, int T_len,
                                     int H, int N, int reverse, int dtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RWKV_BWD2_CASE(TYPE, NN)                                                            \
  do {                                                                                      \
    wkv6_bwd_reverse_kernel<TYPE, NN><<<B * H, NN, 0, s>>>(                                  \
        static_cast<const TYPE*>(r), static_cast<const TYPE*>(k),                           \
        static_cast<const TYPE*>(v), static_cast<const float*>(w),                          \
        static_cast<const float*>(u), static_cast<const float*>(dy),                        \
        static_cast<const double*>(drp), static_cast<const double*>(cT),                     \
        static_cast<const float*>(dsT), static_cast<const int*>(lengths),                   \
        static_cast<TYPE*>(dr), static_cast<TYPE*>(dk),                                     \
        static_cast<TYPE*>(dv), static_cast<float*>(dw), static_cast<float*>(du_p),         \
        static_cast<float*>(ds0), T_len, H, reverse);                                       \
    return cudaGetLastError();                                                              \
  } while (0)
  if (dtype == kFloat32 && N == 16) RWKV_BWD2_CASE(float, 16);
  if (dtype == kFloat32 && N == 32) RWKV_BWD2_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_BWD2_CASE(float, 64);
  if (dtype == kBFloat16 && N == 16) RWKV_BWD2_CASE(__nv_bfloat16, 16);
  if (dtype == kBFloat16 && N == 32) RWKV_BWD2_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_BWD2_CASE(__nv_bfloat16, 64);
#undef RWKV_BWD2_CASE
  return cudaErrorInvalidValue;
}

// Fixed-order sum of P partial rows of M floats: out = sum_p in[p, :].
extern "C" int rwkv_sum_partials(const void* in, void* out, int P, long long M,
                                 void* stream) {
  if (M <= 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (M + threads - 1) / threads;
  rwkv::sum_partials_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), P, M);
  return cudaGetLastError();
}

// The chunked bodies (bf16, N of 32 or 64). Pass 1 of the fused form: dy,
// dg, the partials of dscale and dbias, and the chunk-entry states (B*H,
// ceil(T / 16), N, N) fp32; dout may be null (zero cotangent).
template <int N>
static cudaError_t launch_forward_chunked(const void* r, const void* k, const void* v,
                                          const void* w, const void* u, const void* g,
                                          const void* scale, const void* bias,
                                          const void* s0, const void* dout, void* states,
                                          void* dy, void* dg, void* dsc_p, void* dbi_p, int B,
                                          int T_len, int H, float eps, cudaStream_t s) {
  using namespace rwkv;
  constexpr int smem = ChunkLayout<N, kChunkAdjoint>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_forward_chunked_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_bwd_forward_chunked_kernel<N><<<B * H, 2 * N, smem, s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const bf16*>(g),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(s0), static_cast<const bf16*>(dout), static_cast<float*>(states),
      static_cast<float*>(dy), static_cast<bf16*>(dg), static_cast<float*>(dsc_p),
      static_cast<float*>(dbi_p), T_len, H, eps);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_state_chunked(const void* k, const void* v, const void* w,
                                        const void* s0, const void* lengths, void* states, int B,
                                        int T_len, int H, int reverse, cudaStream_t s) {
  using namespace rwkv;
  constexpr int smem = ChunkLayout<N, kChunkState>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_state_chunked_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_bwd_state_chunked_kernel<N><<<B * H, 2 * N, smem, s>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(s0), static_cast<const int*>(lengths),
      static_cast<float*>(states), T_len, H, reverse);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_reverse_chunked(const void* r, const void* k, const void* v,
                                          const void* w, const void* u, const void* dy,
                                          const void* states, const void* dsT,
                                          const void* lengths, void* dr, void* dk, void* dv,
                                          void* dw, void* du_p, void* ds0, int B, int T_len,
                                          int H, int reverse, cudaStream_t s) {
  using namespace rwkv;
  constexpr int smem = Pass2Layout<N>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_reverse_chunked_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  wkv6_bwd_reverse_chunked_kernel<N><<<B * H, 2 * N, smem, s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(dsT),
      static_cast<const int*>(lengths), static_cast<bf16*>(dr), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dw), static_cast<float*>(du_p),
      static_cast<float*>(ds0), T_len, H, reverse);
  return cudaGetLastError();
}

extern "C" int rwkv_wkv6_bwd_forward_chunked(const void* r, const void* k, const void* v,
                                             const void* w, const void* u, const void* g,
                                             const void* scale, const void* bias,
                                             const void* s0, const void* dout, void* states,
                                             void* dy, void* dg, void* dsc_p, void* dbi_p,
                                             int B, int T_len, int H, int N, float eps,
                                             void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (N == 32)
    return launch_forward_chunked<32>(r, k, v, w, u, g, scale, bias, s0, dout, states, dy, dg,
                                      dsc_p, dbi_p, B, T_len, H, eps, s);
  if (N == 64)
    return launch_forward_chunked<64>(r, k, v, w, u, g, scale, bias, s0, dout, states, dy, dg,
                                      dsc_p, dbi_p, B, T_len, H, eps, s);
  return cudaErrorInvalidValue;
}

// s0 and lengths may be null
extern "C" int rwkv_wkv6_bwd_state_chunked(const void* k, const void* v, const void* w,
                                           const void* s0, const void* lengths, void* states,
                                           int B, int T_len, int H, int N, int reverse,
                                           void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (N == 32) return launch_state_chunked<32>(k, v, w, s0, lengths, states, B, T_len, H, reverse, s);
  if (N == 64) return launch_state_chunked<64>(k, v, w, s0, lengths, states, B, T_len, H, reverse, s);
  return cudaErrorInvalidValue;
}

// u, dsT and lengths may be null
extern "C" int rwkv_wkv6_bwd_reverse_chunked(const void* r, const void* k, const void* v,
                                             const void* w, const void* u, const void* dy,
                                             const void* states, const void* dsT,
                                             const void* lengths, void* dr, void* dk, void* dv,
                                             void* dw, void* du_p, void* ds0, int B, int T_len,
                                             int H, int N, int reverse, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (N == 32)
    return launch_reverse_chunked<32>(r, k, v, w, u, dy, states, dsT, lengths, dr, dk, dv, dw,
                                      du_p, ds0, B, T_len, H, reverse, s);
  if (N == 64)
    return launch_reverse_chunked<64>(r, k, v, w, u, dy, states, dsT, lengths, dr, dk, dv, dw,
                                      du_p, ds0, B, T_len, H, reverse, s);
  return cudaErrorInvalidValue;
}
