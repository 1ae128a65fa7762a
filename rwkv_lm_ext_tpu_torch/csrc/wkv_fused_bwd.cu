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
// The decay needs no stored state. dL/dlw_m[i] = sum_j dS_m[i,j] S_{m-1}[i,j]
// a_m[i] = c_m[i] - k_m[i] dk'_m[i] with c_m[i] = sum_j dS_m[i,j] S_m[i,j],
// and c_{m-1} = c_m - k_m dk'_m + r_m dr'_m, so
//   dL/dlw_m[i] = c_T[i] + sum_{t>m} r_t[i] dr'_t[i] - sum_{s>=m} k_s[i] dk'_s[i]
// with c_T[i] = sum_j S_T[i,j] dsT[i,j]; dw = dL/dlw * lw. This is the
// sequential form of the suffix scan that the Pallas kernel runs per chunk
// as a triangular product.
//
// Design. The TPU kernels walk a sequential grid, checkpoint the state at
// every chunk entry in VMEM-sized blocks, and factor each chunk into matrix
// products. Here the two passes are sequential recurrences inside one block
// per (b, h), exact at any decay, and no per-step state is stored:
//   pass 1 (B.6): K1's forward again, thread j holding column S[:, j] in
//     registers. Each step recomputes y_t and its GroupNorm statistics,
//     applies the GroupNorm/gate adjoint (dg, dy, and the (b, h) partials of
//     dscale/dbias), and forms dr'_t from S_{t-1} while it is live: the row
//     sums need values from every thread, so each thread writes S[i][j] dy[j]
//     into a padded (N, N+1) shared tile and thread i sums row i. At the end
//     c_T goes through the same tile. Writes dy (fp32), dr' (fp64), dg.
//   pass 2 (B.7): reverse time, thread i holding row dS[i, :] in registers:
//     dk' is a local dot product, dv' goes through the shared tile, and the
//     decay gradient carries c_m itself, c_{m-1} = c_m - k_m dk'_m + r_m dr'_m.
// Precision: where a_m is tiny (w ~ +3, a ~ 2e-9) dL/dlw_m = c_m - k_m dk'_m
// is a near-total cancellation, then scaled by |lw| ~ 20, and the running c_m
// holds only if S and dS obey their recurrences to the last bit that
// survives it. Every rounding of S, dS, k v, r dy, dr', dk' and c shows up
// whole in the difference: all in fp32, the gradient missed autograd
// through the plain version by up to 2.7e-4 of its largest value on the
// card. So S (pass 1), dS (pass 2), the products that feed them, dr', dk',
// c_T and c_m are all fp64: N doubles of registers a thread and an fp64
// shared tile in pass 1. The card's fp64 rate is half
// its fp32 rate and the passes are latency-bound, so this costs little.
// Cross-(b, h) sums (du, dscale, dbias) are per-(b, h) partials; the wrapper
// reduces them with rwkv_sum_partials in a fixed order. No atomics: two calls
// on the same inputs give bit-identical gradients.
//
// Bound on the card: per step and (b, h) each pass touches the N x N state a
// few times in registers and once in shared memory (N*(N+1) words), with
// two (pass 2) or six (pass 1) block barriers; like K1 the passes are
// latency-bound by their serial T loop, not by the ~12 bytes a channel they
// read and write per step.
#include "common.cuh"

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
  __shared__ float red[4][N / 32];
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

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_bwd_reverse_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ dy_in, const double* __restrict__ drp_in,
    const double* __restrict__ cT, const float* __restrict__ dsT,
    T* __restrict__ dr_out, T* __restrict__ dk_out, T* __restrict__ dv_out,
    float* __restrict__ dw_out, float* __restrict__ du_p, float* __restrict__ ds0,
    int T_len, int H) {
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
  const float u_i = u[h * N + i];
  double c = cT[(size_t)bh * N + i];   // c_m[i], from c_T down
  float du = 0.f;

  for (int t = T_len - 1; t >= 0; --t) {
    const size_t cur = bthn(b, t, h, i, T_len, H, N);
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
  if (dtype == kFloat32 && N == 32) RWKV_BWD1_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_BWD1_CASE(float, 64);
  if (dtype == kBFloat16 && N == 32) RWKV_BWD1_CASE(__nv_bfloat16, 32);
  if (dtype == kBFloat16 && N == 64) RWKV_BWD1_CASE(__nv_bfloat16, 64);
#undef RWKV_BWD1_CASE
  return cudaErrorInvalidValue;
}

extern "C" int rwkv_wkv6_bwd_reverse(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* dy,
                                     const void* drp, const void* cT, const void* dsT,
                                     void* dr, void* dk, void* dv, void* dw, void* du_p,
                                     void* ds0, int B, int T_len, int H, int N, int dtype,
                                     void* stream) {
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
        static_cast<const float*>(dsT), static_cast<TYPE*>(dr), static_cast<TYPE*>(dk),     \
        static_cast<TYPE*>(dv), static_cast<float*>(dw), static_cast<float*>(du_p),         \
        static_cast<float*>(ds0), T_len, H);                                                \
    return cudaGetLastError();                                                              \
  } while (0)
  if (dtype == kFloat32 && N == 32) RWKV_BWD2_CASE(float, 32);
  if (dtype == kFloat32 && N == 64) RWKV_BWD2_CASE(float, 64);
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
