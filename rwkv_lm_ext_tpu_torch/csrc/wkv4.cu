// B.14: the RWKV-4 log-space WKV recurrence over (B, T, C), with its state,
// and its backward.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as an XLA
// lax.scan (rwkv_lm_ext_tpu/ops/wkv4.py:23-62, `wkv4`), which XLA compiles
// into an on-device loop, and trains it through XLA's autodiff of that scan.
// In PyTorch a loop over T would launch about 15 operations a token and a
// layer (and autograd about 30 more in the backward), so the port's v4
// prefill, decode step and training run these kernels instead. Same
// arithmetic, in the same order, fp32 throughout (k[t] and v[t] are read in
// their dtype and widened):
//
//   ww = u + k[t];  p = max(pp, ww);  e1 = exp(pp - p);  e2 = exp(ww - p)
//   y[t] = (e1 aa + e2 v[t]) / (e1 bb + e2)
//   ww = pp + w;    p = max(ww, k[t]); e1 = exp(ww - p); e2 = exp(k[t] - p)
//   aa = e1 aa + e2 v[t];  bb = e1 bb + e2;  pp = p
//
// w (the negative decay, -exp(time_decay)) and u (time_first) are fp32 (C,);
// the state (aa, bb, pp) is fp32 (B, C) and starts at pp = -1e38 for a fresh
// sequence, where exp(pp - p) is 0. expf is the accurate one (no fast math).
//
// Bound on the card: bytes. Every (b, c) channel is an independent
// recurrence, so one thread runs one channel's T steps with its state in
// registers; consecutive threads take consecutive channels, so each step's
// loads of k[t] and v[t] and its store of y[t] coalesce across the warp. The
// loop reads kPrefetch steps of k and v ahead into registers before it
// computes them, so a thread has that many loads in flight while its
// recurrence (four expf and a division a step) runs. The state may be read
// and written in place (the *_out pointers equal the inputs): each thread
// reads its own channel's state once before its loop and writes it once after.
//
// The backward (wkv4_bwd_kernel) is the reverse-mode derivative of exactly
// these steps, the one XLA's autodiff of the scan takes: the same exp and
// max, each max's gradient to the operand it picked (half to each on a tie,
// as jnp.maximum and torch.maximum give it). Every local factor is one of
// e1, e2 (each in (0, 1], one of them 1) or 1 / (e1 bb + e2), so the adjoint
// is as stable as the forward: no exp(k) on its own, nothing at pp = -1e38
// (e1 = 0 there and so is every term through it). Memory: under grad the
// forward also writes its state at the entry of every chunk of kWkv4Chunk
// steps (3 floats a channel a chunk, 3/16 of an fp32 copy of k); the
// backward walks the chunks in reverse, recomputes a chunk's kWkv4Chunk
// states forward into registers from its saved entry, then walks them back.
// It takes the gradient of the final state (for TBPTT's carried state) and
// returns that of the initial one. dw and du are sums over b and t: each
// thread keeps its channel's sum over t and writes one (B, C) partial row;
// the wrapper adds the rows in a fixed order (no atomics: two calls give the
// same bits). The backward is bound like the forward, by bytes (it reads k,
// v and dy and writes dk and dv, about 16 B an element in bf16) and by the
// serial chain of its 2 T steps with eight expf each.
#include "common.cuh"

namespace rwkv {

constexpr int kWkv4Threads = 128;
constexpr int kPrefetch = 8;
// steps between two saved states (a multiple of kPrefetch, so a chunk starts
// at the top of a prefetch group)
constexpr int kWkv4Chunk = 16;
static_assert(kWkv4Chunk % kPrefetch == 0, "a chunk must start a prefetch group");

// The state update of one step (the second line of the recurrence).
__device__ __forceinline__ void wkv4_state_step(float& aa, float& bb, float& pp, float kt,
                                                float vt, float wc) {
  const float ww = pp + wc;
  const float p = fmaxf(ww, kt);
  const float e1 = expf(ww - p);
  const float e2 = expf(kt - p);
  aa = e1 * aa + e2 * vt;
  bb = e1 * bb + e2;
  pp = p;
}

// The share of d max(a, b) that goes to a: 1 if a is the max, 0.5 on a tie.
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// kSave: also write the state at every chunk's entry into ck (under grad);
// the inference instantiation has no trace of it in its loop.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kWkv4Threads) wkv4_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* aa_in, const float* bb_in,
    const float* pp_in, float* __restrict__ y, float* aa_out, float* bb_out,
    float* pp_out, float* __restrict__ ck, int T_len, int C) {
  const int c = blockIdx.x * kWkv4Threads + threadIdx.x;
  if (c >= C) return;
  const size_t b = blockIdx.y;
  const size_t s = b * C + c;
  const float wc = w[c], uc = u[c];
  float aa = aa_in[s], bb = bb_in[s], pp = pp_in[s];
  const T* kb = k + b * (size_t)T_len * C + c;
  const T* vb = v + b * (size_t)T_len * C + c;
  float* yb = y + b * (size_t)T_len * C + c;
  for (int t0 = 0; t0 < T_len; t0 += kPrefetch) {
    if (kSave && t0 % kWkv4Chunk == 0) {
      // the entry state of chunk t0 / kWkv4Chunk, for the backward
      const int n_chunks = (T_len + kWkv4Chunk - 1) / kWkv4Chunk;
      const size_t at = (b * n_chunks + t0 / kWkv4Chunk) * C + c;
      const size_t plane = gridDim.y * (size_t)n_chunks * C;
      ck[at] = aa;
      ck[plane + at] = bb;
      ck[2 * plane + at] = pp;
    }
    float kt[kPrefetch], vt[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (t0 + j < T_len) {
        kt[j] = to_f(kb[(size_t)(t0 + j) * C]);
        vt[j] = to_f(vb[(size_t)(t0 + j) * C]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (t0 + j < T_len) {
        const float ww = uc + kt[j];
        const float p = fmaxf(pp, ww);
        const float e1 = expf(pp - p);
        const float e2 = expf(ww - p);
        yb[(size_t)(t0 + j) * C] = (e1 * aa + e2 * vt[j]) / (e1 * bb + e2);
        wkv4_state_step(aa, bb, pp, kt[j], vt[j], wc);
      }
    }
  }
  aa_out[s] = aa;
  bb_out[s] = bb;
  pp_out[s] = pp;
}

// The backward: one thread a channel, chunks in reverse (see the header).
// ck: the forward's chunk-entry states (3, B, n_chunks, C); gaa_T, gbb_T,
// gpp_T: the gradient of the final state (each may be null: zero). Writes dk,
// dv (B, T, C) in T, the (B, C) partials of dw and du, and the gradient of
// the initial state (B, C) each.
template <typename T>
__global__ void __launch_bounds__(kWkv4Threads) wkv4_bwd_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ ck, const float* __restrict__ gy,
    const float* __restrict__ gaa_T, const float* __restrict__ gbb_T,
    const float* __restrict__ gpp_T, T* __restrict__ gk, T* __restrict__ gv,
    float* __restrict__ gw_p, float* __restrict__ gu_p, float* __restrict__ gaa0,
    float* __restrict__ gbb0, float* __restrict__ gpp0, int T_len, int C) {
  constexpr int L = kWkv4Chunk;
  const int c = blockIdx.x * kWkv4Threads + threadIdx.x;
  if (c >= C) return;
  const size_t b = blockIdx.y;
  const size_t s = b * C + c;
  const float wc = w[c], uc = u[c];
  float ga = gaa_T ? gaa_T[s] : 0.f, gb = gbb_T ? gbb_T[s] : 0.f, gp = gpp_T ? gpp_T[s] : 0.f;
  float gw = 0.f, gu = 0.f;
  const int n_chunks = (T_len + L - 1) / L;
  const size_t plane = gridDim.y * (size_t)n_chunks * C;
  const size_t row = b * (size_t)T_len * C + c;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * L;
    const int n = min(L, T_len - t0);
    const size_t at = (b * n_chunks + ci) * C + c;
    float aa = ck[at], bb = ck[plane + at], pp = ck[2 * plane + at];
    float kt[L], vt[L], sa[L], sb[L], sp[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < n) {
        kt[j] = to_f(k[row + (size_t)(t0 + j) * C]);
        vt[j] = to_f(v[row + (size_t)(t0 + j) * C]);
      }
    }
    // the chunk's states again, from its saved entry: sa[j] is the state
    // before step j
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j < n) {
        sa[j] = aa;
        sb[j] = bb;
        sp[j] = pp;
        wkv4_state_step(aa, bb, pp, kt[j], vt[j], wc);
      }
    }
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
      if (j < n) {
        const size_t at_t = row + (size_t)(t0 + j) * C;
        const float a = sa[j], bq = sb[j], q = sp[j], kk = kt[j], vv = vt[j];
        // the output of step j and its adjoint
        const float ww1 = uc + kk;
        const float p1 = fmaxf(q, ww1);
        const float e1 = expf(q - p1), e2 = expf(ww1 - p1);
        const float den = e1 * bq + e2;
        const float y = (e1 * a + e2 * vv) / den;
        const float gnum = gy[at_t] / den;
        const float gden = -gnum * y;
        const float ge1 = gnum * a + gden * bq, ge2 = gnum * vv + gden;
        // the state update of step j and its adjoint
        const float ww2 = q + wc;
        const float p2 = fmaxf(ww2, kk);
        const float f1 = expf(ww2 - p2), f2 = expf(kk - p2);
        const float gf1 = ga * a + gb * bq, gf2 = ga * vv + gb;
        const float gv_t = gnum * e2 + ga * f2;
        const float ga_prev = gnum * e1 + ga * f1;
        const float gb_prev = gden * e1 + gb * f1;
        // e1 = exp(q - p1), e2 = exp(ww1 - p1), p1 = max(q, ww1)
        const float gp1 = -ge1 * e1 - ge2 * e2;
        const float s1 = max_share(q, ww1);
        const float gww1 = ge2 * e2 + gp1 * (1.f - s1);
        float gq = ge1 * e1 + gp1 * s1;
        // f1 = exp(ww2 - p2), f2 = exp(k - p2), p2 = max(ww2, k), pp' = p2
        const float gp2 = gp - gf1 * f1 - gf2 * f2;
        const float s2 = max_share(ww2, kk);
        const float gww2 = gf1 * f1 + gp2 * s2;
        const float gk_t = gww1 + gf2 * f2 + gp2 * (1.f - s2);
        gq += gww2;
        gu += gww1;
        gw += gww2;
        gk[at_t] = from_f<T>(gk_t);
        gv[at_t] = from_f<T>(gv_t);
        ga = ga_prev;
        gb = gb_prev;
        gp = gq;
      }
    }
  }
  gaa0[s] = ga;
  gbb0[s] = gb;
  gpp0[s] = gp;
  gw_p[s] = gw;
  gu_p[s] = gu;
}

template <typename T>
static cudaError_t launch_wkv4_bwd(const void* k, const void* v, const void* w, const void* u,
                                   const void* ck, const void* gy, const void* gaa_T,
                                   const void* gbb_T, const void* gpp_T, void* gk, void* gv,
                                   void* gw_p, void* gu_p, void* gaa0, void* gbb0, void* gpp0,
                                   int B, int T_len, int C, cudaStream_t stream) {
  const dim3 grid((C + kWkv4Threads - 1) / kWkv4Threads, B);
  wkv4_bwd_kernel<T><<<grid, kWkv4Threads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(ck),
      static_cast<const float*>(gy), static_cast<const float*>(gaa_T),
      static_cast<const float*>(gbb_T), static_cast<const float*>(gpp_T), static_cast<T*>(gk),
      static_cast<T*>(gv), static_cast<float*>(gw_p), static_cast<float*>(gu_p),
      static_cast<float*>(gaa0), static_cast<float*>(gbb0), static_cast<float*>(gpp0), T_len,
      C);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_wkv4(const void* k, const void* v, const void* w, const void* u,
                               const void* aa, const void* bb, const void* pp, void* y,
                               void* aa_out, void* bb_out, void* pp_out, void* ck, int B,
                               int T_len, int C, cudaStream_t stream) {
  const dim3 grid((C + kWkv4Threads - 1) / kWkv4Threads, B);
  auto kernel = ck != nullptr ? wkv4_kernel<T, true> : wkv4_kernel<T, false>;
  kernel<<<grid, kWkv4Threads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(aa),
      static_cast<const float*>(bb), static_cast<const float*>(pp), static_cast<float*>(y),
      static_cast<float*>(aa_out), static_cast<float*>(bb_out), static_cast<float*>(pp_out),
      static_cast<float*>(ck), T_len, C);
  return cudaGetLastError();
}

}  // namespace rwkv

// ck: null, or (3, B, ceil(T / 16), C) fp32 for the chunk-entry states that
// rwkv_wkv4_bwd reads.
extern "C" int rwkv_wkv4(const void* k, const void* v, const void* w, const void* u,
                         const void* aa, const void* bb, const void* pp, void* y,
                         void* aa_out, void* bb_out, void* pp_out, void* ck, int B, int T, int C,
                         int dtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (B > 65535 || T < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_wkv4<float>(k, v, w, u, aa, bb, pp, y, aa_out, bb_out, pp_out, ck, B, T, C,
                                s);
    case kBFloat16:
      return launch_wkv4<__nv_bfloat16>(k, v, w, u, aa, bb, pp, y, aa_out, bb_out, pp_out, ck,
                                        B, T, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// gaa_T, gbb_T, gpp_T may be null (a zero gradient of the final state).
extern "C" int rwkv_wkv4_bwd(const void* k, const void* v, const void* w, const void* u,
                             const void* ck, const void* gy, const void* gaa_T,
                             const void* gbb_T, const void* gpp_T, void* gk, void* gv,
                             void* gw_p, void* gu_p, void* gaa0, void* gbb0, void* gpp0, int B,
                             int T, int C, int dtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (B > 65535 || T < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_wkv4_bwd<float>(k, v, w, u, ck, gy, gaa_T, gbb_T, gpp_T, gk, gv, gw_p, gu_p,
                                    gaa0, gbb0, gpp0, B, T, C, s);
    case kBFloat16:
      return launch_wkv4_bwd<__nv_bfloat16>(k, v, w, u, ck, gy, gaa_T, gbb_T, gpp_T, gk, gv,
                                            gw_p, gu_p, gaa0, gbb0, gpp0, B, T, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
