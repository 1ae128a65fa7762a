// B.14: the RWKV-4 log-space WKV recurrence over (B, T, C), with its state.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as an XLA
// lax.scan (rwkv_lm_ext_tpu/ops/wkv4.py:23-62, `wkv4`), which XLA compiles
// into an on-device loop. In PyTorch a loop over T would launch about 15
// operations a token and a layer, so the port's v4 prefill and decode step
// run this kernel instead. Same arithmetic, in the same order, fp32
// throughout (k[t] and v[t] are read in their dtype and widened):
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
#include "common.cuh"

namespace rwkv {

constexpr int kWkv4Threads = 128;
constexpr int kPrefetch = 8;

template <typename T>
__global__ void __launch_bounds__(kWkv4Threads) wkv4_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* aa_in, const float* bb_in,
    const float* pp_in, float* __restrict__ y, float* aa_out, float* bb_out,
    float* pp_out, int T_len, int C) {
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
        float ww = uc + kt[j];
        float p = fmaxf(pp, ww);
        float e1 = expf(pp - p);
        float e2 = expf(ww - p);
        yb[(size_t)(t0 + j) * C] = (e1 * aa + e2 * vt[j]) / (e1 * bb + e2);
        ww = pp + wc;
        p = fmaxf(ww, kt[j]);
        e1 = expf(ww - p);
        e2 = expf(kt[j] - p);
        aa = e1 * aa + e2 * vt[j];
        bb = e1 * bb + e2;
        pp = p;
      }
    }
  }
  aa_out[s] = aa;
  bb_out[s] = bb;
  pp_out[s] = pp;
}

template <typename T>
static cudaError_t launch_wkv4(const void* k, const void* v, const void* w, const void* u,
                               const void* aa, const void* bb, const void* pp, void* y,
                               void* aa_out, void* bb_out, void* pp_out, int B, int T_len,
                               int C, cudaStream_t stream) {
  const dim3 grid((C + kWkv4Threads - 1) / kWkv4Threads, B);
  wkv4_kernel<T><<<grid, kWkv4Threads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(aa),
      static_cast<const float*>(bb), static_cast<const float*>(pp), static_cast<float*>(y),
      static_cast<float*>(aa_out), static_cast<float*>(bb_out), static_cast<float*>(pp_out),
      T_len, C);
  return cudaGetLastError();
}

}  // namespace rwkv

extern "C" int rwkv_wkv4(const void* k, const void* v, const void* w, const void* u,
                         const void* aa, const void* bb, const void* pp, void* y,
                         void* aa_out, void* bb_out, void* pp_out, int B, int T, int C,
                         int dtype, void* stream) {
  using namespace rwkv;
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (B > 65535 || T < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_wkv4<float>(k, v, w, u, aa, bb, pp, y, aa_out, bb_out, pp_out, B, T, C, s);
    case kBFloat16:
      return launch_wkv4<__nv_bfloat16>(k, v, w, u, aa, bb, pp, y, aa_out, bb_out, pp_out, B,
                                        T, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
