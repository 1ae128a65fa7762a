// B.9 and B.13: one T=1 WKV6 step + per-head GroupNorm(ln_x) + gate, on the
// logical (B, H, N, N) fp32 state (B.9) or on its transpose (B.13, further
// down: a persistent grid that streams whole state tiles through a bulk-copy
// ring).
//
// Replaces the TPU kernel rwkv_lm_ext_tpu/ops/wkv_decode.py:68
// _decode_packed_kernel (launched by wkv6_decode_step_packed_pallas, :202);
// the JAX package's default T=1 route, the XLA twin wkv6_decode_step_packed
// (:242), computes the same function. Per (b, h):
//   y_j   = sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j
//   S'_ij = exp(-exp(w_i)) S_ij + k_i v_j
//   out   = (GroupNorm_head(y) * scale + bias) * g     (eps = ln_x_eps)
// r, k, v, g (B, C) in one dtype T, w (B, C) fp32, u (H, N) and scale/bias
// (C,) in one parameter dtype P (fp32 or bf16, read as they are, so a bf16
// model's parameters need no cast a call) -> out (B, C) in g's dtype and
// S' (B, H, N, N) fp32.
//
// The Pallas kernel's tile-packed (B, H, N*N/128, 128) state, its one-hot
// MXU spreads with the hi/lo bf16 split, and _pick_bt_packed all work around
// the TPU's 128-lane tiles; none of them is carried over.
//
// Bound on the card: bytes. The state is read once and written once:
// 2 * B * H * N * N * 4 = 67 MB a layer at B=64, H=32, N=64, about 20 us at
// 3.35 TB/s; at B=1 the step is bound by launch latency. Design: one block
// of 4N threads per (b, h). Thread t owns four adjacent columns (a float4)
// of N/16 rows, the rows interleaved so that a warp's loads cover adjacent
// rows; it issues all its 16-byte state loads before any store, computes
// its partial y and S', and writes S' over the same addresses. Partial y
// sums meet in shared memory; the bonus, the GroupNorm mean and the
// centred variance are block reductions in fp32.
//
// out_state may alias state (the engine updates its state in place): every
// element is read and then written by the same thread, so the two pointers
// are deliberately not __restrict__.
#include <mutex>

#include "mma.cuh"

namespace rwkv {

// The tail every decode kernel shares: per-head GroupNorm of y (held by
// threads t < N; mean and centred variance are block sums in fp32), scale and
// bias, the gate, and the store. g, out: the head's N values; scale, bias:
// the head's N channels.
template <typename T, typename P, int N>
__device__ __forceinline__ void gn_gate_store(float y, const T* __restrict__ g,
                                              const P* __restrict__ scale,
                                              const P* __restrict__ bias,
                                              T* __restrict__ out, float eps, float* red) {
  const int t = threadIdx.x;
  const float mu = block_sum(t < N ? y : 0.f, red) * (1.f / N);
  const float d = y - mu;
  const float var = block_sum_nowait(t < N ? d * d : 0.f, red) * (1.f / N);
  if (t < N)
    out[t] = from_f<T>(fmaf(d * rsqrtf(var + eps), to_f(scale[t]), to_f(bias[t])) * to_f(g[t]));
}

template <typename T, typename P, int N>
__global__ void __launch_bounds__(4 * N) wkv6_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ g,
    const P* __restrict__ u, const P* __restrict__ scale,
    const P* __restrict__ bias, const float* state, T* __restrict__ out,
    float* out_state, int H, float eps) {
  constexpr int kThreads = 4 * N;
  constexpr int kGroups = N / 4;               // float4 column groups
  constexpr int kSlabs = kThreads / kGroups;   // 16 row slabs
  constexpr int kRows = N / kSlabs;            // rows a thread owns
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float ew_s[N];
  __shared__ __align__(16) float v_s[N];
  __shared__ __align__(16) float part[kSlabs][N];
  __shared__ float red[kThreads / 32];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int t = threadIdx.x;
  const size_t vec = (size_t)bh * N;           // (b, h*N) of a (B, C) array
  float ruk = 0.f;
  if (t < N) {
    const float rt = to_f(r[vec + t]), kt = to_f(k[vec + t]);
    r_s[t] = rt;
    k_s[t] = kt;
    v_s[t] = to_f(v[vec + t]);
    ew_s[t] = expf(-expf(w[vec + t]));
    ruk = rt * to_f(u[h * N + t]) * kt;
  }
  __syncthreads();

  const int j0 = (t % kGroups) * 4, slab = t / kGroups;
  const float* sp = state + (size_t)bh * N * N + j0;
  float* op = out_state + (size_t)bh * N * N + j0;
  float4 s4[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    s4[q] = *reinterpret_cast<const float4*>(sp + (size_t)(q * kSlabs + slab) * N);
  const float4 v4 = *reinterpret_cast<const float4*>(v_s + j0);
  float4 y4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int i = q * kSlabs + slab;
    const float ri = r_s[i], ki = k_s[i], ei = ew_s[i];
    const float4 s = s4[q];
    y4.x = fmaf(ri, s.x, y4.x);
    y4.y = fmaf(ri, s.y, y4.y);
    y4.z = fmaf(ri, s.z, y4.z);
    y4.w = fmaf(ri, s.w, y4.w);
    float4 n;
    n.x = fmaf(s.x, ei, ki * v4.x);
    n.y = fmaf(s.y, ei, ki * v4.y);
    n.z = fmaf(s.z, ei, ki * v4.z);
    n.w = fmaf(s.w, ei, ki * v4.w);
    *reinterpret_cast<float4*>(op + (size_t)i * N) = n;
  }
  *reinterpret_cast<float4*>(&part[slab][j0]) = y4;

  // the barrier inside this sum also publishes part[][]
  const float bonus = block_sum(ruk, red);
  float y = 0.f;
  if (t < N) {
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) y += part[s][t];
    y = fmaf(bonus, v_s[t], y);
  }
  gn_gate_store<T, P, N>(y, g + vec, scale + h * N, bias + h * N, out + vec, eps, red);
}

// B.13: the same step on a state stored transposed, St[j][i] = S[i][j], laid
// out (B, H, N_j, N_i).
//
// Replaces the TPU kernel scripts/bench_decode_transposed.py:65 _transT_kernel
// (launched by decode_step_transT, :132). There the transpose turns decay, k
// and r into lane tiles, leaves v as the one spread and folds y with a one-hot
// matmul; none of that is carried over. On this card the transpose changes
// which axis the y reduction runs along: y_j = sum_i r_i St[j][i] is a sum
// along the contiguous axis, so N/4 neighbouring lanes read one row j as
// float4s and their partial sums meet in a shuffle tree inside the warp. The
// state update is B.9's fmaf per element, so the new state equals B.9's bit
// for bit after a transpose; y is summed in another order.
//
// What held the first design (one block of 4N threads a head, as B.9) back,
// read from clock64 stamps of its phases (measured on an H100 at B=64, H=32,
// N=64): a block lived ~4.9 us for its one head, and its 16 KB of state were
// in flight during only ~1.6 us of that. Before the state loads each thread
// fetched its own r, k and w and took their exponentials (~1.1 us, a
// dependent round trip); after them three block reductions (the bonus, the
// GroupNorm mean and variance) took ~2.1 us. Four blocks fit an SM, so an SM
// had on average about one head's state in flight, far from what the memory
// rate needs.
//
// This design keeps bytes in flight for the whole life of a block. The grid is
// persistent (blocks an SM by occupancy x SMs, at most one a head; the wrapper
// passes it) and block q walks heads q, q + grid, q + 2 grid, ... A ring of
// kStreamStages stages in dynamic shared memory holds, a stage, the head's
// whole contiguous N x N fp32 tile (16 KB at N=64) and its five N-vectors r,
// k, v, g, w. Thread 0 fills a stage with six bulk copies counted on the
// stage's mbarrier and stores the updated tile back with one bulk copy. Once
// head m's store is issued, the stage of head m-1 takes head m-1+S (after
// wait_group.read 1: head m-1's store has read it, head m's may still run),
// so while head m+1 is computed, heads m+2 .. m+S-1 are landing and head m
// is being stored. Three stages (four blocks an SM at N=64) took 0.0267 ms
// on a cold state at B=64 where four stages (three blocks) took 0.0272 and
// six (two blocks) 0.0296 (measured on an H100).
//
// The arithmetic: N threads stage the head's r, k, v and exp(-exp(w)) in
// fp32 shared memory once (where the first design had every thread fetch its
// own), then each thread reads float4 along i from the stage, N/4 lanes to a
// row j, folds y_j by a shuffle tree in a fixed order, and writes
// S'[j][i] = fmaf(S, e_i, k_i v_j) back into the stage; the bonus and the
// GroupNorm / gate tail are block sums in fp32, as in B.9.
//
// In place: out_state may alias state. A tile's load has completed before its
// store is issued, and two heads never share an address.
constexpr int kStreamStages = 3;

// One stage of the ring, in bytes: the tile, r, k, v, g in T, w in fp32; the
// ring is kStreamStages stages and one mbarrier a stage.
template <typename T, int N>
struct StreamStage {
  static constexpr int kTile = N * N * 4;
  static constexpr int kVec = N * (int)sizeof(T);
  static constexpr int kR = kTile, kK = kR + kVec, kV = kK + kVec, kG = kV + kVec,
                       kW = kG + kVec;
  static constexpr int kBytes = kW + 4 * N;
  static constexpr int kRing = kStreamStages * kBytes + 8 * kStreamStages;
  static_assert(kVec % 16 == 0 && kBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
  // the dynamic shared memory one block of an H100 may opt in to
  static_assert(kRing <= 232448, "the ring does not fit one block's shared memory");
};

// Grid: at most `heads` blocks of 4N threads; dynamic shared memory
// StreamStage<T, N>::kRing.
template <typename T, typename P, int N>
__global__ void __launch_bounds__(4 * N) wkv6_decode_stream_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const T* __restrict__ g,
    const P* __restrict__ u, const P* __restrict__ scale,
    const P* __restrict__ bias, const float* state, T* __restrict__ out,
    float* out_state, int heads, int H, float eps) {
  using L = StreamStage<T, N>;
  constexpr int S = kStreamStages;
  constexpr int kThreads = 4 * N;
  constexpr int kGroups = N / 4;               // float4 groups along i: lanes a row
  constexpr int kSlabs = kThreads / kGroups;   // 16 rows j at a time
  constexpr int kRows = N / kSlabs;            // rows a thread owns
  extern __shared__ __align__(128) unsigned char ring[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(ring + S * L::kBytes);
  __shared__ __align__(16) float r_s[N];
  __shared__ __align__(16) float k_s[N];
  __shared__ __align__(16) float e_s[N];
  __shared__ float v_s[N];
  __shared__ float y_s[N];
  __shared__ float red[kThreads / 32];

  const int t = threadIdx.x;
  const int q = blockIdx.x, grid = gridDim.x;
  const int count = q < heads ? (heads - 1 - q) / grid + 1 : 0;   // heads of this block's walk
  // thread 0: head m of the walk into stage m % S
  auto fill = [&](int m) {
    const size_t vec = (size_t)(q + m * grid) * N;
    unsigned char* st = ring + (m % S) * L::kBytes;
    unsigned long long* bar = bars + m % S;
    mbar_expect_tx(bar, L::kBytes);
    bulk_load(st, state + vec * N, L::kTile, bar);
    bulk_load(st + L::kR, r + vec, L::kVec, bar);
    bulk_load(st + L::kK, k + vec, L::kVec, bar);
    bulk_load(st + L::kV, v + vec, L::kVec, bar);
    bulk_load(st + L::kG, g + vec, L::kVec, bar);
    bulk_load(st + L::kW, w + vec, 4 * N, bar);
  };
  if (t == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int m = 0; m < S && m < count; ++m) fill(m);

  const int i0 = (t % kGroups) * 4, slab = t / kGroups;
  for (int m = 0; m < count; ++m) {
    const int bh = q + m * grid, h = bh % H;
    unsigned char* st = ring + (m % S) * L::kBytes;
    float* tile = reinterpret_cast<float*>(st);
    mbar_wait(bars + m % S, (m / S) & 1);
    float ruk = 0.f;
    if (t < N) {
      const float rt = to_f(reinterpret_cast<const T*>(st + L::kR)[t]);
      const float kt = to_f(reinterpret_cast<const T*>(st + L::kK)[t]);
      r_s[t] = rt;
      k_s[t] = kt;
      v_s[t] = to_f(reinterpret_cast<const T*>(st + L::kV)[t]);
      e_s[t] = expf(-expf(reinterpret_cast<const float*>(st + L::kW)[t]));
      ruk = rt * to_f(u[h * N + t]) * kt;
    }
    __syncthreads();
    const float4 r4 = *reinterpret_cast<const float4*>(r_s + i0);
    const float4 k4 = *reinterpret_cast<const float4*>(k_s + i0);
    const float4 e4 = *reinterpret_cast<const float4*>(e_s + i0);
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      const int j = p * kSlabs + slab;
      float4* sp = reinterpret_cast<float4*>(tile + j * N + i0);
      const float4 s = *sp;
      const float vj = v_s[j];
      float y = fmaf(r4.w, s.w, fmaf(r4.z, s.z, fmaf(r4.y, s.y, r4.x * s.x)));
      float4 n;
      n.x = fmaf(s.x, e4.x, k4.x * vj);
      n.y = fmaf(s.y, e4.y, k4.y * vj);
      n.z = fmaf(s.z, e4.z, k4.z * vj);
      n.w = fmaf(s.w, e4.w, k4.w * vj);
      *sp = n;
#pragma unroll
      for (int o = kGroups / 2; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
      if (t % kGroups == 0) y_s[j] = y;
    }
    // the tile's new values are read next by the bulk store
    fence_proxy_async_smem();
    // the barriers inside this sum also publish y_s[] and the whole tile
    const float bonus = block_sum(ruk, red);
    if (t == 0) {
      bulk_store(out_state + (size_t)bh * N * N, tile, L::kTile);
      bulk_commit();
      if (m >= 1 && m - 1 + S < count) {
        bulk_wait_read<1>();          // head m-1's store has read its stage
        fill(m - 1 + S);
      }
    }
    const float y = t < N ? fmaf(bonus, v_s[t], y_s[t]) : 0.f;
    gn_gate_store<T, P, N>(y, reinterpret_cast<const T*>(st + L::kG), scale + h * N, bias + h * N,
                        out + (size_t)bh * N, eps, red);
  }
  // the last stores have read their stages; their writes complete with the grid
  if (t == 0) bulk_wait_read<0>();
}

// Blocks of B.13 an SM holds at once on the current device. The
// first call on a device also raises the kernel's dynamic shared-memory limit
// to its ring, so a launch that follows (under CUDA-graph capture too) makes
// neither call again.
template <typename T, typename P, int N>
static cudaError_t stream_blocks_per_sm(int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static int cache[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[device] == 0) {
    constexpr int smem = StreamStage<T, N>::kRing;
    err = cudaFuncSetAttribute(wkv6_decode_stream_kernel<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv6_decode_stream_kernel<T, P, N>,
                                                          4 * N, smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cache[device] = n;
  }
  *blocks = cache[device];
  return cudaSuccess;
}

template <typename T, typename P, int N>
static cudaError_t launch_decode(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* g,
                                 const void* scale, const void* bias,
                                 const void* state, void* out, void* out_state,
                                 int B, int H, float eps, int grid, cudaStream_t stream) {
  const auto rp = static_cast<const T*>(r), kp = static_cast<const T*>(k),
             vp = static_cast<const T*>(v), gp = static_cast<const T*>(g);
  const auto up = static_cast<const P*>(u), sc = static_cast<const P*>(scale),
             bi = static_cast<const P*>(bias);
  const auto wp = static_cast<const float*>(w), sp = static_cast<const float*>(state);
  const auto op = static_cast<T*>(out);
  const auto osp = static_cast<float*>(out_state);
  const int heads = B * H;
  if (grid > 0) {
    int per_sm = 0;
    const cudaError_t err = stream_blocks_per_sm<T, P, N>(&per_sm);
    if (err != cudaSuccess) return err;
    if (grid > heads) return cudaErrorInvalidValue;
    for (const void* p : {r, k, v, w, g, state, static_cast<const void*>(out_state)})
      if (reinterpret_cast<size_t>(p) % 16) return cudaErrorMisalignedAddress;
    wkv6_decode_stream_kernel<T, P, N><<<grid, 4 * N, StreamStage<T, N>::kRing, stream>>>(
        rp, kp, vp, wp, gp, up, sc, bi, sp, op, osp, heads, H, eps);
  } else {
    wkv6_decode_kernel<T, P, N><<<heads, 4 * N, 0, stream>>>(rp, kp, vp, wp, gp, up, sc, bi, sp,
                                                             op, osp, H, eps);
  }
  return cudaGetLastError();
}

}  // namespace rwkv

#define RWKV_DECODE_SIZES(CASE, TYPE, PTYPE, DT, PDT)                   \
  if (dtype == DT && pdtype == PDT && N == 16) CASE(TYPE, PTYPE, 16);   \
  if (dtype == DT && pdtype == PDT && N == 32) CASE(TYPE, PTYPE, 32);   \
  if (dtype == DT && pdtype == PDT && N == 64) CASE(TYPE, PTYPE, 64)
#define RWKV_DECODE_TYPES(CASE)                                                 \
  RWKV_DECODE_SIZES(CASE, float, float, kFloat32, kFloat32);                    \
  RWKV_DECODE_SIZES(CASE, float, __nv_bfloat16, kFloat32, kBFloat16);           \
  RWKV_DECODE_SIZES(CASE, __nv_bfloat16, float, kBFloat16, kFloat32);           \
  RWKV_DECODE_SIZES(CASE, __nv_bfloat16, __nv_bfloat16, kBFloat16, kBFloat16)

// B.9 alone, at a head size B.13 is not built for (N = 128: 512 threads a
// block, a thread's eight float4 rows of the state in registers).
template <typename T, typename P, int N>
static cudaError_t launch_decode_b9(const void* r, const void* k, const void* v, const void* w,
                                    const void* u, const void* g, const void* scale,
                                    const void* bias, const void* state, void* out,
                                    void* out_state, int B, int H, float eps,
                                    cudaStream_t stream) {
  rwkv::wkv6_decode_kernel<T, P, N><<<B * H, 4 * N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const T*>(g), static_cast<const P*>(u),
      static_cast<const P*>(scale), static_cast<const P*>(bias),
      static_cast<const float*>(state), static_cast<T*>(out), static_cast<float*>(out_state),
      H, eps);
  return cudaGetLastError();
}

// grid 0: B.9; grid > 0: B.13 on `grid` blocks
static int decode_dispatch(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* g, const void* scale,
                           const void* bias, const void* state, void* out,
                           void* out_state, int B, int H, int N, float eps, int dtype,
                           int pdtype, int grid, void* stream) {
  using namespace rwkv;
  if (B <= 0 || H <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (N == 128) {
    if (grid > 0) return cudaErrorInvalidValue;   // B.13 takes N of 16, 32 and 64
#define RWKV_DECODE128_CASE(TYPE, PTYPE, DT, PDT)                                           \
  if (dtype == DT && pdtype == PDT)                                                         \
    return launch_decode_b9<TYPE, PTYPE, 128>(r, k, v, w, u, g, scale, bias, state, out,    \
                                              out_state, B, H, eps, s)
    RWKV_DECODE128_CASE(float, float, kFloat32, kFloat32);
    RWKV_DECODE128_CASE(float, __nv_bfloat16, kFloat32, kBFloat16);
    RWKV_DECODE128_CASE(__nv_bfloat16, float, kBFloat16, kFloat32);
    RWKV_DECODE128_CASE(__nv_bfloat16, __nv_bfloat16, kBFloat16, kBFloat16);
#undef RWKV_DECODE128_CASE
    return cudaErrorInvalidValue;
  }
#define RWKV_DECODE_CASE(TYPE, PTYPE, NN)                                                \
  return launch_decode<TYPE, PTYPE, NN>(r, k, v, w, u, g, scale, bias, state, out,       \
                                        out_state, B, H, eps, grid, s)
  RWKV_DECODE_TYPES(RWKV_DECODE_CASE);
#undef RWKV_DECODE_CASE
  return cudaErrorInvalidValue;
}

// B.9. r, k, v, g in `dtype`; u, scale and bias in `pdtype`.
extern "C" int rwkv_wkv6_decode(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* g,
                                const void* scale, const void* bias,
                                const void* state, void* out, void* out_state,
                                int B, int H, int N, float eps, int dtype, int pdtype,
                                void* stream) {
  return decode_dispatch(r, k, v, w, u, g, scale, bias, state, out, out_state, B, H, N, eps,
                         dtype, pdtype, 0, stream);
}

// B.13 on `grid` blocks (1 to B * H), with r, k, v, w, g, state and
// out_state 16-byte aligned: state and out_state hold S transposed,
// (B, H, N_j, N_i); the rest as B.9's.
extern "C" int rwkv_wkv6_decode_transposed(const void* r, const void* k, const void* v,
                                           const void* w, const void* u, const void* g,
                                           const void* scale, const void* bias,
                                           const void* state, void* out, void* out_state,
                                           int B, int H, int N, float eps, int dtype,
                                           int pdtype, int grid, void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  return decode_dispatch(r, k, v, w, u, g, scale, bias, state, out, out_state, B, H, N, eps,
                         dtype, pdtype, grid, stream);
}

// Blocks of B.13 an SM holds at once, for `dtype`, `pdtype` and N (the
// wrapper's grid is that times the SMs, at most B * H); a negative CUDA error
// code if the query fails.
extern "C" long long rwkv_wkv6_decode_stream_blocks_per_sm(int dtype, int pdtype, int N) {
  using namespace rwkv;
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define RWKV_STREAM_CASE(TYPE, PTYPE, NN) err = stream_blocks_per_sm<TYPE, PTYPE, NN>(&blocks)
  RWKV_DECODE_TYPES(RWKV_STREAM_CASE);
#undef RWKV_STREAM_CASE
  return err == cudaSuccess ? blocks : -(long long)err;
}
