// Tensor-core and asynchronous-copy primitives of the redesigned kernels
// (ddlerp.cu, wkv_fused.cu, decode_fused.cu, wkv_decode.cu): warp-level
// mma.sync m16n8k16 on bf16 operands with fp32 accumulators, ldmatrix to
// fetch its fragments from shared memory, cp.async, tensor-map boxes and bulk
// copies (with their mbarriers) to move tiles between global and shared
// memory without registers, and the programmatic-dependent-launch controls.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, tig = lane % 4):
//   A (16 x 16, row):  a0 = A[g][2tig..+1]      a1 = A[g+8][2tig..+1]
//                      a2 = A[g][2tig+8..+9]    a3 = A[g+8][2tig+8..+9]
//   B (16 x 8, col):   b0 = B[2tig..+1][g]      b1 = B[2tig+8..+9][g]
//   C (16 x 8):        c0, c1 = C[g][2tig..+1]  c2, c3 = C[g+8][2tig..+1]
// The lower k (or column) index sits in the low half of each 32-bit register.
// Two neighbouring C tiles, rounded to bf16, are one A tile: the state of
// wkv_fused.cu feeds the next product straight from its accumulators.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace rwkv {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_m16n8k16(float* c, unsigned a0, unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned). Each lane receives, of every matrix,
// the two values [g][2tig..+1].
__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// As ldmatrix_x4 with every matrix transposed: each lane receives
// [2tig..+1][g], the stored rows running along the pair.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// every cp.async this thread has started has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mbarriers in shared memory, on which the Tensor Memory Accelerator's copies
// complete. A ring of tensor-map boxes costs one thread a few instructions a
// slab, where 16-byte cp.async from every thread, or one bulk copy a
// 128-byte row, kept an H100's SMs busy issuing copies.
__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// after the inits of a block, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_expect_tx(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A 2-D box of a tensor map (`map`: the address of a __grid_constant__
// kernel parameter) at column x, row y into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// Bulk copies of one contiguous run (no tensor map): `bytes` a multiple of 16,
// both addresses 16-byte aligned. A load completes on `bar` as a tensor-map
// box does; stores from shared memory are tracked in bulk groups of the
// issuing thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// closes the bulk group of the stores issued since the last commit
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most `kPending` of this thread's newest bulk groups still read
// shared memory (the older ones' sources may be overwritten)
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// orders this thread's earlier shared-memory writes before later reads of
// them by the asynchronous proxy (a bulk store, after a block barrier)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Boxes of kBoxCols bf16 columns with the 128-byte swizzle: the byte offset
// of 16-byte chunk `c` of row `r` in a box (1024-byte aligned) of 128-byte rows
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

constexpr int kBoxCols = 64;

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it in the stream ends. It must call grid_dependency_wait()
// before it reads what that kernel writes (the wait returns at once in a
// kernel launched the ordinary way). grid_dependents_launch() lets the next
// such kernel start once every block of this one has called it.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// eight bf16 values of one 16-byte word, widened
__device__ __forceinline__ void unpack8(const uint4& q, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// x = hi + lo to about 16 bits: two bf16 limbs of an fp32 value
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = x - hi;
}

// Two fp32 values as a register of bf16 hi limbs and one of lo limbs. The
// hi limb is the value cut, not rounded, to its upper 16 bits: one byte
// permute packs a pair, and the lo limb takes up what the cut left.
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi, unsigned& lo) {
  const unsigned u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(x0 - __uint_as_float(u0 & 0xffff0000u), x1 - __uint_as_float(u1 & 0xffff0000u));
}

}  // namespace rwkv
