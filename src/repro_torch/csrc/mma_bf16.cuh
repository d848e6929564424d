// mma_bf16.cuh: the bf16 tensor-core building blocks of the flash kernels
// (csrc/flash_attention.cu's flash_mma_kernel and split-KV decode,
// csrc/flash_attention_bwd.cu's dQ and dK/dV kernels): 16-byte (and 4-byte)
// cp.async copies into shared memory, ldmatrix loads of mma fragments, the
// mma.sync.m16n8k16 bf16 product with float32 accumulation, and the
// rounding of two float32 accumulators into one bf16 pair, which turns the
// C fragment of one product into the A fragment of the next.
//
// Tiles sit in shared memory as bf16 rows padded by kPad elements (16
// bytes), which puts the 8 rows an ldmatrix reads in 8 distinct groups of 4
// banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;  // bf16 elements (16 bytes) of row padding
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !in (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
// 4 bytes, likewise (a float32 per row of the backward's lse and D)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 x 16, rows x k) of k-step kk from the C fragments
// c[2 kk] and c[2 kk + 1] (16 x 8 each) of a product whose columns are
// that k, rounded to bf16: the C layout of two n-tiles is the A layout.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Fragment addresses in a tile of rows at stride RS elements, for a warp's
// lane.  a_addr: the A fragment of rows row0..row0+15 at columns k0..k0+15
// (ldmatrix_x4).  b_addr: the B fragments of two n-tiles, rows
// row0..row0+15 of a tile that holds B's columns as rows (K in Q K^T;
// ldmatrix_x4 gives b[0], b[1] of n-tile row0/8 and b[2], b[3] of the
// next).  bt_addr: the B fragments of two n-tiles of columns n0..n0+15 of a
// tile that holds B's k as rows (V in P V; ldmatrix_x4_trans), k rows
// k0..k0+15.
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int rs, int row0,
                                              int k0, int lane) {
  return t + (row0 + lane % 16) * rs + k0 + (lane / 16) * 8;
}
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int rs, int row0,
                                              int k0, int lane) {
  return t + (row0 + lane % 8 + (lane / 16) * 8) * rs + k0 +
         ((lane / 8) % 2) * 8;
}
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int rs, int k0,
                                               int n0, int lane) {
  return t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * rs + n0 +
         (lane / 16) * 8;
}

}  // namespace tc
