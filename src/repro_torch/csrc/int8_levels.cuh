// int8_levels.cuh: the int8 levels of 2-bit Sign-Magnitude words and the
// tensor-core helpers that multiply them, shared by list_scan.cu and the
// pairwise kernel of bq_distance.cu.
//
// Table 1's similarity is an exact integer dot product: decode each
// dimension of a signature to its level (+-1 by sign, x2 where strong, 0 at
// a masked padding bit), and the weight of a dimension pair is the product
// of the two levels, so sim(a, b) = sum_d level_a[d] * level_b[d],
// |sim| <= 4D.  The kernels decode rows chunk by chunk into shared memory
// (kChunk dimensions a row, rows padded to kRowBytes, which puts the 8 rows
// an ldmatrix reads in 8 distinct groups of 4 banks) and accumulate the
// products in int32 with mma.sync m16n8k32 s8.

#pragma once

#include <stdint.h>

constexpr int kChunk = 128;              // dimensions a k-chunk
constexpr int kWords = kChunk / 32;      // words a plane a row in a chunk
constexpr int kRowBytes = kChunk + 16;   // padded shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix from a shared-memory address (a kernel that computes its
// addresses from one smem_addr of its buffer saves the conversion a load)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  ldmatrix_x2(r, smem_addr(p));
}

// c (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 32 int8 levels of one word (sign plane p, strong plane s, valid-bit
// mask m) into 32 bytes of shared memory (16-byte aligned), in an order of
// their own: byte k of the j-th 32-bit lane holds dimension 4k + j (j < 4)
// or 16 + 4k + j - 4.  Every row of a product is decoded alike, and a dot
// product does not see the order.  Each byte is looked up by a byte
// permute: its selector nibble is p + 2s, + 4 at a masked bit, into the
// bytes -1, +1, -2, +2, 0, 0, 0, 0.
__device__ __forceinline__ void store_levels(int8_t* dst, uint32_t p,
                                             uint32_t s, uint32_t m) {
  constexpr uint32_t kLevels = 0x02FE01FFu;  // -1, +1, -2, +2 by p + 2s
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int sh = j < 4 ? j : j + 12;
    v[j] = ((p >> sh) & 0x1111u) | (((s >> sh) << 1) & 0x2222u);
  }
  if (m != 0xFFFFFFFFu) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sh = j < 4 ? j : j + 12;
      v[j] |= ((~m >> sh) << 2) & 0x4444u;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __byte_perm(kLevels, 0u, v[j]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(v[0], v[1], v[2], v[3]);
  d[1] = make_uint4(v[4], v[5], v[6], v[7]);
}
