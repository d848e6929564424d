// bq_space.cuh: the two metric spaces over which the gather (bq_gather.cuh)
// and the pool (bq_pool.cuh) kernels are templates.
//
//   Bq2  symmetric 2-bit Sign-Magnitude similarity, QuIVer Table 1
//        (bq_distance.cu).  A query is its (sign | strong) planes, 2W words.
//   Bq1  1-bit SimHash Hamming distance over the sign plane (hamming.cu).  A
//        query is its sign plane, W words; of a table row only the first W
//        words are read.
//
// Both read rows of the same (N, 2W) signature table, whose padding bits are
// 0 in both planes.
//
// The gather scores a (query, row) pair word pair by word pair into an
// accumulator (Acc): Bq2 with the three popcounts of bq_distance.cu's
// identity, and its lanes' shares of D from the valid-bit mask; Bq1 with one
// popcount of the xor and no mask.
//
// The pool multiplies int8 levels (int8_levels.cuh): Bq2 decodes +-1/+-2 by
// sign and strength; Bq1 decodes +-1 by sign (its strong words are zeros in
// registers, never read).  Both decode a masked bit to 0: a padding bit is
// 0 in the sign plane and would decode as -1 without the mask.  The product
// of two rows' levels is Bq2's similarity.  For Bq1 it is s = D - 2h over
// the D valid bits, h of them differing, so the epilogue writes
// h = (D - s) >> 1, exact, with D the mask's popcount.

#pragma once

#include <stdint.h>

struct Bq2 {
  // a query and the pool's loader read the strong plane too
  static constexpr bool kStrong = true;
  // per word pair, with d = pa ^ pb, x = sa ^ sb and o = sa | sb:
  // sim = D + 3 pop(o) - 2 pop(d ^ x) - 6 pop(d & o)
  struct Acc {
    int p_or = 0, p_odd = 0, p_diff = 0;
    __device__ __forceinline__ void add(uint32_t qp, uint32_t qs, uint32_t rp,
                                        uint32_t rs) {
      const uint32_t d = qp ^ rp;
      const uint32_t o = qs | rs;
      p_or += __popc(o);
      p_odd += __popc(d ^ qs ^ rs);
      p_diff += __popc(d & o);
    }
    // dim: this lane's share of D
    __device__ __forceinline__ int result(int dim) const {
      return dim + 3 * p_or - 2 * p_odd - 6 * p_diff;
    }
  };
  // the pool's output from the product s of two rows' levels
  __device__ __forceinline__ static int pool_result(int s, int) { return s; }
};

struct Bq1 {
  static constexpr bool kStrong = false;
  struct Acc {
    int h = 0;
    __device__ __forceinline__ void add(uint32_t qp, uint32_t, uint32_t rp,
                                        uint32_t) {
      h += __popc(qp ^ rp);
    }
    __device__ __forceinline__ int result(int) const { return h; }
  };
  __device__ __forceinline__ static int pool_result(int s, int dim) {
    return (dim - s) >> 1;
  }
};
