// bq_gather.cuh: the gather-fused dist_rows kernel, a template over the
// metric space (bq_space.cuh), shared by bq_distance.cu (Bq2) and hamming.cu
// (Bq1).
//
//   dist_rows(q (B, P*W), ids (B, K), table (N, 2W)) -> (B, K) int32
//
// with P = 2 planes for Bq2 and 1 for Bq1.  A gather: each gathered row
// meets one query, so nothing is reused and the tensor cores have nothing to
// do.  At the beam hop's shape (B = 256, K = 72, W = 24) the launch and two
// dependent loads (the id, then its row) are what it waits on; at the IVF
// build chunk's (256, 34 080, 24) the rows come through L2 and the popcounts
// issue at a quarter of the int32 rate (16 an SM a clock).
//
// Design.  A group of G lanes scores one row; each lane reads 16-byte
// vectors of each plane the space reads (VEC = 4 words; 4-byte words when W
// is not a multiple of 4) at vector l, l + G, l + 2G of the row, so a warp's
// load touches 32 / G rows, each in whole 32-byte sectors, and the group's
// sums meet by shuffles.  G is the least power of two with 3G vectors
// covering a plane (G = 2 at D = 768), at most 32, so a lane holds its query
// vectors in registers, loaded once for all the rows it scores (past 96
// vectors, a lane of a 32-lane group reads the rest of the query and the row
// a vector at a time); the next row's id is loaded while this row is scored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bq_space.cuh"

constexpr int kRowsThreads = 128;
constexpr int kRowIters = 3;  // vectors of a plane a lane holds in registers

template <int VEC>
__device__ __forceinline__ void load_vec(uint32_t (&dst)[VEC],
                                         const uint32_t* src) {
  if constexpr (VEC == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    dst[0] = __ldg(src);
  }
}

// a vector of the strong plane, or zeros where the space reads none
template <class S, int VEC>
__device__ __forceinline__ void load_strong(uint32_t (&dst)[VEC],
                                            const uint32_t* src) {
  if constexpr (S::kStrong) {
    load_vec<VEC>(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = 0u;
  }
}

template <class S, int G, int VEC>
__global__ void __launch_bounds__(kRowsThreads)
    dist_rows_kernel(const uint32_t* __restrict__ q,
                     const int32_t* __restrict__ ids,
                     const uint32_t* __restrict__ table,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int k_ids, int w,
                     long long n_rows, int k_blocks, int rows_per_block) {
  constexpr int kGroups = kRowsThreads / G;
  constexpr int kQueryPlanes = S::kStrong ? 2 : 1;
  const long long b = blockIdx.x / k_blocks;
  const int kb = blockIdx.x % k_blocks;
  const int lane_g = threadIdx.x % G;
  const int nv = w / VEC;
  const unsigned group_mask =
      G == 32 ? 0xFFFFFFFFu
              : ((1u << G) - 1u) << (threadIdx.x % 32 / G * G);
  const int k1 = min(k_ids, (kb + 1) * rows_per_block);
  int k = kb * rows_per_block + (int)threadIdx.x / G;
  // the first row's id before the query, so that the two loads overlap
  long long id = k < k1 ? ids[b * k_ids + k] : -1;
  const uint32_t* qb = q + b * kQueryPlanes * w;

  // this lane's vectors of the query (and for Bq2 of the mask)
  uint32_t qp[kRowIters][VEC], qs[kRowIters][VEC], qm[kRowIters][VEC];
#pragma unroll
  for (int j = 0; j < kRowIters; ++j) {
    const int v = lane_g + j * G;
    if (v < nv) {
      load_vec<VEC>(qp[j], qb + v * VEC);
      load_strong<S, VEC>(qs[j], qb + w + v * VEC);
      if constexpr (S::kStrong) load_vec<VEC>(qm[j], mask + v * VEC);
    }
  }
  int dim = -1;  // this lane's share of D (the mask's bits), once the first
                 // row's loads are under way

  for (; k < k1; k += kGroups) {
    const long long next =
        k + kGroups < k1 ? ids[b * k_ids + k + kGroups] : -1;
    // callers pass valid ids; never read out of bounds
    const bool ok = id >= 0 && id < n_rows;
    typename S::Acc acc;
    if (ok) {
      const uint32_t* row = table + id * 2 * w;
      uint32_t rp[kRowIters][VEC], rs[kRowIters][VEC];
#pragma unroll
      for (int j = 0; j < kRowIters; ++j) {
        const int v = lane_g + j * G;
        if (v < nv) {
          load_vec<VEC>(rp[j], row + v * VEC);
          load_strong<S, VEC>(rs[j], row + w + v * VEC);
        }
      }
#pragma unroll
      for (int j = 0; j < kRowIters; ++j) {
        if (lane_g + j * G < nv) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc.add(qp[j][e], qs[j][e], rp[j][e], rs[j][e]);
        }
      }
      if constexpr (G == 32) {
        // rows of more than kRowIters * 32 vectors: the rest, the query's
        // vectors read again for each row
        for (int v = lane_g + kRowIters * G; v < nv; v += G) {
          uint32_t ap[VEC], as[VEC], bp[VEC], bs[VEC];
          load_vec<VEC>(ap, qb + v * VEC);
          load_strong<S, VEC>(as, qb + w + v * VEC);
          load_vec<VEC>(bp, row + v * VEC);
          load_strong<S, VEC>(bs, row + w + v * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc.add(ap[e], as[e], bp[e], bs[e]);
        }
      }
    }
    if (dim < 0) {
      dim = 0;
      if constexpr (S::kStrong) {
#pragma unroll
        for (int j = 0; j < kRowIters; ++j)
          if (lane_g + j * G < nv)
#pragma unroll
            for (int e = 0; e < VEC; ++e) dim += __popc(qm[j][e]);
        if constexpr (G == 32) {
          for (int v = lane_g + kRowIters * G; v < nv; v += G) {
            uint32_t m[VEC];
            load_vec<VEC>(m, mask + v * VEC);
#pragma unroll
            for (int e = 0; e < VEC; ++e) dim += __popc(m[e]);
          }
        }
      }
    }
    int sim = acc.result(dim);
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      sim += __shfl_xor_sync(group_mask, sim, off);
    if (lane_g == 0) out[b * k_ids + k] = ok ? sim : 0;
    id = next;
  }
}

template <class S, int VEC>
void launch_rows(int g, unsigned blocks, cudaStream_t stream,
                 const uint32_t* q, const int32_t* ids, const uint32_t* table,
                 const uint32_t* mask, int32_t* out, int k, int w,
                 long long n_rows, int k_blocks, int rows_per_block) {
#define QUIVER_ROWS(G)                                                    \
  dist_rows_kernel<S, G, VEC><<<blocks, kRowsThreads, 0, stream>>>(      \
      q, ids, table, mask, out, k, w, n_rows, k_blocks, rows_per_block)
  switch (g) {
    case 1: QUIVER_ROWS(1); break;
    case 2: QUIVER_ROWS(2); break;
    case 4: QUIVER_ROWS(4); break;
    case 8: QUIVER_ROWS(8); break;
    case 16: QUIVER_ROWS(16); break;
    default: QUIVER_ROWS(32); break;
  }
#undef QUIVER_ROWS
}

// The launch of dist_rows: q (b, P*w) words; ids (b, k) int32; table
// (n_rows, 2w) words; mask (w) words (read by Bq2 only); out (b, k) int32.
// vec: 4 to read 16-byte vectors (w % 4 == 0 and q, table and mask 16-byte
// aligned), else 1; any w.  Returns cudaGetLastError() after the launch.
template <class S>
int launch_gather(const void* q, const void* ids, const void* table,
                  const void* mask, void* out, int b, int k, int w,
                  long long n_rows, int vec, void* stream) {
  if (b > 0 && k > 0) {
    if ((vec != 1 && vec != 4) || w % vec != 0)
      return (int)cudaErrorInvalidValue;
    const int nv = w / vec;
    int g = 1;
    while (g < 32 && g * kRowIters < nv) g *= 2;
    // a block scores kRowsThreads / g rows at once, up to 8 times over
    // when K is long
    const int groups = kRowsThreads / g;
    const int rows_per_block = groups * max(1, min(8, k / (8 * groups)));
    const int k_blocks = (k + rows_per_block - 1) / rows_per_block;
    const long long blocks = (long long)b * k_blocks;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const auto launch = vec == 4 ? launch_rows<S, 4> : launch_rows<S, 1>;
    launch(g, (unsigned)blocks, (cudaStream_t)stream, (const uint32_t*)q,
           (const int32_t*)ids, (const uint32_t*)table,
           (const uint32_t*)mask, (int32_t*)out, k, w, n_rows, k_blocks,
           rows_per_block);
  }
  return (int)cudaGetLastError();
}
