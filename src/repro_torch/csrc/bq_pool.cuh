// bq_pool.cuh: the pairwise (pool) kernel on the int8 tensor cores, a
// template over the metric space (bq_space.cuh), shared by bq_distance.cu
// (Bq2) and hamming.cu (Bq1).
//
//   pairwise(ids (B, C), table (N, 2W), mask (W)) -> (B, C, C) int32
//
// A product: the pool's int8 levels L (int8_levels.cuh) times L^T, 2 C^2 D
// operations a pool against C (P*4W + 4) bytes read (P planes) and 4 C^2
// written.  At (256, 128, 768) that is 6.4 G operations (3.3 us at 1 979
// TOP/s) against 16.8 MB of output alone (5.0 us at 3.35 TB/s): the stores
// bound it.
//
// Design.  A block of 8 warps takes one pool's 128 x 128 tile pair (I, J),
// I <= J: one launch for the diagonal tiles (I = J), so one block a pool of
// C <= 128 over a grid of (pools, tiles); for C > 128 a second launch for
// the tiles above them, which also write their mirror.  Two blocks fit an SM
// (<= 128 registers, 68 KB of shared memory on the diagonal, 74 KB off it),
// which holds B = 256 pools in one wave of 264 slots.  The block walks D in
// chunks of 128 dimensions: its threads load the chunk's words of the tile's
// rows (the rows of I, then of J off the diagonal) into registers, the warps
// multiply the chunk already in shared memory, then the threads decode the
// words into int8 levels in the other buffer (rows padded by 16 bytes;
// int8_levels.cuh's store_levels), one barrier a chunk.  Ids past C or
// outside the table decode as zero rows that are never written.  On the
// diagonal only the m16n8 tiles on and above it are multiplied (those whose
// 16-row strip starts at or before their columns): 72 of 128, and warp r and
// r + 4 (r < 4) share strips r and 7 - r, 18 tiles, 9 each (WarpTiles).  Off
// the diagonal each warp takes one strip of 16 rows across the 128 columns.
// mma.sync m16n8k32 s8 accumulates exact int32 sums (|sim| <= 4D).  The
// output leaves through shared memory, reusing the level buffers: the whole
// 128 x 128 tile, each result (the space's pool_result of its sum) staged at
// (i, j) and at its mirror (j, i), then each warp writes whole rows in
// 16-byte stores (4-byte stores when C is not a multiple of 4).  Each
// element of the (B, C, C) output is written once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bq_space.cuh"
#include "int8_levels.cuh"

constexpr int kPairThreads = 256;        // 8 warps
constexpr int kTile = 128;               // pool rows a tile
constexpr int kStrips = kTile / 16;      // 16-row strips a tile
constexpr int kStageStride = kTile + 4;  // int32s a staged output row

// Shared memory of a block: two chunk buffers of levels (the rows of tile
// I, and of J below them off the diagonal), which then hold the staged
// 128 x 128 output tile
inline size_t pairwise_smem(bool off_diagonal) {
  const size_t levels = (size_t)2 * (off_diagonal ? 2 : 1) * kTile * kRowBytes;
  const size_t staged = (size_t)kTile * kStageStride * 4;
  return levels > staged ? levels : staged;
}

// Where warp W's m16n8 tiles lie, every index known at compile time.  A
// warp multiplies NT tiles t: columns col(t) * 8 .. + 8 against a 16-row
// strip, lo or hi.  On the diagonal, warp w and w + 4 share strips
// lo = w % 4 and hi = 7 - lo, whose tiles on and above the diagonal are
// columns 2 lo .. 15 and 2 hi .. 15, 18 in all: warp w takes the first 9
// (col = 2 lo + t), warp w + 4 the rest (col = 2 lo + 9 + t, and from
// t = split = 7 - 2 lo on the hi strip's, col = 7 + t).  Off it, warp w
// takes strip w across the 16 columns of tile J (col = t).
template <bool DIAG, int W>
struct WarpTiles {
  static constexpr int NT = DIAG ? 9 : 16;
  static constexpr int lo = DIAG ? W % 4 : W;
  static constexpr int hi = kStrips - 1 - lo;
  static constexpr int split = DIAG && W >= 4 ? 7 - 2 * lo : NT;
  static constexpr int lo_col = DIAG ? 2 * lo + (W >= 4 ? 9 : 0) : 0;
  static constexpr int hi_col = 7;
  __host__ __device__ static constexpr int strip(int t) {
    return t >= split ? hi : lo;
  }
  __host__ __device__ static constexpr int col(int t) {
    return t + (t >= split ? hi_col : lo_col);
  }
};

// f(WarpTiles<DIAG, W>{}) for this warp's W (uniform in the warp)
template <bool DIAG, class F>
__device__ __forceinline__ void with_warp_tiles(int warp, F&& f) {
  switch (warp) {
    case 0: f(WarpTiles<DIAG, 0>{}); break;
    case 1: f(WarpTiles<DIAG, 1>{}); break;
    case 2: f(WarpTiles<DIAG, 2>{}); break;
    case 3: f(WarpTiles<DIAG, 3>{}); break;
    case 4: f(WarpTiles<DIAG, 4>{}); break;
    case 5: f(WarpTiles<DIAG, 5>{}); break;
    case 6: f(WarpTiles<DIAG, 6>{}); break;
    default: f(WarpTiles<DIAG, 7>{}); break;
  }
}

// One chunk's products of a warp's tiles; a0 and b0 are this lane's
// ldmatrix addresses of strip 0 and column 0 in the chunk's buffer.  Each
// batch of B fragments is loaded before its products, so the loads
// overlap.
template <class T>
__device__ __forceinline__ void chunk_products(T, int (&acc)[T::NT][4],
                                               uint32_t a0, uint32_t b0) {
  constexpr int NB = T::NT == 9 ? 9 : 8;  // B fragments loaded at once
#pragma unroll
  for (int ks = 0; ks < kChunk / 32; ++ks) {
    uint32_t a_lo[4], a_hi[4];
    ldmatrix_x4(a_lo, a0 + T::lo * 16 * kRowBytes + ks * 32);
    if constexpr (T::split < T::NT)
      ldmatrix_x4(a_hi, a0 + T::hi * 16 * kRowBytes + ks * 32);
#pragma unroll
    for (int t0 = 0; t0 < T::NT; t0 += NB) {
      uint32_t bf[NB][2];
#pragma unroll
      for (int u = 0; u < NB; ++u)
        ldmatrix_x2(bf[u], b0 + T::col(t0 + u) * 8 * kRowBytes + ks * 32);
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (t0 + u >= T::split)
          mma_s8(acc[t0 + u], a_hi, bf[u][0], bf[u][1]);
        else
          mma_s8(acc[t0 + u], a_lo, bf[u][0], bf[u][1]);
      }
    }
  }
}

// A warp's results into the staged output tile st: at (i, j) (direct)
// and at (j, i) (mirror), i the tile row and j the tile column; dim is D
// where the space's result needs it
template <class S, class T>
__device__ __forceinline__ void stage_results(T, const int (&acc)[T::NT][4],
                                              int32_t* st, int lane, int dim,
                                              bool direct, bool mirror) {
#pragma unroll
  for (int t = 0; t < T::NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = T::strip(t) * 16 + lane / 4 + 8 * h;
        const int j = T::col(t) * 8 + (lane % 4) * 2 + e;
        const int v = S::pool_result(acc[t][2 * h + e], dim);
        if (direct) st[i * kStageStride + j] = v;
        if (mirror) st[j * kStageStride + i] = v;
      }
}

// One tile pair (ti, tj) of one pool; sid holds the table row of each tile
// row (-1: a zero row), those of tile tj after kTile off the diagonal.
// Every warp multiplies all of its tiles: a tile past C reads zero rows
// and is not written.
template <class S, bool DIAG>
__device__ __forceinline__ void pairwise_tile(
    const int32_t* __restrict__ sid, int8_t* __restrict__ smem,
    const uint32_t* __restrict__ table, const uint32_t* __restrict__ mask,
    int32_t* __restrict__ ob, int c, int w, int dim, int ti, int tj,
    int rows_i, int rows_j) {
  constexpr int NT = DIAG ? 9 : 16;
  constexpr int ROWS = DIAG ? kTile : 2 * kTile;  // rows a buffer
  constexpr int ITEMS = ROWS * kWords / kPairThreads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t s0 = smem_addr(smem);
  const uint32_t a0 = s0 + (lane % 16) * kRowBytes + (lane / 16) * 16;
  const uint32_t b0 = s0 + ((DIAG ? 0 : kTile) + lane % 8) * kRowBytes +
                      ((lane / 8) % 2) * 16;

  int acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;

  // this thread's (row, word) items of a chunk, loaded a chunk ahead; the
  // strong words stay zeros where the space reads none
  uint32_t rp[ITEMS], rs[ITEMS], rm[ITEMS];
  const int n_chunks = (w + kWords - 1) / kWords;
  for (int ch = -1; ch < n_chunks; ++ch) {
    const int next = ch + 1;
    if (next < n_chunks) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int e = tid + i * kPairThreads;
        const int id = sid[e / kWords], word = next * kWords + e % kWords;
        rp[i] = rs[i] = rm[i] = 0u;
        if (id >= 0 && word < w) {
          const uint32_t* src = table + (long long)id * 2 * w;
          rp[i] = __ldg(src + word);
          if constexpr (S::kStrong) rs[i] = __ldg(src + w + word);
          rm[i] = __ldg(mask + word);
        }
      }
    }
    if (ch >= 0) {
      const uint32_t buf = (ch % 2) * ROWS * kRowBytes;
      with_warp_tiles<DIAG>(warp, [&](auto tiles) {
        chunk_products(tiles, acc, a0 + buf, b0 + buf);
      });
    }
    if (next < n_chunks) {
      int8_t* buf = smem + (size_t)(next % 2) * ROWS * kRowBytes;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int e = tid + i * kPairThreads;
        store_levels(buf + (e / kWords) * kRowBytes + (e % kWords) * 32,
                     rp[i], rs[i], rm[i]);
      }
    }
    __syncthreads();  // one buffer filled, the other free for the next
  }

  // the output through shared memory: on the diagonal each result at
  // (i, j) and (j, i) of the tile; off it the tile (I, J), then its mirror
  // (J, I); then each warp writes whole rows
  int32_t* st = reinterpret_cast<int32_t*>(smem);
#pragma unroll 1
  for (int pass = 0; pass < (DIAG ? 1 : 2); ++pass) {
    const bool mirror = pass == 1;
    with_warp_tiles<DIAG>(warp, [&](auto tiles) {
      stage_results<S>(tiles, acc, st, lane, dim, DIAG || !mirror,
                       DIAG || mirror);
    });
    __syncthreads();
    const int out_rows = mirror ? rows_j : rows_i;
    const int out_cols = DIAG || mirror ? rows_i : rows_j;
    int32_t* o = ob + (long long)(mirror ? tj : ti) * kTile * c +
                 (long long)(mirror ? ti : tj) * kTile;
    if (c % 4 == 0) {  // 16-byte stores: every row starts 16-byte aligned
      for (int r = warp; r < out_rows; r += kPairThreads / 32)
        for (int v = lane; v < out_cols / 4; v += 32)
          *reinterpret_cast<int4*>(o + (long long)r * c + 4 * v) =
              *reinterpret_cast<const int4*>(st + r * kStageStride + 4 * v);
    } else {
      for (int r = warp; r < out_rows; r += kPairThreads / 32)
        for (int j = lane; j < out_cols; j += 32)
          o[(long long)r * c + j] = st[r * kStageStride + j];
    }
    __syncthreads();
  }
}

template <class S, bool DIAG>
__global__ void __launch_bounds__(kPairThreads, 2)
    pairwise_kernel(const int32_t* __restrict__ ids,
                    const uint32_t* __restrict__ table,
                    const uint32_t* __restrict__ mask,
                    int32_t* __restrict__ out, int c, int w,
                    long long n_rows, int nt) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int32_t sid[2 * kTile];
  __shared__ int s_dim;
  // the tile pair: (y, y) on the diagonal; off it (ti, tj), ti < tj, row
  // by row of the strict upper triangle
  int ti = blockIdx.y, tj = blockIdx.y;
  if (!DIAG) {
    int rest = blockIdx.y;
    ti = 0;
    while (rest >= nt - 1 - ti) {
      rest -= nt - 1 - ti;
      ++ti;
    }
    tj = ti + 1 + rest;
  }
  const int rows_i = min(kTile, c - ti * kTile);
  const int rows_j = min(kTile, c - tj * kTile);
  const long long pool = blockIdx.x;
  for (int r = threadIdx.x; r < 2 * kTile; r += kPairThreads) {
    const bool second = r >= kTile;
    const int local = second ? r - kTile : r;
    int id = -1;
    if (local < (second ? rows_j : rows_i) && !(second && DIAG)) {
      const long long x =
          ids[pool * c + (long long)(second ? tj : ti) * kTile + local];
      if (x >= 0 && x < n_rows) id = (int)x;
    }
    sid[r] = id;
  }
  if constexpr (!S::kStrong) {
    // D, the mask's popcount, for the epilogue: warp 0 sums it
    if (threadIdx.x < 32) {
      int d = 0;
      for (int i = threadIdx.x; i < w; i += 32) d += __popc(__ldg(mask + i));
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        d += __shfl_xor_sync(0xFFFFFFFFu, d, off);
      if (threadIdx.x == 0) s_dim = d;
    }
  }
  __syncthreads();
  pairwise_tile<S, DIAG>(sid, smem, table, mask, out + pool * c * c, c, w,
                         S::kStrong ? 0 : s_dim, ti, tj, rows_i, rows_j);
}

// The launches of pairwise: ids (b, c) int32; table (n_rows, 2w) words;
// mask (w) words; out (b, c, c) int32.  Any w; c up to 46 336 (a grid
// dimension of tile pairs).  Launches the diagonal tiles, then (c > 128)
// the tiles above them.  Returns cudaGetLastError() after the launches.
template <class S>
int launch_pool(const void* ids, const void* table, const void* mask,
                void* out, int b, int c, int w, long long n_rows,
                void* stream) {
  if (b > 0 && c > 0) {
    const int nt = (c + kTile - 1) / kTile;
    if (nt > 362) return (int)cudaErrorInvalidValue;  // pairs > 65 535
    for (int diag = 1; diag >= 0 && (diag || nt > 1); --diag) {
      const auto kernel =
          diag ? pairwise_kernel<S, true> : pairwise_kernel<S, false>;
      const size_t smem = pairwise_smem(!diag);
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid(b, diag ? nt : nt * (nt - 1) / 2);
      kernel<<<grid, kPairThreads, smem, (cudaStream_t)stream>>>(
          (const int32_t*)ids, (const uint32_t*)table, (const uint32_t*)mask,
          (int32_t*)out, c, w, n_rows, nt);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
