// bq_distance: symmetric 2-bit Sign-Magnitude similarity over gathered rows.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bq_distance.py::_bq_distance_kernel (pallas_call in
// bq_distance_pallas).  That kernel scores (Q, 2W) x (N, 2W) dense tiles and
// emits -similarity; every caller of it gathers rows first.  Here both entry
// points are gather-fused: they read rows of the (N, 2W) signature table by
// id, so no gathered (B, K, 2W) copy is written to device memory, and they
// return the similarity itself (QuIVer Table 1: +-4 / +-2 / +-1 by sign
// agreement x magnitude class, padding bits masked), as int32.
//
//   dist_rows(q (B, 2W), ids (B, K), table (N, 2W), mask (W)) -> (B, K)
//     the beam hop (K = expand * R_total), consolidate_rows, medoid_scan,
//     the IVF-seeded build chunk and the nav="ivf" search batch
//   pairwise(ids (B, C), table (N, 2W), mask (W))               -> (B, C, C)
//     the alpha-prune pool (C = prune_pool = 128 in a build chunk,
//     C = R_total = 72 on consolidation)
//
// dist_rows is a gather: each gathered row meets one query, so nothing is
// reused and the tensor cores have nothing to do.  It moves B*K*(8W + 8)
// bytes (the rows, the ids, the output) and does, a word pair, the three
// popcounts of the identity below and four logic operations and three
// adds.  At the hop's shape (B = 256, K = 72, W = 24) that is 3.6 MB, about
// a microsecond at 3.35 TB/s, so the launch and two dependent loads (the id,
// then its row) are what it waits on.  At the IVF build chunk's (256,
// 34 080, 24) it gathers 8.7 M rows, 1.67 GB read through L2 from a 19 MB
// table, and 0.63 G popcounts, which issue at a quarter of the int32 rate
// (16 an SM a clock): about 0.17 ms on 132 SMs at 1.755 GHz.
//
// Design of dist_rows.  A group of G lanes scores one row; each lane reads
// 16-byte vectors of both planes (VEC = 4 words; 4-byte words when W is not
// a multiple of 4) at vector l, l + G, l + 2G of the row, so a warp's load
// touches 32 / G rows, each in whole 32-byte sectors, and the group's sums
// meet by shuffles.  G is the least power of two with 3G vectors covering
// the row (G = 2 at D = 768), at most 32, so a lane holds its query vectors
// in registers, loaded once for all the rows it scores (past 96 vectors, a
// lane of a 32-lane group reads the rest of the query and the row a vector
// at a time); the next row's id is loaded while this row is scored.  Per word pair, with d = pa ^ pb,
// x = sa ^ sb and o = sa | sb, a valid bit's weight is
// 1 + 3 o - 2 (d ^ x) - 6 (d & o) (+-1 both weak, +-2 one strong, +-4 both
// strong), and padding bits, 0 in every plane, weigh 0 but for the 1, so
//
//   sim = D + 3 pop(o) - 2 pop(d ^ x) - 6 pop(d & o)
//
// summed over the words: three popcounts and no mask where Table 1's
// formula takes six and the mask; kernels/bq_distance.py's
// similarity_three_popcounts is the same identity in torch.
//
// pairwise is a product: sim = L . L^T of the pool's int8 levels
// (int8_levels.cuh), 2 C^2 D operations a pool against C (8W + 4) bytes
// read and 4 C^2 written.  At (256, 128, 768) that is 6.4 G operations
// (3.3 us at 1 979 TOP/s) against 23 MB (6.9 us at 3.35 TB/s), 16.8 MB of it
// the output: the stores bound it.
//
// Design of pairwise.  A block of 8 warps takes one pool's 128 x 128 tile
// pair (I, J), I <= J: one launch for the diagonal tiles (I = J), so one
// block a pool of C <= 128 over a grid of (pools, tiles); for C > 128 a
// second launch for the tiles above them, which also write their mirror.
// Two blocks fit an SM (<= 128 registers, 68 KB of shared memory on the
// diagonal, 74 KB off it), which holds B = 256 pools in one wave of 264
// slots.  The block walks D in chunks of 128 dimensions: its threads load
// the chunk's words of the tile's rows (the rows of I, then of J off the
// diagonal) into registers, the warps multiply the chunk already in shared
// memory, then the threads decode the words into int8 levels in the other
// buffer (rows padded by 16 bytes; int8_levels.cuh's store_levels), one
// barrier a chunk.  Ids past C or outside the table decode as zero rows
// that are never written.  On the diagonal only the m16n8 tiles on and
// above it are multiplied (those whose 16-row strip starts at or before
// their columns): 72 of 128, and warp r and r + 4 (r < 4) share strips r
// and 7 - r, 18 tiles, 9 each (WarpTiles).  Off the diagonal each warp
// takes one strip of 16 rows across the 128 columns.  mma.sync m16n8k32 s8
// accumulates exact int32 sums (|sim| <= 4D).  The output leaves through
// shared memory, reusing the level buffers: the whole 128 x 128 tile,
// each result staged at (i, j) and at its mirror (j, i), then each warp
// writes whole rows in 16-byte stores (4-byte stores when C is not a
// multiple of 4).  Each element of the (B, C, C) output is written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_levels.cuh"

namespace {

// ---------------------------------------------------------------- dist_rows

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

template <int G, int VEC>
__global__ void __launch_bounds__(kRowsThreads)
    dist_rows_kernel(const uint32_t* __restrict__ q,
                     const int32_t* __restrict__ ids,
                     const uint32_t* __restrict__ table,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int k_ids, int w,
                     long long n_rows, int k_blocks, int rows_per_block) {
  constexpr int kGroups = kRowsThreads / G;
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

  // this lane's vectors of the query and the mask
  uint32_t qp[kRowIters][VEC], qs[kRowIters][VEC], qm[kRowIters][VEC];
#pragma unroll
  for (int j = 0; j < kRowIters; ++j) {
    const int v = lane_g + j * G;
    if (v < nv) {
      load_vec<VEC>(qp[j], q + b * 2 * w + v * VEC);
      load_vec<VEC>(qs[j], q + b * 2 * w + w + v * VEC);
      load_vec<VEC>(qm[j], mask + v * VEC);
    }
  }
  int dim = -1;  // this lane's share of D (the mask's bits), once the first
                 // row's loads are under way

  for (; k < k1; k += kGroups) {
    const long long next =
        k + kGroups < k1 ? ids[b * k_ids + k + kGroups] : -1;
    // callers pass valid ids; never read out of bounds
    const bool ok = id >= 0 && id < n_rows;
    int p_or = 0, p_odd = 0, p_diff = 0;
    if (ok) {
      const uint32_t* row = table + id * 2 * w;
      uint32_t rp[kRowIters][VEC], rs[kRowIters][VEC];
#pragma unroll
      for (int j = 0; j < kRowIters; ++j) {
        const int v = lane_g + j * G;
        if (v < nv) {
          load_vec<VEC>(rp[j], row + v * VEC);
          load_vec<VEC>(rs[j], row + w + v * VEC);
        }
      }
#pragma unroll
      for (int j = 0; j < kRowIters; ++j) {
        if (lane_g + j * G < nv) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const uint32_t d = qp[j][e] ^ rp[j][e];
            const uint32_t o = qs[j][e] | rs[j][e];
            p_or += __popc(o);
            p_odd += __popc(d ^ qs[j][e] ^ rs[j][e]);
            p_diff += __popc(d & o);
          }
        }
      }
      if constexpr (G == 32) {
        // rows of more than kRowIters * 32 vectors: the rest, the query's
        // vectors read again for each row
        for (int v = lane_g + kRowIters * G; v < nv; v += G) {
          uint32_t ap[VEC], as[VEC], bp[VEC], bs[VEC];
          load_vec<VEC>(ap, q + b * 2 * w + v * VEC);
          load_vec<VEC>(as, q + b * 2 * w + w + v * VEC);
          load_vec<VEC>(bp, row + v * VEC);
          load_vec<VEC>(bs, row + w + v * VEC);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const uint32_t d = ap[e] ^ bp[e];
            const uint32_t o = as[e] | bs[e];
            p_or += __popc(o);
            p_odd += __popc(d ^ as[e] ^ bs[e]);
            p_diff += __popc(d & o);
          }
        }
      }
    }
    if (dim < 0) {
      dim = 0;
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
    int sim = dim + 3 * p_or - 2 * p_odd - 6 * p_diff;
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2)
      sim += __shfl_xor_sync(group_mask, sim, off);
    if (lane_g == 0) out[b * k_ids + k] = ok ? sim : 0;
    id = next;
  }
}

template <int VEC>
void launch_rows(int g, unsigned blocks, cudaStream_t stream,
                 const uint32_t* q, const int32_t* ids, const uint32_t* table,
                 const uint32_t* mask, int32_t* out, int k, int w,
                 long long n_rows, int k_blocks, int rows_per_block) {
#define QUIVER_ROWS(G)                                                    \
  dist_rows_kernel<G, VEC><<<blocks, kRowsThreads, 0, stream>>>(         \
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

// ----------------------------------------------------------------- pairwise

constexpr int kPairThreads = 256;        // 8 warps
constexpr int kTile = 128;               // pool rows a tile
constexpr int kStrips = kTile / 16;      // 16-row strips a tile
constexpr int kStageStride = kTile + 4;  // int32s a staged output row

// Shared memory of a block: two chunk buffers of levels (the rows of tile
// I, and of J below them off the diagonal), which then hold the staged
// 128 x 128 output tile
size_t pairwise_smem(bool off_diagonal) {
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
// and at (j, i) (mirror), i the tile row and j the tile column
template <class T>
__device__ __forceinline__ void stage_results(T, const int (&acc)[T::NT][4],
                                              int32_t* st, int lane,
                                              bool direct, bool mirror) {
#pragma unroll
  for (int t = 0; t < T::NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = T::strip(t) * 16 + lane / 4 + 8 * h;
        const int j = T::col(t) * 8 + (lane % 4) * 2 + e;
        if (direct) st[i * kStageStride + j] = acc[t][2 * h + e];
        if (mirror) st[j * kStageStride + i] = acc[t][2 * h + e];
      }
}

// One tile pair (ti, tj) of one pool; sid holds the table row of each tile
// row (-1: a zero row), those of tile tj after kTile off the diagonal.
// Every warp multiplies all of its tiles: a tile past C reads zero rows
// and is not written.
template <bool DIAG>
__device__ __forceinline__ void pairwise_tile(
    const int32_t* __restrict__ sid, int8_t* __restrict__ smem,
    const uint32_t* __restrict__ table, const uint32_t* __restrict__ mask,
    int32_t* __restrict__ ob, int c, int w, int ti, int tj, int rows_i,
    int rows_j) {
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

  // this thread's (row, word) items of a chunk, loaded a chunk ahead
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
          rs[i] = __ldg(src + w + word);
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
      stage_results(tiles, acc, st, lane, DIAG || !mirror, DIAG || mirror);
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

template <bool DIAG>
__global__ void __launch_bounds__(kPairThreads, 2)
    pairwise_kernel(const int32_t* __restrict__ ids,
                    const uint32_t* __restrict__ table,
                    const uint32_t* __restrict__ mask,
                    int32_t* __restrict__ out, int c, int w,
                    long long n_rows, int nt) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int32_t sid[2 * kTile];
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
  __syncthreads();
  pairwise_tile<DIAG>(sid, smem, table, mask, out + pool * c * c, c, w, ti,
                      tj, rows_i, rows_j);
}

}  // namespace

// q: (b, 2w) words; ids: (b, k) int32; table: (n_rows, 2w) words; mask: (w)
// words; out: (b, k) int32.  vec: 4 to read 16-byte vectors (w % 4 == 0 and
// q, table and mask 16-byte aligned), else 1; any w.  Returns
// cudaGetLastError() after the launch.
extern "C" int quiver_bq_dist_rows(const void* q, const void* ids,
                                   const void* table, const void* mask,
                                   void* out, int b, int k, int w,
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
    if (vec == 4)
      launch_rows<4>(g, (unsigned)blocks, (cudaStream_t)stream,
                     (const uint32_t*)q, (const int32_t*)ids,
                     (const uint32_t*)table, (const uint32_t*)mask,
                     (int32_t*)out, k, w, n_rows, k_blocks, rows_per_block);
    else
      launch_rows<1>(g, (unsigned)blocks, (cudaStream_t)stream,
                     (const uint32_t*)q, (const int32_t*)ids,
                     (const uint32_t*)table, (const uint32_t*)mask,
                     (int32_t*)out, k, w, n_rows, k_blocks, rows_per_block);
  }
  return (int)cudaGetLastError();
}

// ids: (b, c) int32; table: (n_rows, 2w) words; mask: (w) words; out:
// (b, c, c) int32.  Any w; c up to 46 336 (a grid dimension of tile
// pairs).  Launches the diagonal tiles, then (c > 128) the tiles above
// them.  Returns cudaGetLastError() after the launches.
extern "C" int quiver_bq_pairwise(const void* ids, const void* table,
                                  const void* mask, void* out, int b, int c,
                                  int w, long long n_rows, void* stream) {
  if (b > 0 && c > 0) {
    const int nt = (c + kTile - 1) / kTile;
    if (nt > 362) return (int)cudaErrorInvalidValue;  // pairs > 65 535
    for (int diag = 1; diag >= 0 && (diag || nt > 1); --diag) {
      const auto kernel = diag ? pairwise_kernel<true> : pairwise_kernel<false>;
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
