// hamming: 1-bit SimHash Hamming distance over the sign plane of gathered rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hamming.py::_hamming_kernel
// (pallas_call in hamming_distance_pallas).  That kernel scores (Q, W) x
// (N, W) dense tiles of sign words; every caller of it (the bq1 metric
// space, through repro/kernels/dispatch.py::bq1_ops) gathers the sign rows
// first.  Here both entry points are gather-fused: they read the sign plane,
// the first W words of each row of the (N, 2W) signature table, by id and in
// place, so neither a gathered (B, K, W) copy nor a sign-plane copy of the
// table is written to device memory.  They return the distance as int32.
//
//   dist_rows(q (B, W), ids (B, K), table (N, 2W))        -> (B, K)
//     the bq1 beam hop and build scoring (K = expand * R_total)
//   pairwise(ids (B, C), table (N, 2W), mask (W))         -> (B, C, C)
//     the bq1 alpha-prune pool (C = prune_pool, or R_total on consolidation)
//
// Both are the Bq1 cases of the kernels bq_distance.cu instantiates for the
// 2-bit space (bq_space.cuh says how the two spaces differ):
//
// * dist_rows is the gather of bq_gather.cuh over the sign plane alone, one
//   popcount of the xor a word pair and no mask (padding bits are 0 in the
//   sign plane of every signature, so their xor is 0).  It moves
//   B*K*(4W + 8) bytes, almost all of it the gathered sign words, and does 3
//   integer operations a word pair (xor, popcount, add): at the hop's shape
//   (B = 256, K = 72, W = 24) 1.9 MB against 3.35 TB/s and 1.3 M
//   operations, so the launch and two dependent loads are what it waits on.
// * pairwise is the pool of bq_pool.cuh: the pool's sign bits decoded to
//   +-1 int8 levels (0 at a masked padding bit), multiplied on the tensor
//   cores over the tiles on and above the diagonal, each written as
//   (D - s) / 2 with its mirror.  It reads C*(4W + 4) bytes a pool and
//   writes 4 C^2: at (256, 128, 24) 3.3 MB against 16.8 MB of output, which
//   sets its bound.

#include "bq_gather.cuh"
#include "bq_pool.cuh"

// q: (b, w) sign words; ids: (b, k) int32; table: (n_rows, 2w) words; out:
// (b, k) int32.  vec: 4 to read 16-byte vectors (w % 4 == 0 and q and table
// 16-byte aligned), else 1; any w.  Returns cudaGetLastError() after the
// launch.
extern "C" int quiver_hamming_dist_rows(const void* q, const void* ids,
                                        const void* table, void* out, int b,
                                        int k, int w, long long n_rows,
                                        int vec, void* stream) {
  return launch_gather<Bq1>(q, ids, table, nullptr, out, b, k, w, n_rows,
                            vec, stream);
}

// ids: (b, c) int32; table: (n_rows, 2w) words; mask: (w) words, the valid
// bits; out: (b, c, c) int32.  Any w; c up to 46 336.  Launches the
// diagonal tiles, then (c > 128) the tiles above them.  Returns
// cudaGetLastError() after the launches.
extern "C" int quiver_hamming_pairwise(const void* ids, const void* table,
                                       const void* mask, void* out, int b,
                                       int c, int w, long long n_rows,
                                       void* stream) {
  return launch_pool<Bq1>(ids, table, mask, out, b, c, w, n_rows, stream);
}
