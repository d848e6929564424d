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
// Both are the Bq2 cases of the shared kernels: dist_rows the gather of
// bq_gather.cuh, pairwise the pool of bq_pool.cuh (hamming.cu instantiates
// the same two for the 1-bit space); their designs are described there.
//
// dist_rows moves B*K*(8W + 8) bytes (the rows, the ids, the output) and
// does, a word pair, the three popcounts of the identity below and four
// logic operations and three adds.  At the hop's shape (B = 256, K = 72,
// W = 24) that is 3.6 MB, about a microsecond at 3.35 TB/s, so the launch
// and two dependent loads (the id, then its row) are what it waits on.  At
// the IVF build chunk's (256, 34 080, 24) it gathers 8.7 M rows, 1.67 GB
// read through L2 from a 19 MB table, and 0.63 G popcounts, which issue at a
// quarter of the int32 rate (16 an SM a clock): about 0.17 ms on 132 SMs at
// 1.755 GHz.  Per word pair, with d = pa ^ pb, x = sa ^ sb and o = sa | sb,
// a valid bit's weight is 1 + 3 o - 2 (d ^ x) - 6 (d & o) (+-1 both weak,
// +-2 one strong, +-4 both strong), and padding bits, 0 in every plane,
// weigh 0 but for the 1, so
//
//   sim = D + 3 pop(o) - 2 pop(d ^ x) - 6 pop(d & o)
//
// summed over the words: three popcounts and no mask where Table 1's
// formula takes six and the mask; kernels/bq_distance.py's
// similarity_three_popcounts is the same identity in torch.
//
// pairwise is a product: sim = L . L^T of the pool's +-1/+-2 int8 levels,
// 2 C^2 D operations a pool against C (8W + 4) bytes read and 4 C^2
// written.  At (256, 128, 768) that is 6.4 G operations (3.3 us at 1 979
// TOP/s) against 23 MB (6.9 us at 3.35 TB/s), 16.8 MB of it the output: the
// stores bound it.

#include "bq_gather.cuh"
#include "bq_pool.cuh"

// q: (b, 2w) words; ids: (b, k) int32; table: (n_rows, 2w) words; mask: (w)
// words; out: (b, k) int32.  vec: 4 to read 16-byte vectors (w % 4 == 0 and
// q, table and mask 16-byte aligned), else 1; any w.  Returns
// cudaGetLastError() after the launch.
extern "C" int quiver_bq_dist_rows(const void* q, const void* ids,
                                   const void* table, const void* mask,
                                   void* out, int b, int k, int w,
                                   long long n_rows, int vec, void* stream) {
  return launch_gather<Bq2>(q, ids, table, mask, out, b, k, w, n_rows, vec,
                            stream);
}

// ids: (b, c) int32; table: (n_rows, 2w) words; mask: (w) words; out:
// (b, c, c) int32.  Any w; c up to 46 336 (a grid dimension of tile
// pairs).  Launches the diagonal tiles, then (c > 128) the tiles above
// them.  Returns cudaGetLastError() after the launches.
extern "C" int quiver_bq_pairwise(const void* ids, const void* table,
                                  const void* mask, void* out, int b, int c,
                                  int w, long long n_rows, void* stream) {
  return launch_pool<Bq2>(ids, table, mask, out, b, c, w, n_rows, stream);
}
