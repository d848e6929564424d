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
//     the beam hop (K = expand * R_total), consolidate_rows, medoid_scan
//   pairwise(ids (B, C), table (N, 2W), mask (W))               -> (B, C, C)
//     the alpha-prune pool (C = prune_pool, or R_total on consolidation)
//
// Bound on an H100.  dist_rows moves B*K*(8W + 8) bytes, almost all of it the
// gathered rows, and does about 26 integer operations per word pair (8 to form
// the planes, 6 ANDs, 6 popcounts, 6 adds): at the hop's shape (B = 256,
// K = 72, W = 24) that is 3.6 MB against 3.35 TB/s and 11.5 M operations, a
// microsecond or so either way, so a launch costs more than the work.
// pairwise reads B*C*8W bytes and writes B*C*C*4 bytes, but does C times as
// many word pairs per row read: at (256, 128, 24) it is 23 MB against 2.6 G
// operations, bound by the integer pipes (popcount issues at a quarter of the
// int32 rate), not by memory.
//
// Design, simple first.  dist_rows: one block per (query, 128 ids); the
// query words and the mask sit in shared memory, and each thread walks the W
// words of its own gathered row in a loop (__popc on 32-bit words), so the
// word loop stays inside one thread and no cross-thread reduction is needed.
// pairwise: one block per pool; the block gathers the C rows into shared
// memory once (coalesced: neighbouring threads load neighbouring words), with
// the row stride padded to 2W + 1 words so that thread j reading row j hits
// distinct banks; thread j then scores row j against every row i, reading row
// i as a broadcast, and writes out[i][j], coalesced over j.  Each gathered row
// is read from device memory once per pool.  Faster forms (half the symmetric
// matrix, fewer popcounts per word, several rows per thread) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bq_sim.cuh"

namespace {

constexpr int kRowsThreads = 128;

__global__ void dist_rows_kernel(const uint32_t* __restrict__ q,
                                 const int32_t* __restrict__ ids,
                                 const uint32_t* __restrict__ table,
                                 const uint32_t* __restrict__ mask,
                                 int32_t* __restrict__ out, int k_ids, int w,
                                 long long n_rows) {
  extern __shared__ uint32_t sm[];  // [q pos (w) | q strong (w) | mask (w)]
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * w; i += blockDim.x)
    sm[i] = q[b * 2 * w + i];
  for (int i = threadIdx.x; i < w; i += blockDim.x) sm[2 * w + i] = mask[i];
  __syncthreads();

  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= k_ids) return;
  const long long id = ids[b * k_ids + k];
  int sim = 0;
  if (id >= 0 && id < n_rows) {  // callers pass valid ids; never read out of bounds
    const uint32_t* row = table + id * 2 * w;
    for (int i = 0; i < w; ++i)
      sim += sim_word(sm[i], sm[w + i], row[i], row[w + i], sm[2 * w + i]);
  }
  out[b * k_ids + k] = sim;
}

__global__ void pairwise_kernel(const int32_t* __restrict__ ids,
                                const uint32_t* __restrict__ table,
                                const uint32_t* __restrict__ mask,
                                int32_t* __restrict__ out, int c, int w,
                                long long n_rows) {
  extern __shared__ uint32_t sm[];  // c rows of stride 2w + 1, then the mask
  const int ww = 2 * w;
  const int stride = ww + 1;
  uint32_t* smask = sm + c * stride;
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < c * ww; e += blockDim.x) {
    const int row = e / ww, word = e - row * ww;
    const long long id = ids[b * c + row];
    sm[row * stride + word] =
        (id >= 0 && id < n_rows) ? table[id * ww + word] : 0u;
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x) smask[i] = mask[i];
  __syncthreads();

  const int j = threadIdx.x;
  if (j >= c) return;
  const uint32_t* rj = sm + j * stride;
  int32_t* ob = out + b * c * c;
  for (int i = 0; i < c; ++i) {
    const uint32_t* ri = sm + i * stride;
    int sim = 0;
    for (int t = 0; t < w; ++t)
      sim += sim_word(ri[t], ri[w + t], rj[t], rj[w + t], smask[t]);
    ob[(long long)i * c + j] = sim;
  }
}

}  // namespace

// q: (b, 2w) words; ids: (b, k) int32; table: (n_rows, 2w) words; mask: (w)
// words; out: (b, k) int32.  Returns cudaGetLastError() after the launch.
extern "C" int quiver_bq_dist_rows(const void* q, const void* ids,
                                   const void* table, const void* mask,
                                   void* out, int b, int k, int w,
                                   long long n_rows, void* stream) {
  if (b > 0 && k > 0) {
    const dim3 grid(b, (k + kRowsThreads - 1) / kRowsThreads);
    const size_t smem = (size_t)3 * w * sizeof(uint32_t);
    dist_rows_kernel<<<grid, kRowsThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)q, (const int32_t*)ids, (const uint32_t*)table,
        (const uint32_t*)mask, (int32_t*)out, k, w, n_rows);
  }
  return (int)cudaGetLastError();
}

// ids: (b, c) int32, c <= 1024; table: (n_rows, 2w) words; mask: (w) words;
// out: (b, c, c) int32.  Returns cudaGetLastError() after the launch.
extern "C" int quiver_bq_pairwise(const void* ids, const void* table,
                                  const void* mask, void* out, int b, int c,
                                  int w, long long n_rows, void* stream) {
  if (b > 0 && c > 0) {
    const size_t smem = ((size_t)c * (2 * w + 1) + w) * sizeof(uint32_t);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          pairwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int threads = (c + 31) / 32 * 32;
    pairwise_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint32_t*)table, (const uint32_t*)mask,
        (int32_t*)out, c, w, n_rows);
  }
  return (int)cudaGetLastError();
}
