// hamming: 1-bit SimHash Hamming distance over the sign plane of gathered rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hamming.py::_hamming_kernel
// (pallas_call in hamming_distance_pallas).  That kernel scores (Q, W) x
// (N, W) dense tiles of sign words; every caller of it (the bq1 metric
// space, through repro/kernels/dispatch.py::bq1_ops) gathers the sign rows
// first.  Here both entry points are gather-fused: they read the sign plane,
// the first W words of each row of the (N, 2W) signature table, by id and in
// place, so neither a gathered (B, K, W) copy nor a sign-plane copy of the
// table is written to device memory.  They return popcount(xor) as int32.
// Padding bits are 0 in both planes of every signature, so no valid-bit mask
// is needed.
//
//   dist_rows(q (B, W), ids (B, K), table (N, 2W)) -> (B, K)
//     the bq1 beam hop and build scoring (K = expand * R_total)
//   pairwise(ids (B, C), table (N, 2W))             -> (B, C, C)
//     the bq1 alpha-prune pool (C = prune_pool, or R_total on consolidation)
//
// Bound on an H100.  dist_rows moves B*K*(4W + 8) bytes, almost all of it the
// gathered sign words, and does 3 integer operations per word pair (xor,
// popcount, add): at the hop's shape (B = 256, K = 72, W = 24) 1.9 MB against
// 3.35 TB/s, and 1.3 M operations, so a launch costs more than the work.
// pairwise reads B*C*4W bytes and writes B*C*C*4 bytes and does C times as
// many word pairs per row read: at (256, 128, 24) 20 MB against 0.3 G
// operations; the output write sets its bound.
//
// Design, simple first, as in bq_distance.cu.  dist_rows: one block per
// (query, 128 ids); the query's sign words sit in shared memory, and each
// thread walks the W words of its own gathered row (__popc on 32-bit words),
// so no cross-thread reduction is needed.  pairwise: one block per pool; the
// block gathers the C sign rows into shared memory once (coalesced:
// neighbouring threads load neighbouring words), with the row stride padded to
// W + 1 words so that thread j reading row j hits distinct banks; thread j
// then scores row j against every row i, reading row i as a broadcast, and
// writes out[i][j], coalesced over j.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsThreads = 128;

__global__ void dist_rows_kernel(const uint32_t* __restrict__ q,
                                 const int32_t* __restrict__ ids,
                                 const uint32_t* __restrict__ table,
                                 int32_t* __restrict__ out, int k_ids, int w,
                                 long long n_rows) {
  extern __shared__ uint32_t sq[];  // the query's w sign words
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < w; i += blockDim.x) sq[i] = q[b * w + i];
  __syncthreads();

  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= k_ids) return;
  const long long id = ids[b * k_ids + k];
  int dist = 0;
  if (id >= 0 && id < n_rows) {  // callers pass valid ids; never read out of bounds
    const uint32_t* row = table + id * 2 * w;  // sign plane: words [0, w)
    for (int i = 0; i < w; ++i) dist += __popc(sq[i] ^ row[i]);
  }
  out[b * k_ids + k] = dist;
}

__global__ void pairwise_kernel(const int32_t* __restrict__ ids,
                                const uint32_t* __restrict__ table,
                                int32_t* __restrict__ out, int c, int w,
                                long long n_rows) {
  extern __shared__ uint32_t sm[];  // c sign rows of stride w + 1
  const int stride = w + 1;
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < c * w; e += blockDim.x) {
    const int row = e / w, word = e - row * w;
    const long long id = ids[b * c + row];
    sm[row * stride + word] =
        (id >= 0 && id < n_rows) ? table[id * 2 * w + word] : 0u;
  }
  __syncthreads();

  const int j = threadIdx.x;
  if (j >= c) return;
  const uint32_t* rj = sm + j * stride;
  int32_t* ob = out + b * c * c;
  for (int i = 0; i < c; ++i) {
    const uint32_t* ri = sm + i * stride;
    int dist = 0;
    for (int t = 0; t < w; ++t) dist += __popc(ri[t] ^ rj[t]);
    ob[(long long)i * c + j] = dist;
  }
}

}  // namespace

// q: (b, w) sign words; ids: (b, k) int32; table: (n_rows, 2w) words;
// out: (b, k) int32.  Returns cudaGetLastError() after the launch.
extern "C" int quiver_hamming_dist_rows(const void* q, const void* ids,
                                        const void* table, void* out, int b,
                                        int k, int w, long long n_rows,
                                        void* stream) {
  if (b > 0 && k > 0) {
    const dim3 grid(b, (k + kRowsThreads - 1) / kRowsThreads);
    const size_t smem = (size_t)w * sizeof(uint32_t);
    dist_rows_kernel<<<grid, kRowsThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)q, (const int32_t*)ids, (const uint32_t*)table,
        (int32_t*)out, k, w, n_rows);
  }
  return (int)cudaGetLastError();
}

// ids: (b, c) int32, c <= 1024; table: (n_rows, 2w) words; out: (b, c, c)
// int32.  Returns cudaGetLastError() after the launch.
extern "C" int quiver_hamming_pairwise(const void* ids, const void* table,
                                       void* out, int b, int c, int w,
                                       long long n_rows, void* stream) {
  if (b > 0 && c > 0) {
    const size_t smem = (size_t)c * (w + 1) * sizeof(uint32_t);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          pairwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int threads = (c + 31) / 32 * 32;
    pairwise_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint32_t*)table, (int32_t*)out, c, w,
        n_rows);
  }
  return (int)cudaGetLastError();
}
