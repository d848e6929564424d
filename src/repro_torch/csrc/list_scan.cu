// list_scan: symmetric 2-bit Sign-Magnitude similarity of every query to
// every IVF list centroid.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/list_scan.py::_list_scan_kernel (pallas_call in
// list_scan_pallas).  That kernel keeps the whole (L, 2W) centroid matrix
// resident in VMEM and streams (8, 2W) query blocks past it; its caller pads
// Q to 8 and L to 128 with zero signatures and slices the pads off.  Here the
// kernel takes the true Q and L and masks the ragged edges itself, and it
// returns the positive Table-1 similarity (QuIVer Table 1: +-4 / +-2 / +-1 by
// sign agreement x magnitude class, padding bits masked) as int32:
//
//   list_scan(q (Q, 2W), cent (L, 2W), mask (W)) -> (Q, L)
//     partition assignment (Q = 8192 a chunk), the IVF-seeded build chunk
//     and the nav="ivf" search batch (Q = 256); L ~ sqrt(N) (316 at 100k).
//
// Bound on an H100.  The scan reads (Q + L) * 8W bytes and writes Q * L * 4,
// but does about 26 integer operations for each of its Q * L * W word pairs
// (8 to form the planes, 6 ANDs, 6 popcounts, 6 adds): at (8192, 316, 24)
// that is 17 MB against 1.6 G operations, and at the search batch's
// (256, 316, 24) 0.4 MB against 50 M operations.  It is bound by the integer
// pipes (popcount runs at a quarter of the int32 rate), not by memory.
//
// Shared memory sets the design.  The whole centroid matrix is L * 8W bytes:
// 60.7 KB at L = 316, D = 768, but 243 KB at D = 3072, more than the 227 KB a
// block may hold, and 192 KB at the 1M scale's L = 1000.  So the centroids
// are tiled: blockIdx.y picks a tile of kLTile centroids, blockIdx.x a tile of
// kQTile queries.  A block loads its centroid tile into shared memory once
// (coalesced: neighbouring threads load neighbouring words of the contiguous
// tile) with the row stride padded to 2W + 1 words, so that thread l reading
// row l hits distinct banks, and its kQTile query rows beside it.  Thread l
// then keeps kQTile sums in registers, walks the W words, reads its
// centroid's word pair once per word and every query's as a broadcast, and
// writes out[q][l0 + l] for each query, coalesced over l.  Rows past Q or L
// load as zeros and are never written.  The tile's shared memory is
// (kLTile * (2W + 1) + kQTile * 2W + W) * 4 bytes, 105 KB at D = 3072: above
// 48 KB the launch raises the block's dynamic shared-memory limit first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bq_sim.cuh"

namespace {

constexpr int kLTile = 128;  // centroids a block, one a thread
constexpr int kQTile = 8;    // queries a block, one register sum each

__global__ void list_scan_kernel(const uint32_t* __restrict__ q,
                                 const uint32_t* __restrict__ cent,
                                 const uint32_t* __restrict__ mask,
                                 int32_t* __restrict__ out, int n_q, int n_l,
                                 int w) {
  // [centroid tile (kLTile rows, stride 2w + 1) | query tile (kQTile rows,
  //  stride 2w) | mask (w)]
  extern __shared__ uint32_t sm[];
  const int ww = 2 * w;
  const int stride = ww + 1;
  uint32_t* sq = sm + kLTile * stride;
  uint32_t* smask = sq + kQTile * ww;
  const long long q0 = (long long)blockIdx.x * kQTile;
  const long long l0 = (long long)blockIdx.y * kLTile;

  for (int e = threadIdx.x; e < kLTile * ww; e += blockDim.x) {
    const int row = e / ww, word = e - row * ww;
    sm[row * stride + word] = (l0 + row < n_l) ? cent[l0 * ww + e] : 0u;
  }
  for (int e = threadIdx.x; e < kQTile * ww; e += blockDim.x) {
    const int row = e / ww;
    sq[e] = (q0 + row < n_q) ? q[q0 * ww + e] : 0u;
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x) smask[i] = mask[i];
  __syncthreads();

  const int l = threadIdx.x;
  const uint32_t* rc = sm + l * stride;
  int sim[kQTile];
#pragma unroll
  for (int j = 0; j < kQTile; ++j) sim[j] = 0;
  for (int t = 0; t < w; ++t) {
    const uint32_t cp = rc[t], cs = rc[w + t], m = smask[t];
#pragma unroll
    for (int j = 0; j < kQTile; ++j)
      sim[j] += sim_word(sq[j * ww + t], sq[j * ww + w + t], cp, cs, m);
  }
  if (l0 + l >= n_l) return;
#pragma unroll
  for (int j = 0; j < kQTile; ++j)
    if (q0 + j < n_q) out[(q0 + j) * n_l + l0 + l] = sim[j];
}

}  // namespace

// q: (n_q, 2w) words; cent: (n_l, 2w) words; mask: (w) words;
// out: (n_q, n_l) int32.  Returns cudaGetLastError() after the launch, or the
// error of a shared-memory request above the card's limit (w > ~220).
extern "C" int quiver_list_scan(const void* q, const void* cent,
                                const void* mask, void* out, int n_q, int n_l,
                                int w, void* stream) {
  if (n_q > 0 && n_l > 0) {
    const size_t smem =
        ((size_t)kLTile * (2 * w + 1) + (size_t)kQTile * 2 * w + w) *
        sizeof(uint32_t);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          list_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((n_q + kQTile - 1) / kQTile, (n_l + kLTile - 1) / kLTile);
    list_scan_kernel<<<grid, kLTile, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)q, (const uint32_t*)cent, (const uint32_t*)mask,
        (int32_t*)out, n_q, n_l, w);
  }
  return (int)cudaGetLastError();
}
