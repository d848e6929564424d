// list_scan: symmetric 2-bit Sign-Magnitude similarity of every query to
// every IVF list centroid, on the int8 tensor cores.
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
// The similarity is an exact integer dot product.  Decode each dimension
// of a signature to its level: +-1 by sign, x2 where strong, 0 at a masked
// padding bit.  Table 1's weight of a dimension pair is the product of the
// two levels, so sim(q, c) = sum_d level_q[d] * level_c[d], |sim| <= 4D
// (12 288 at D = 3072): int8 operands and int32 sums hold it exactly.
//
// Bound on an H100.  The scan reads (Q + L) * 8W bytes and writes Q * L * 4;
// as an int8 product it is 2 * Q * L * D operations at 1 979 TOP/s.  At
// (8192, 316, 768) that is 17 MB (5.0 us) against 4.0 G operations (2.0 us),
// at the search batch's (256, 316, 768) 0.4 MB (0.12 us) against 0.12 G
// (0.06 us): the bytes bound it, and at Q = 256 the card is mostly waiting
// on latency.
//
// Design.  One block of 4 warps per (BM queries x BN centroids) output tile:
// 16 x 32 when the card would otherwise hold few tiles (Q = 256, L = 316:
// 160 blocks), 64 x 64 when there are at least two such tiles an SM
// (Q = 8192: 640 blocks).  The block walks D in chunks of 128 dimensions:
// its threads read the chunk's words (4 a plane a row) of its BM query rows
// and BN centroid rows, decode them to int8 levels (a byte permute a four
// dimensions, in an order that queries and centroids share) and store them
// straight into shared memory, rows padded by 16 bytes, which puts the 8
// rows an ldmatrix reads in 8 distinct groups of 4 banks (these helpers
// live in int8_levels.cuh, which the pairwise kernel of bq_distance.cu
// shares).  Two buffers: the next
// chunk is decoded while the tensor cores take this one, one barrier a
// chunk.  No decoded matrix goes to device memory.  Each warp owns a
// 16-row strip of the tile and accumulates it with
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, A (queries)
// and B (centroids, whose rows are the col-major operand as they lie) read
// with ldmatrix.  Rows past Q or L decode as zero levels and are not
// written; dimensions past D decode as zero (their mask bits are 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_levels.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    list_scan_kernel(const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ cent,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int n_q, int n_l, int w) {
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WN = BN / WARPS_N;  // columns a warp
  constexpr int NT = WN / 8;        // n-tiles a warp
  constexpr int ROWS = BM + BN;
  static_assert(WARPS_M * WARPS_N * 32 == kThreads && WN % 8 == 0, "tile");
  __shared__ __align__(16) int8_t sm[2][ROWS][kRowBytes];

  const long long q0 = (long long)blockIdx.x * BM;
  const long long l0 = (long long)blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int ww = 2 * w;
  const int n_chunks = (w + kWords - 1) / kWords;

  // decode chunk c of every row of the tile into buffer buf
  auto stage = [&](int c, int buf) {
    for (int e = tid; e < ROWS * kWords; e += kThreads) {
      const int row = e / kWords, t = e % kWords;
      const int word = c * kWords + t;
      const bool is_q = row < BM;
      const long long g = is_q ? q0 + row : l0 + (row - BM);
      uint32_t p = 0u, s = 0u, m = 0u;
      if (word < w && g < (is_q ? n_q : n_l)) {
        const uint32_t* src = (is_q ? q : cent) + g * ww;
        p = src[word];
        s = src[w + word];
        m = mask[word];
      }
      store_levels(&sm[buf][row][t * 32], p, s, m);
    }
  };

  int acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;

  stage(0, 0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage(c + 1, (c + 1) & 1);
    const int buf = c & 1;
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a,
                  &sm[buf][wm * 16 + lane % 16][ks * 32 + (lane / 16) * 16]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, &sm[buf][BM + wn * WN + np * 16 + lane % 8 +
                                (lane / 16) * 8]
                          [ks * 32 + ((lane / 8) % 2) * 16]);
        mma_s8(acc[2 * np], a, b[0], b[1]);
        mma_s8(acc[2 * np + 1], a, b[2], b[3]);
      }
      if (NT % 2) {
        uint32_t b[2];
        ldmatrix_x2(b, &sm[buf][BM + wn * WN + (NT - 1) * 8 + lane % 8]
                          [ks * 32 + ((lane / 8) % 2) * 16]);
        mma_s8(acc[NT - 1], a, b[0], b[1]);
      }
    }
    __syncthreads();  // this buffer is free for chunk c + 2
  }

#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = q0 + wm * 16 + lane / 4 + half * 8;
      const long long col = l0 + wn * WN + t * 8 + (lane % 4) * 2;
      if (row >= n_q) continue;
      if (col < n_l) out[row * n_l + col] = acc[t][2 * half];
      if (col + 1 < n_l) out[row * n_l + col + 1] = acc[t][2 * half + 1];
    }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int BM, int BN>
void launch(const void* q, const void* cent, const void* mask, void* out,
            int n_q, int n_l, int w, cudaStream_t stream) {
  const dim3 grid((n_q + BM - 1) / BM, (n_l + BN - 1) / BN);
  list_scan_kernel<BM, BN><<<grid, kThreads, 0, stream>>>(
      (const uint32_t*)q, (const uint32_t*)cent, (const uint32_t*)mask,
      (int32_t*)out, n_q, n_l, w);
}

}  // namespace

// q: (n_q, 2w) words; cent: (n_l, 2w) words; mask: (w) words;
// out: (n_q, n_l) int32.  Any n_q, any n_l up to 65 535 * 32, any w.
// Returns cudaGetLastError() after the launch.
extern "C" int quiver_list_scan(const void* q, const void* cent,
                                const void* mask, void* out, int n_q, int n_l,
                                int w, void* stream) {
  if (n_q > 0 && n_l > 0) {
    const long long big = (long long)((n_q + 63) / 64) * ((n_l + 63) / 64);
    if (big >= 2LL * sm_count())
      launch<64, 64>(q, cent, mask, out, n_q, n_l, w, (cudaStream_t)stream);
    else
      launch<16, 32>(q, cent, mask, out, n_q, n_l, w, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
