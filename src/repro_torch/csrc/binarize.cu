// binarize: float32 rows -> packed 2-bit Sign-Magnitude signatures.
//
// Replaces the Pallas TPU kernel src/repro/kernels/binarize.py::_binarize_kernel
// (pallas_call in binarize_pallas).  Per row x of D floats:
//     tau    = sum(|x|) / D
//     pos    = x > 0        -> bit d%32 of word d/32        (words [0, W))
//     strong = |x| > tau    -> bit d%32 of word W + d/32    (words [W, 2W))
// Bits past D are zero in both planes.  Words are written as int32 bit views
// of the reference's uint32 words.
//
// Bound on an H100: bytes.  The kernel reads N*D*4 bytes and writes N*2W*4
// (1/16 as much); at 3.35 TB/s that is the whole cost, while the work per
// element (abs, add, two compares) is a handful of operations per 4 bytes.
//
// Design: one warp per row.  Lane l reads elements l, l+32, l+64, ... so each
// load instruction of the warp covers 128 contiguous bytes.  Each lane sums
// its elements in order, then a xor-butterfly of shuffles gives every lane the
// same row sum.  A second pass over the row (served from L1) turns each 32-dim
// word into two __ballot_sync results, which are exactly the little-endian
// packed pos and strong words.  The summation order is fixed, and
// kernels/binarize.py::threshold_plain repeats it, so the plain version
// reproduces tau, and hence every bit, exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void binarize_kernel(const float* __restrict__ x,
                                uint32_t* __restrict__ out,
                                int n, int dim, int w) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const float* xr = x + row * dim;

  float sum = 0.0f;
  for (int j = 0; j < w; ++j) {
    const int d = j * 32 + lane;
    sum += fabsf(d < dim ? xr[d] : 0.0f);
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, off);
  const float tau = sum / (float)dim;

  uint32_t* orow = out + row * 2 * w;
  for (int j = 0; j < w; ++j) {
    const int d = j * 32 + lane;
    const float v = d < dim ? xr[d] : 0.0f;
    const uint32_t pos = __ballot_sync(kFullMask, v > 0.0f);
    const uint32_t strong = __ballot_sync(kFullMask, fabsf(v) > tau);
    if (lane == 0) {
      orow[j] = pos;
      orow[w + j] = strong;
    }
  }
}

}  // namespace

// x: (n, dim) float32, contiguous; out: (n, 2*ceil(dim/32)) 32-bit words.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quiver_binarize(const void* x, void* out, int n, int dim,
                               void* stream) {
  const int w = (dim + 31) / 32;
  if (n > 0 && dim > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    binarize_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      (cudaStream_t)stream>>>(
        (const float*)x, (uint32_t*)out, n, dim, w);
  }
  return (int)cudaGetLastError();
}
