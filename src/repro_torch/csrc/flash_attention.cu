// flash_attention: masked softmax attention over a (B, Tk, K, hd) key/value
// layout, with the online max/denominator recurrence.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pallas_call in
// flash_attention_pallas), and computes the function of the model layer
// src/repro/models/attention.py::flash_attention, of which the Pallas kernel
// is the case q_offset = 0, kv_valid_len = kv_len:
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / (H/K)] * scale,
//                            masked (-1e30) where j >= kv_valid_len
//                            or (causal and j > q_offset + i)) . v[b, j, ...]
//
// q, k, v are read through their batch, position and head strides (the head
// axis contiguous), so the model's (B, T, heads, hd) activations and a KV
// cache slice go in as they are; the KV head of query head h is h / (H/K),
// so GQA needs no repeated copy (the reference's jnp.repeat and the Pallas
// wrapper's fold each make one).  Sums are float32; the output is written in
// q's dtype as (B, Tq, H, hd).  The scale multiplies the scores, as the model
// layer does (the Pallas kernel scales q first).
//
// Bound on an H100.  The work is 4 * hd flops for each visible (row, key)
// pair and the bytes are Q + the visible K/V rows + O.  At the model's
// shapes (hd = 64, 36 heads) prefill at T = 320 does 3.8 GFLOP against 4.8
// MB and would be bound by the tensor cores (3.8 us at 989 TFLOP/s bf16);
// decode (Tq = 1) reads the whole visible cache for 4 * hd flops a key and
// is bound by memory.  This first kernel uses neither tensor cores nor TMA:
// its products are float32 FMAs on the CUDA cores, so it sits far from the
// flops bound; tensor cores (mma / wgmma), TMA and a split-KV decode are for
// later work.
//
// Design.  One block of 128 threads per (64-row query tile, head, batch).
// The Q tile sits in shared memory as float32; K and V tiles of 64 keys are
// streamed through shared memory (K and Q at row stride hd + 1, so threads
// reading different rows of one column hit distinct banks).  Thread (ty, tx)
// = (tid / 16, tid % 16) owns query rows 8ty .. 8ty + 7, key columns
// tx + 16c of each score tile (c < 4) and output columns tx + 16c (c <
// hd/16).  Per tile: scores in registers, masked and scaled; each row's max
// and sum over its 16 threads by warp shuffles (the 16 lanes of a half warp);
// the running max, denominator and output rescale in registers; the
// probabilities go through shared memory for the P.V product.  The loop stops
// at the last key any row of the block can see: min(kv_valid_len,
// q_offset + last row + 1) when causal; later tiles are fully masked, and in
// the reference they change nothing (exp(-1e30 - m) = 0).  Rows past Tq
// (a ragged last tile) load as zeros and are not written.  Decode (Tq = 1)
// runs the same kernel with one valid row a block.  Shared memory is
// (64 (hd + 1) * 2 + 64 hd + 64 * 65) * 4 bytes: 65 KB at hd = 64, 113 KB at
// hd = 128; above 48 KB the launch raises the block's limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows a block
constexpr int kKeys = 64;      // keys a tile
constexpr int kThreads = 128;  // 8 row groups x 16 threads
constexpr int kRowsPerThread = kRows / (kThreads / 16);
constexpr int kKeysPerThread = kKeys / 16;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype
}

template <int HD>
constexpr size_t smem_bytes() {
  return ((size_t)kRows * (HD + 1) + (size_t)kKeys * (HD + 1) +
          (size_t)kKeys * HD + (size_t)kRows * (kKeys + 1)) *
         sizeof(float);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ out, int tq,
                 int tk, int h, int group, long long q_sb, long long q_st,
                 long long q_sh, long long k_sb, long long k_st,
                 long long k_sh, long long v_sb, long long v_st,
                 long long v_sh, int causal, int q_offset, int kv_valid_len,
                 float scale) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int QS = HD + 1;       // row stride of the Q and K tiles
  constexpr int SS = kKeys + 1;    // row stride of the probability tile
  constexpr int DC = HD / 16;      // output columns a thread
  extern __shared__ float sm[];
  float* sq = sm;                  // kRows x QS
  float* sk = sq + kRows * QS;     // kKeys x QS
  float* sv = sk + kKeys * QS;     // kKeys x HD
  float* ss = sv + kKeys * HD;     // kRows x SS

  const int q0 = blockIdx.x * kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const TQ* qb = q + bb * q_sb + hh * q_sh;
  const TKV* kb = k + bb * k_sb + (hh / group) * k_sh;
  const TKV* vb = v + bb * v_sb + (hh / group) * v_sh;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    sq[r * QS + d] =
        (q0 + r < tq) ? to_f32(qb[(long long)(q0 + r) * q_st + d]) : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][DC];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    m[a] = kMasked;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  // the last key any row of this block can see
  int kv_end = min(kv_valid_len, tk);
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kRows, tq));

  for (int j0 = 0; j0 < kv_end; j0 += kKeys) {
    __syncthreads();  // the previous tile's reads are done (and Q is in)
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = j0 + r < kv_end;
      sk[r * QS + d] = in ? to_f32(kb[(long long)(j0 + r) * k_st + d]) : 0.f;
      sv[r * HD + d] = in ? to_f32(vb[(long long)(j0 + r) * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kk[kKeysPerThread];
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) kk[c] = sk[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) {
        const float qq = sq[(ty * kRowsPerThread + a) * QS + d];
#pragma unroll
        for (int c = 0; c < kKeysPerThread; ++c) s[a][c] = fmaf(qq, kk[c], s[a][c]);
      }
    }

#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) {
      const int row = ty * kRowsPerThread + a;
      const int q_pos = q_offset + q0 + row;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        const int key = j0 + tx + 16 * c;
        const bool vis = key < kv_valid_len && key < tk &&
                         (!causal || key <= q_pos);
        s[a][c] = vis ? s[a][c] * scale : kMasked;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerThread; ++c) {
        const float p = expf(s[a][c] - m_new);
        ss[row * SS + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * corr + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sv[j * HD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) {
        const float p = ss[(ty * kRowsPerThread + a) * SS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int row = q0 + ty * kRowsPerThread + a;
    if (row >= tq) continue;
    const float den = fmaxf(l[a], 1e-30f);
    TQ* o = out + (((long long)bb * tq + row) * h + hh) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[a][c] / den);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int b, tq, tk, h, kh;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int causal, q_offset, kv_valid_len;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD>
int launch(const Args& a) {
  auto kernel = flash_kernel<TQ, TKV, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.tq + kRows - 1) / kRows, a.h, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, (TQ*)a.out, a.tq,
      a.tk, a.h, a.h / a.kh, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh,
      a.v_sb, a.v_st, a.v_sh, a.causal, a.q_offset, a.kv_valid_len,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_width(const Args& a, int hd) {
  switch (hd) {
    case 16: return launch<TQ, TKV, 16>(a);
    case 32: return launch<TQ, TKV, 32>(a);
    case 64: return launch<TQ, TKV, 64>(a);
    case 128: return launch<TQ, TKV, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (b, tq, h, hd) and k, v: (b, tk, kh, hd) at the given element strides
// (batch, position, head; the head axis contiguous); out: (b, tq, h, hd)
// contiguous.  q_dtype / kv_dtype: 0 float32, 1 bfloat16 (instantiated:
// f32/f32, bf16/bf16, f32 q with bf16 k/v).  Returns cudaGetLastError()
// after the launch, or the error of the shared-memory request.
extern "C" int quiver_flash_attention(
    const void* q, const void* k, const void* v, void* out, int q_dtype,
    int kv_dtype, int b, int tq, int tk, int h, int kh, int hd,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, int causal, int q_offset, int kv_valid_len, float scale,
    void* stream) {
  if (b == 0 || tq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{q,    k,    v,    out,  b,    tq,     tk,       h,
               kh,   q_sb, q_st, q_sh, k_sb, k_st,   k_sh,     v_sb,
               v_st, v_sh, causal, q_offset, kv_valid_len, scale,
               (cudaStream_t)stream};
  if (q_dtype == 0 && kv_dtype == 0) return by_width<float, float>(a, hd);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_width<__nv_bfloat16, __nv_bfloat16>(a, hd);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_width<float, __nv_bfloat16>(a, hd);
  return (int)cudaErrorInvalidValue;
}
