// flash_attention_bwd: dQ, dK and dV of masked softmax attention over a
// (B, Tk, K, hd) key/value layout, recomputing the probabilities from each
// row's log-sum-exp.
//
// Replaces no TPU kernel: the Pallas kernel
// src/repro/kernels/flash_attention.py::_flash_kernel is forward only, and
// the reference's trainer differentiates the jnp attention of
// src/repro/models/attention.py::flash_attention through XLA.  The port sends
// every attention call through its hand-written forward
// (csrc/flash_attention.cu), whose output autograd cannot see through, so
// training needs this kernel: kernels/flash_attention.py::FlashAttentionFn
// launches it from its backward.  It computes the gradient of the model
// layer's function
//
//   S = q k^T * scale, masked (-1e30) where j >= kv_valid_len or
//       (causal and j > q_offset + i) or
//       (window and j <= q_offset + i - window);  P = softmax_j(S);  O = P v
//
// for q (B, Tq, H, hd), k and v (B, Tk, K, hd), the KV head of query head h
// being h / (H/K), as
//
//   P_ij = exp(S_ij - lse_i),  D_i = sum_d dO_id O_id,  dP = dO v^T,
//   dS = P o (dP - D),  dQ = dS k * scale,  dK = dS^T q * scale,
//   dV = P^T dO,
//
// dK and dV summed over the H/K query heads of each KV head, in float32,
// and written once in the input dtype.  D uses the O that the forward wrote
// (in its dtype), as FlashAttention-2 does.
//
// Bound on an H100.  The necessary work is five products, 2 * hd flops
// each for every visible (row, key) pair, 10 * hd in all; the bytes are q,
// k, v, O, dO (and the forward's log-sum-exp) read once and dQ, dK, dV
// written once.  At the training shape (minicpm-2b: B 4, T 256, 36 heads of
// 64, causal, bf16) a call moves 37.9 MB against 3.0 GFLOP: 11.3 us at
// 3.35 TB/s against 3.1 us at the 989 TFLOP/s bf16 tensor-core rate, so
// bound by the bytes.
//
// Two routes, chosen by the wrapper (kernels/flash_attention.py) by dtype
// alone; each is two kernels launched one after the other on the caller's
// stream, a dQ kernel and a dK/dV kernel.  Neither uses atomics: dQ sums
// over keys and dK/dV over the group's heads and query rows inside one
// block, so two calls on the same inputs give the same bits.
//
// * bf16 (tc::bwd_dq_mma_kernel, tc::bwd_dkdv_mma_kernel): the products on
//   the tensor cores, mma.sync.m16n8k16 bf16 with float32 accumulation, as
//   the forward's flash_mma_kernel (shared device code in mma_bf16.cuh).
//   Each block is 4 warps; tiles sit in shared memory as bf16 rows padded
//   by 16 bytes (ldmatrix without bank conflicts), filled by 16-byte
//   cp.async copies through a 2-stage ring.  No log-sum-exp pass: the
//   forward kernel writes each row's lse (float32, log2 units of the scaled
//   score) and the backward reads it, P = exp2(S * scale log2 e - lse).
//   - dQ: one block per (64-row query tile, head, batch), the tiles with
//     the most keys issued first; each warp owns 16 rows.  Q and dO stay in
//     shared memory; D is summed from O and dO in device memory while they
//     land, and written to float32 scratch for the dK/dV kernel.  K and V
//     tiles of 64 keys stream through the ring; per tile S = Q K^T and dP =
//     dO V^T (K's and V's rows are the col-major B operand as they lie), P
//     and dS = P o (dP - D) in float32 registers, dS rounded to bf16 in
//     registers (the C fragments of S are the A fragments of dS, as P in
//     the forward) and dQ += dS K with K read through ldmatrix.trans.
//   - dK/dV: one block per (64-key tile, KV head, batch), the first key
//     tiles (seen by the most query tiles) issued first; each warp owns 16
//     keys.  K and V stay in shared memory; for each head of the group and
//     each 64-row query tile that sees the tile, Q, dO and the rows' lse
//     and D stream through the ring.  In steps of 32 query rows (to bound
//     the registers at hd 128) S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T in float32, then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T rounded to bf16 in registers and dO, Q read through
//     ldmatrix.trans.
//   Both recompute S and dP: seven products instead of five (14 hd flops a
//   visible pair, 4.2 GFLOP at the training shape, ~4 us at the bf16
//   rate), which costs less than moving P or dS through device memory.
//   P and dS are rounded to bf16 before their products, as FlashAttention-2
//   and SDPA do; kernels/flash_attention.py::
//   flash_attention_backward_mma_plain mirrors this arithmetic in float32.
//   Only the tiles that a mask edge crosses are masked; rows past Tq and
//   keys past kv_valid_len give exact zeros, and a key that no row sees
//   writes zero gradients.  Shared memory 6 * 64 (hd + 8) * 2 + 1024
//   bytes: 55 KB at hd = 64 (four blocks a multiprocessor), 103 KB at
//   hd = 128.
//
// * float32 (bwd::bwd_dq_kernel, bwd::bwd_dkdv_kernel): float32 FMAs on the
//   CUDA cores, for the reason the forward keeps simt::flash_kernel: TF32
//   tensor cores keep about three digits, outside the 1e-4 float32
//   tolerance.  The dQ kernel computes each row's log-sum-exp in a first
//   pass over the K tiles, then recomputes P, forms dS = P o (dP - D),
//   stages it in shared memory and accumulates dQ; it writes lse and D to
//   float32 scratch.  The dK/dV kernel recomputes P^T and dS^T for its keys
//   from them, stages both in shared memory and accumulates dV += P^T dO
//   and dK += dS^T Q.  Thread (ty, tx) = (tid / 16, tid % 16) owns tile
//   rows 8 ty .. 8 ty + 7 and columns tx + 16 c; a row's max and sums
//   reduce over the 16 lanes of a half-warp.  Shared memory: (4 * 64 (hd +
//   1) + 64 * 65) * 4 bytes (dQ) and (4 * 64 (hd + 1) + 2 * 64 * 65 + 128)
//   * 4 bytes (dK/dV).
//
// Under a sliding window (window > 0) each kernel walks only the tiles that
// a row of its block can see: dQ starts at the window of its first row, and
// dK/dV stops at the last query tile whose window reaches its keys.
//
// At hd 192 each dK/dV block (both routes) and each tensor-core dQ block
// accumulates half of the head's columns (PARTS = 2, a grid twice as long,
// S and dP computed by both halves): the full width would hold 192 float32
// accumulators a thread in dK/dV, over the 255-register limit.
//
// Both routes read tiles in 16-byte vectors through the caller's batch,
// position and head strides, so the wrapper checks that every row starts on
// a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace bwd {

constexpr int kTile = 64;      // query rows (A) or keys (B) a block
constexpr int kThreads = 128;  // 8 row groups x 16 threads
constexpr int kPer = kTile / (kThreads / 16);  // tile rows a thread
constexpr int kCols = kTile / 16;              // tile columns a thread
constexpr int SS = kTile + 1;                  // row stride of a P/dS tile
constexpr float kMasked = -1e30f;

}  // namespace bwd

// the column halves a gradient block accumulates at a head width: 2 at hd
// 192 (both routes' dK/dV, the tensor-core dQ), else 1
template <int HD>
__host__ __device__ constexpr int col_parts() {
  return HD > 128 ? 2 : 1;
}

namespace bwd {

// rows [row0, row0 + n) of a (rows, HD) operand at row stride `stride`
// elements -> dst (kTile x (HD + 1)); rows past n are zero
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long stride, int row0,
                                          int n) {
  constexpr int VPR = HD / 4;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < kTile * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * 4;
    float4 vals = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n)
      vals = *reinterpret_cast<const float4*>(
          base + (long long)(row0 + r) * stride + c);
    float* out = dst + r * (HD + 1) + c;
    out[0] = vals.x;
    out[1] = vals.y;
    out[2] = vals.z;
    out[3] = vals.w;
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (4 * (size_t)kTile * (HD + 1) + (size_t)kTile * SS) * sizeof(float);
}
template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return (4 * (size_t)kTile * (HD + 1) + 2 * (size_t)kTile * SS +
          2 * (size_t)kTile) *
         sizeof(float);
}

// o, dout: (b, tq, h, HD) contiguous; dq likewise; lse, dd: (b, h, tq)
template <int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ dd_out,
                  int tq, int tk, int h, int group, long long q_sb,
                  long long q_st, long long q_sh, long long k_sb,
                  long long k_st, long long k_sh, long long v_sb,
                  long long v_st, long long v_sh, int causal, int q_offset,
                  int kv_valid_len, int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int DC = HD / 16;
  extern __shared__ float sm[];
  float* sq = sm;              // kTile x QS
  float* sdo = sq + kTile * QS;
  float* sk = sdo + kTile * QS;
  float* sv = sk + kTile * QS;
  float* ss = sv + kTile * QS;  // kTile x SS: dS

  const int q0 = blockIdx.x * kTile;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_q = min(kTile, tq - q0);
  const long long o_st = (long long)h * HD;
  const long long o_base = ((long long)bb * tq * h + hh) * HD;
  const float* kb = k + bb * k_sb + (hh / group) * k_sh;
  const float* vb = v + bb * v_sb + (hh / group) * v_sh;

  load_tile<HD>(sq, q + bb * q_sb + hh * q_sh, q_st, q0, n_q);
  load_tile<HD>(sdo, dout + o_base, o_st, q0, n_q);
  load_tile<HD>(sk, o + o_base, o_st, q0, n_q);  // O, for D only
  __syncthreads();

  float dd[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int row = ty * kPer + a;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      part = fmaf(sdo[row * QS + tx + 16 * c], sk[row * QS + tx + 16 * c],
                  part);
    dd[a] = half_warp_sum(part);
  }

  // the last key any row of this block can see
  int kv_end = min(kv_valid_len, tk);
  if (causal) kv_end = min(kv_end, q_offset + q0 + n_q);
  // and the first (the window's start for the block's first row)
  const int kv_begin = window ? max(0, q_offset + q0 - window + 1) : 0;

  // pass 1: each row's log-sum-exp
  float m[kPer], l[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    m[a] = kMasked;
    l[a] = 0.f;
  }
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    __syncthreads();  // the previous tile's reads (or D's) are done
    load_tile<HD>(sk, kb, k_st, j0, min(kTile, kv_end - j0));
    __syncthreads();
    float s[kPer][kCols];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kk[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kk[c] = sk[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float qq = sq[(ty * kPer + a) * QS + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[a][c] = fmaf(qq, kk[c], s[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int q_pos = q_offset + q0 + ty * kPer + a;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = j0 + tx + 16 * c;
        const bool vis = key < kv_end && (!causal || key <= q_pos) &&
                         (!window || key > q_pos - window);
        s[a][c] = vis ? s[a][c] * scale : kMasked;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) rs += expf(s[a][c] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + half_warp_sum(rs);
      m[a] = m_new;
    }
  }
  float lse[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) lse[a] = m[a] + logf(fmaxf(l[a], 1e-30f));

  // pass 2: dS and dQ
  float acc[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    __syncthreads();
    const int n_k = min(kTile, kv_end - j0);
    load_tile<HD>(sk, kb, k_st, j0, n_k);
    load_tile<HD>(sv, vb, v_st, j0, n_k);
    __syncthreads();
    float s[kPer][kCols], dp[kPer][kCols];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float kk[kCols], vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kk[c] = sk[(tx + 16 * c) * QS + d];
        vv[c] = sv[(tx + 16 * c) * QS + d];
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float qq = sq[(ty * kPer + a) * QS + d];
        const float gg = sdo[(ty * kPer + a) * QS + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[a][c] = fmaf(qq, kk[c], s[a][c]);
          dp[a][c] = fmaf(gg, vv[c], dp[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int row = ty * kPer + a;
      const int q_pos = q_offset + q0 + row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = j0 + tx + 16 * c;
        const bool vis = key < kv_end && (!causal || key <= q_pos) &&
                         (!window || key > q_pos - window);
        const float p = vis ? expf(s[a][c] * scale - lse[a]) : 0.f;
        ss[row * SS + tx + 16 * c] = p * (dp[a][c] - dd[a]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = sk[j * QS + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float g = ss[(ty * kPer + a) * SS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(g, kk[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int row = ty * kPer + a;
    if (row >= n_q) continue;
    float* out = dq + o_base + (long long)(q0 + row) * o_st;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[tx + 16 * c] = acc[a][c] * scale;
    if (tx == 0) {
      const long long at = ((long long)bb * h + hh) * tq + q0 + row;
      lse_out[at] = lse[a];
      dd_out[at] = dd[a];
    }
  }
}

// dout: (b, tq, h, HD) contiguous; lse, dd: (b, h, tq); dk, dv: (b, tk, kh,
// HD) contiguous
template <int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    float* __restrict__ dk, float* __restrict__ dv, int tq,
                    int tk, int h, int kh, int group, long long q_sb,
                    long long q_st,
                    long long q_sh, long long k_sb, long long k_st,
                    long long k_sh, long long v_sb, long long v_st,
                    long long v_sh, int causal, int q_offset,
                    int kv_valid_len, int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int PARTS = col_parts<HD>();
  constexpr int DC = HD / 16 / PARTS;  // columns a thread, of its part
  extern __shared__ float sm[];
  float* sk = sm;              // kTile x QS
  float* sv = sk + kTile * QS;
  float* sq = sv + kTile * QS;
  float* sdo = sq + kTile * QS;
  float* sp = sdo + kTile * QS;  // kTile x SS: P^T (keys x query rows)
  float* sds = sp + kTile * SS;  // kTile x SS: dS^T
  float* slse = sds + kTile * SS;
  float* sdd = slse + kTile;

  const int j0 = blockIdx.x / PARTS * kTile;
  // this block's columns: col0 + tx + 16 c
  const int col0 = blockIdx.x % PARTS * (HD / PARTS);
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kv_end = min(kv_valid_len, tk);
  const long long o_st = (long long)h * HD;
  // the query rows whose window reaches a key of the tile: i < i_end
  const int i_end =
      window ? min(tq, max(0, j0 + kTile - 1 + window - q_offset)) : tq;

  float acc_dk[kPer][DC], acc_dv[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[a][c] = acc_dv[a][c] = 0.f;

  if (j0 < kv_end) {
    const int n_k = min(kTile, kv_end - j0);
    load_tile<HD>(sk, k + bb * k_sb + kvh * k_sh, k_st, j0, n_k);
    load_tile<HD>(sv, v + bb * v_sb + kvh * v_sh, v_st, j0, n_k);
    // the first query tile with a row that sees key j0
    const int i_first = causal ? max(0, j0 - q_offset) / kTile * kTile : 0;
    for (int g = 0; g < group; ++g) {
      const int hh = kvh * group + g;
      const long long o_base = ((long long)bb * tq * h + hh) * HD;
      const float* lse_h = lse + ((long long)bb * h + hh) * tq;
      const float* dd_h = dd + ((long long)bb * h + hh) * tq;
      for (int i0 = i_first; i0 < i_end; i0 += kTile) {
        const int n_q = min(kTile, tq - i0);
        __syncthreads();  // the previous tile's reads are done
        load_tile<HD>(sq, q + bb * q_sb + hh * q_sh, q_st, i0, n_q);
        load_tile<HD>(sdo, dout + o_base, o_st, i0, n_q);
        if (tid < kTile) {
          slse[tid] = tid < n_q ? lse_h[i0 + tid] : 0.f;
          sdd[tid] = tid < n_q ? dd_h[i0 + tid] : 0.f;
        }
        __syncthreads();
        // thread (ty, tx): keys ty * kPer + a, query rows tx + 16 c
        float st[kPer][kCols], dpt[kPer][kCols];
#pragma unroll
        for (int a = 0; a < kPer; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c) st[a][c] = dpt[a][c] = 0.f;
#pragma unroll 2
        for (int d = 0; d < HD; ++d) {
          float qq[kCols], gg[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            qq[c] = sq[(tx + 16 * c) * QS + d];
            gg[c] = sdo[(tx + 16 * c) * QS + d];
          }
#pragma unroll
          for (int a = 0; a < kPer; ++a) {
            const float kk = sk[(ty * kPer + a) * QS + d];
            const float vv = sv[(ty * kPer + a) * QS + d];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              st[a][c] = fmaf(kk, qq[c], st[a][c]);
              dpt[a][c] = fmaf(vv, gg[c], dpt[a][c]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
          const int key = ty * kPer + a;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int qr = tx + 16 * c;
            const bool vis = j0 + key < kv_end && qr < n_q &&
                             (!causal || j0 + key <= q_offset + i0 + qr) &&
                             (!window || j0 + key > q_offset + i0 + qr - window);
            const float p = vis ? expf(st[a][c] * scale - slse[qr]) : 0.f;
            sp[key * SS + qr] = p;
            sds[key * SS + qr] = p * (dpt[a][c] - sdd[qr]);
          }
        }
        __syncthreads();
#pragma unroll 2
        for (int i = 0; i < kTile; ++i) {
          float gg[DC], qq[DC];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            gg[c] = sdo[i * QS + col0 + tx + 16 * c];
            qq[c] = sq[i * QS + col0 + tx + 16 * c];
          }
#pragma unroll
          for (int a = 0; a < kPer; ++a) {
            const float p = sp[(ty * kPer + a) * SS + i];
            const float ds = sds[(ty * kPer + a) * SS + i];
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              acc_dv[a][c] = fmaf(p, gg[c], acc_dv[a][c]);
              acc_dk[a][c] = fmaf(ds, qq[c], acc_dk[a][c]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int key = j0 + ty * kPer + a;
    if (key >= tk) continue;
    const long long at = (((long long)bb * tk + key) * kh + kvh) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[at + col0 + tx + 16 * c] = acc_dk[a][c] * scale;
      dv[at + col0 + tx + 16 * c] = acc_dv[a][c];
    }
  }
}

}  // namespace bwd

namespace tc {

constexpr int kBwdTile = 64;     // query rows (dQ) or keys (dK/dV) a block
constexpr int kBwdThreads = 128; // 4 warps, 16 rows or keys each
constexpr int kQChunk = 32;      // query rows of one S^T / dP^T step

// dQ: Q, dO, 2 stages of K and of V, D; dK/dV: K, V, 2 stages of Q and of
// dO, 2 stages of lse and of D
template <int HD>
constexpr size_t bwd_mma_smem_bytes() {
  return (size_t)6 * kBwdTile * (HD + kPad) * sizeof(bf16) +
         4 * kBwdTile * sizeof(float);
}

// o, dout, dq: (b, tq, h, HD) contiguous; lse, dd: (b, h, tq)
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, bf16* __restrict__ dq,
                      float* __restrict__ dd_out, int tq, int tk, int h,
                      int group, long long q_sb, long long q_st,
                      long long q_sh, long long k_sb, long long k_st,
                      long long k_sh, long long v_sb, long long v_st,
                      long long v_sh, int causal, int q_offset,
                      int kv_valid_len, int window, float scale_log2,
                      float scale) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int PARTS = col_parts<HD>();
  constexpr int RS = HD + kPad;     // row stride (elements) of every tile
  constexpr int CH = HD / 8;        // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;   // k-steps of S and dP
  constexpr int NT = kBwdTile / 8;  // key n-tiles of S and dP a warp
  constexpr int DT = HD / 8 / PARTS;  // n-tiles of dQ a warp, of its part
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kBwdTile x RS, then dQ
  bf16* sdo = sq + kBwdTile * RS;            // kBwdTile x RS
  bf16* sk = sdo + kBwdTile * RS;            // 2 stages x kBwdTile x RS
  bf16* sv = sk + 2 * kBwdTile * RS;         // 2 stages x kBwdTile x RS
  float* sdd = reinterpret_cast<float*>(sv + 2 * kBwdTile * RS);

  // grid (heads, batch, query tiles), the tiles with the most keys first
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) / PARTS * kBwdTile;
  const int part = blockIdx.z % PARTS;
  const int col0 = part * (HD / PARTS);  // this block's first dQ column
  const bf16* qb = q + bb * q_sb + hh * q_sh;
  const bf16* kb = k + bb * k_sb + (hh / group) * k_sh;
  const bf16* vb = v + bb * v_sb + (hh / group) * v_sh;
  const long long o_st = (long long)h * HD;
  const long long o_base = ((long long)bb * tq * h + hh) * HD;
  const long long row_base = ((long long)bb * h + hh) * tq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  // the last key any row of this block can see
  const int kv_valid = min(kv_valid_len, tk);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kBwdTile, tq));
  const int n_tiles = (kv_end + kBwdTile - 1) / kBwdTile;
  // the first tile that a row of the block sees (the window's start)
  const int t_first =
      window ? max(0, q_offset + q0 - window + 1) / kBwdTile : 0;

  for (int c = tid; c < kBwdTile * CH; c += kBwdThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool in = q0 + r < tq;
    const long long row = q0 + r;
    cp_async16(sq + r * RS + d, in ? qb + row * q_st + d : qb, in);
    cp_async16(sdo + r * RS + d, in ? dout + o_base + row * o_st + d : dout,
               in);
  }
  auto load_kv = [&](int tile) {
    const int j0 = tile * kBwdTile;
    bf16* dk_ = sk + (tile & 1) * kBwdTile * RS;
    bf16* dv_ = sv + (tile & 1) * kBwdTile * RS;
    for (int c = tid; c < kBwdTile * CH; c += kBwdThreads) {
      const int r = c / CH, d = (c % CH) * 8;
      const bool in = j0 + r < kv_end;  // rows past it load as zeros
      const long long row = j0 + r;
      cp_async16(dk_ + r * RS + d, in ? kb + row * k_st + d : kb, in);
      cp_async16(dv_ + r * RS + d, in ? vb + row * v_st + d : vb, in);
    }
  };
  load_kv(t_first);
  cp_async_commit();

  // D = rowsum(dO o O), read from device memory while the copies land; TPR
  // neighbouring lanes share a row (CH rounded up to a power of two, so the
  // lanes of a row reduce by shuffles: 32 at hd 192, of which 24 hold data)
  constexpr int TPR = CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8
                      : CH <= 16 ? 16 : 32;
  static_assert(CH <= 32 && kBwdTile * TPR % kBwdThreads == 0,
                "head width above 256");
  for (int c = tid; c < kBwdTile * TPR; c += kBwdThreads) {
    const int r = c / TPR, d = (c % TPR) * 8;
    float sum = 0.f;
    if (q0 + r < tq && d < HD) {
      const long long at = o_base + (long long)(q0 + r) * o_st + d;
      const uint4 ro = *reinterpret_cast<const uint4*>(o + at);
      const uint4 rd = *reinterpret_cast<const uint4*>(dout + at);
      const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&ro);
      const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fo = __bfloat1622float2(po[i]);
        const float2 fd = __bfloat1622float2(pd[i]);
        sum = fmaf(fd.x, fo.x, sum);
        sum = fmaf(fd.y, fo.y, sum);
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (c % TPR == 0) {
      sdd[r] = sum;
      if (q0 + r < tq && part == 0) dd_out[row_base + q0 + r] = sum;
    }
  }
  __syncthreads();

  // this thread's rows r0 and r0 + 8: log-sum-exp (log2 units) and D
  const int r0 = q0 + wrow + lane / 4;
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = r0 + 8 * i < tq ? lse[row_base + r0 + 8 * i] : 0.f;
    dd[i] = sdd[wrow + lane / 4 + 8 * i];
  }
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int tile = t_first; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();
    const bf16* tk_ = sk + (tile & 1) * kBwdTile * RS;
    const bf16* tv_ = sv + (tile & 1) * kBwdTile * RS;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t aq[4], ad[4];
      ldmatrix_x4(aq, a_addr(sq, RS, wrow, ks * 16, lane));
      ldmatrix_x4(ad, a_addr(sdo, RS, wrow, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr(tk_, RS, np * 16, ks * 16, lane));
        mma_bf16(s[2 * np], aq, b[0], b[1]);
        mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        ldmatrix_x4(b, b_addr(tv_, RS, np * 16, ks * 16, lane));
        mma_bf16(dp[2 * np], ad, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ad, b[2], b[3]);
      }
    }

    // P from the row's log-sum-exp, masked to 0; dS = P o (dP - D)
    const int j0 = tile * kBwdTile;
    // a tile that no mask edge crosses for any row of this warp
    const bool full = j0 + kBwdTile <= kv_valid &&
                      (!causal || j0 + kBwdTile - 1 <= q_offset + q0 + wrow) &&
                      (!window || j0 > q_offset + q0 + wrow + 15 - window);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[t][e] * scale_log2 - lse2[e >> 1]);
        if (!full) {
          const int key = j0 + t * 8 + (lane % 4) * 2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          const bool vis = key < kv_valid &&
                           (!causal || key <= q_offset + row) &&
                           (!window || key > q_offset + row - window);
          p = vis ? p : 0.f;
        }
        s[t][e] = p * (dp[t][e] - dd[e >> 1]);
      }

    // dQ += dS K: dS rounded to bf16 in registers (its C fragments are the
    // A fragments), K read through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DT / 2; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bt_addr(tk_, RS, kk * 16, col0 + dn * 16, lane));
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for tile + 2
  }

  // each warp stages its own 16 rows of dQ in the Q tile (only it reads
  // those rows) and writes them as 16-byte stores
  bf16* so = sq + wrow * RS;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int d = col0 + t * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(so + (lane / 4) * RS + d) =
        pack_bf16(acc[t][0] * scale, acc[t][1] * scale);
    *reinterpret_cast<uint32_t*>(so + (lane / 4 + 8) * RS + d) =
        pack_bf16(acc[t][2] * scale, acc[t][3] * scale);
  }
  __syncwarp();
  constexpr int CHP = CH / PARTS;  // 16-byte chunks of a row's part
  for (int c = lane; c < 16 * CHP; c += 32) {
    const int r = c / CHP, d = col0 + (c % CHP) * 8;
    const int row = q0 + wrow + r;
    if (row < tq)
      *reinterpret_cast<uint4*>(dq + o_base + (long long)row * o_st + d) =
          *reinterpret_cast<const uint4*>(so + r * RS + d);
  }
}

// dout: (b, tq, h, HD) contiguous; lse, dd: (b, h, tq); dk, dv: (b, tk, kh,
// HD) contiguous
template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int tq, int tk, int h, int kh,
                        int group, long long q_sb, long long q_st,
                        long long q_sh, long long k_sb, long long k_st,
                        long long k_sh, long long v_sb, long long v_st,
                        long long v_sh, int causal, int q_offset,
                        int kv_valid_len, int window, float scale_log2,
                        float scale) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int PARTS = col_parts<HD>();
  constexpr int RS = HD + kPad;
  constexpr int CH = HD / 8;
  constexpr int KSTEPS = HD / 16;   // k-steps of S^T and dP^T
  constexpr int NQ = kQChunk / 8;   // query n-tiles of one S^T step
  constexpr int DT = HD / 8 / PARTS;  // n-tiles of dK and dV a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // kBwdTile x RS, then dK
  bf16* sv = sk + kBwdTile * RS;             // kBwdTile x RS, then dV
  bf16* sq = sv + kBwdTile * RS;             // 2 stages x kBwdTile x RS
  bf16* sdo = sq + 2 * kBwdTile * RS;        // 2 stages x kBwdTile x RS
  float* slse = reinterpret_cast<float*>(sdo + 2 * kBwdTile * RS);
  float* sdd = slse + 2 * kBwdTile;          // 2 stages x kBwdTile each

  // grid (KV heads, batch, key tiles): under a causal mask the first key
  // tiles are seen by the most query tiles, and start first
  const int kvh = blockIdx.x;
  const int bb = blockIdx.y;
  const int j0 = blockIdx.z / PARTS * kBwdTile;
  const int col0 = blockIdx.z % PARTS * (HD / PARTS);  // first dK/dV column
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wkey = warp * 16;  // this warp's first key in the tile
  const int kv_end = min(kv_valid_len, tk);
  const long long o_st = (long long)h * HD;
  const bf16* kb = k + bb * k_sb + kvh * k_sh;
  const bf16* vb = v + bb * v_sb + kvh * v_sh;

  // the query tiles that can see the tile (causal: from the one holding
  // the first row at or after key j0), for each head of the group
  // (window: up to the last row whose window reaches the tile's last key)
  const int i_end =
      window ? min(tq, max(0, j0 + kBwdTile - 1 + window - q_offset)) : tq;
  const int n_q_tiles = (i_end + kBwdTile - 1) / kBwdTile;
  const int i_first = causal ? max(0, j0 - q_offset) / kBwdTile : 0;
  const int n_qt = j0 < kv_end ? max(0, n_q_tiles - i_first) : 0;
  const int n_items = group * n_qt;

  for (int c = tid; c < kBwdTile * CH; c += kBwdThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool in = j0 + r < kv_end;  // rows past it load as zeros
    const long long row = j0 + r;
    cp_async16(sk + r * RS + d, in ? kb + row * k_st + d : kb, in);
    cp_async16(sv + r * RS + d, in ? vb + row * v_st + d : vb, in);
  }
  // an item's Q and dO tiles and its rows' lse and D into stage it & 1
  auto load_item = [&](int it) {
    const int st = it & 1;
    const int hh = kvh * group + it / n_qt;
    const int i0 = (i_first + it % n_qt) * kBwdTile;
    const bf16* qb = q + bb * q_sb + hh * q_sh;
    const bf16* ob = dout + ((long long)bb * tq * h + hh) * HD;
    const long long rows = ((long long)bb * h + hh) * tq;
    bf16* dq_ = sq + st * kBwdTile * RS;
    bf16* ddo = sdo + st * kBwdTile * RS;
    for (int c = tid; c < kBwdTile * CH; c += kBwdThreads) {
      const int r = c / CH, d = (c % CH) * 8;
      const bool in = i0 + r < tq;
      const long long row = i0 + r;
      cp_async16(dq_ + r * RS + d, in ? qb + row * q_st + d : qb, in);
      cp_async16(ddo + r * RS + d, in ? ob + row * o_st + d : ob, in);
    }
    for (int r = tid; r < kBwdTile; r += kBwdThreads) {
      const bool in = i0 + r < tq;
      cp_async4(slse + st * kBwdTile + r, in ? lse + rows + i0 + r : lse,
                in);
      cp_async4(sdd + st * kBwdTile + r, in ? dd + rows + i0 + r : dd, in);
    }
  };
  if (n_items > 0) load_item(0);
  cp_async_commit();  // K, V and the first item

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[t][e] = adv[t][e] = 0.f;
  // this thread's keys (rows of S^T) k_lo and k_lo + 8
  const int k_lo = j0 + wkey + lane / 4;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) load_item(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this item (and K, V) have landed
    __syncthreads();
    const int st = it & 1;
    const int i0 = (i_first + it % n_qt) * kBwdTile;
    const bf16* tq_ = sq + st * kBwdTile * RS;
    const bf16* tdo = sdo + st * kBwdTile * RS;
    const float* tl = slse + st * kBwdTile;
    const float* td = sdd + st * kBwdTile;
    // no mask edge crosses this warp's 16 keys x the tile's rows
    const bool full =
        j0 + wkey + 16 <= kv_end && i0 + kBwdTile <= tq &&
        (!causal || j0 + wkey + 15 <= q_offset + i0) &&
        (!window || j0 + wkey > q_offset + i0 + kBwdTile - 1 - window);

    for (int c0 = 0; c0 < kBwdTile; c0 += kQChunk) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kQChunk rows a warp
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, a_addr(sk, RS, wkey, ks * 16, lane));
        ldmatrix_x4(av, a_addr(sv, RS, wkey, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, b_addr(tq_, RS, c0 + np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], ak, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ak, b[2], b[3]);
          ldmatrix_x4(b, b_addr(tdo, RS, c0 + np * 16, ks * 16, lane));
          mma_bf16(dp[2 * np], av, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], av, b[2], b[3]);
        }
      }
      // P^T from each column's (query row's) log-sum-exp, masked to 0;
      // dS^T = P^T o (dP^T - D)
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = c0 + t * 8 + (lane % 4) * 2 + (e & 1);
          float p = exp2f(s[t][e] * scale_log2 - tl[qr]);
          if (!full) {
            const int key = k_lo + (e >> 1) * 8;
            const int row = i0 + qr;
            const bool vis = key < kv_end && row < tq &&
                             (!causal || key <= q_offset + row) &&
                             (!window || key > q_offset + row - window);
            p = vis ? p : 0.f;
          }
          dp[t][e] = p * (dp[t][e] - td[qr]);
          s[t][e] = p;
        }
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
      // registers, dO and Q read through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t ap[4], as[4];
        c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
        c_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, bt_addr(tdo, RS, c0 + kk * 16, col0 + dn * 16, lane));
          mma_bf16(adv[2 * dn], ap, b[0], b[1]);
          mma_bf16(adv[2 * dn + 1], ap, b[2], b[3]);
          ldmatrix_x4_trans(
              b, bt_addr(tq_, RS, c0 + kk * 16, col0 + dn * 16, lane));
          mma_bf16(adk[2 * dn], as, b[0], b[1]);
          mma_bf16(adk[2 * dn + 1], as, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for item + 2
  }

  // each warp stages its own 16 keys of dK and dV in its rows of the K and
  // V tiles (after every copy has landed) and writes them as 16-byte
  // stores; a key no row sees writes zeros
  cp_async_wait<0>();
  __syncthreads();
  bf16* sok = sk + wkey * RS;
  bf16* sov = sv + wkey * RS;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int d = col0 + t * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(sok + (lane / 4) * RS + d) =
        pack_bf16(adk[t][0] * scale, adk[t][1] * scale);
    *reinterpret_cast<uint32_t*>(sok + (lane / 4 + 8) * RS + d) =
        pack_bf16(adk[t][2] * scale, adk[t][3] * scale);
    *reinterpret_cast<uint32_t*>(sov + (lane / 4) * RS + d) =
        pack_bf16(adv[t][0], adv[t][1]);
    *reinterpret_cast<uint32_t*>(sov + (lane / 4 + 8) * RS + d) =
        pack_bf16(adv[t][2], adv[t][3]);
  }
  __syncwarp();
  constexpr int CHP = CH / PARTS;  // 16-byte chunks of a row's part
  for (int c = lane; c < 16 * CHP; c += 32) {
    const int r = c / CHP, d = col0 + (c % CHP) * 8;
    const int key = j0 + wkey + r;
    if (key < tk) {
      const long long at = (((long long)bb * tk + key) * kh + kvh) * HD + d;
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(sok + r * RS + d);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(sov + r * RS + d);
    }
  }
}

}  // namespace tc


namespace {

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  void *dq, *dk, *dv, *lse, *dd;
  int b, tq, tk, h, kh;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int causal, q_offset, kv_valid_len, window;
  float scale;
  cudaStream_t stream;
};

template <int HD>
int launch_fma(const BwdArgs& a) {
  auto ka = bwd::bwd_dq_kernel<HD>;
  auto kb = bwd::bwd_dkdv_kernel<HD>;
  constexpr size_t smem_a = bwd::dq_smem_bytes<HD>();
  constexpr size_t smem_b = bwd::dkdv_smem_bytes<HD>();
  if (const int err = allow_smem(ka, smem_a)) return err;
  if (const int err = allow_smem(kb, smem_b)) return err;
  const int group = a.h / a.kh;
  const dim3 grid_a((a.tq + bwd::kTile - 1) / bwd::kTile, a.h, a.b);
  ka<<<grid_a, bwd::kThreads, smem_a, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.out, (const float*)a.dout, (float*)a.dq,
      (float*)a.lse, (float*)a.dd, a.tq, a.tk, a.h, group, a.q_sb, a.q_st,
      a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.causal,
      a.q_offset, a.kv_valid_len, a.window, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((a.tk + bwd::kTile - 1) / bwd::kTile * col_parts<HD>(),
                    a.kh, a.b);
  kb<<<grid_b, bwd::kThreads, smem_b, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.dd,
      (float*)a.dk, (float*)a.dv, a.tq, a.tk, a.h, a.kh, group, a.q_sb,
      a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh,
      a.causal, a.q_offset, a.kv_valid_len, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const BwdArgs& a) {
  using tc::bf16;
  auto ka = tc::bwd_dq_mma_kernel<HD>;
  auto kb = tc::bwd_dkdv_mma_kernel<HD>;
  constexpr size_t smem = tc::bwd_mma_smem_bytes<HD>();
  if (const int err = allow_smem(ka, smem)) return err;
  if (const int err = allow_smem(kb, smem)) return err;
  const int group = a.h / a.kh;
  const float scale_log2 = a.scale * tc::kLog2e;
  constexpr int parts = col_parts<HD>();
  const dim3 grid_a(a.h, a.b,
                    (a.tq + tc::kBwdTile - 1) / tc::kBwdTile * parts);
  ka<<<grid_a, tc::kBwdThreads, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.out, (const bf16*)a.dout, (const float*)a.lse,
      (bf16*)a.dq, (float*)a.dd, a.tq, a.tk, a.h, group, a.q_sb, a.q_st,
      a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.causal,
      a.q_offset, a.kv_valid_len, a.window, scale_log2, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b(a.kh, a.b,
                    (a.tk + tc::kBwdTile - 1) / tc::kBwdTile * parts);
  kb<<<grid_b, tc::kBwdThreads, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.dd,
      (bf16*)a.dk, (bf16*)a.dv, a.tq, a.tk, a.h, a.kh, group, a.q_sb,
      a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh,
      a.causal, a.q_offset, a.kv_valid_len, a.window, scale_log2, a.scale);
  return (int)cudaGetLastError();
}

template <typename F>
int by_width(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points: q (b, tq, h, hd) and k, v (b, tk, kh, hd) at the given
// element strides (batch, position, head; the head axis contiguous), all of
// one dtype; out, dout and dq (b, tq, h, hd) and dk, dv (b, tk, kh, hd)
// contiguous in that dtype; lse and dd (b, h, tq) float32.  Each launches
// its dQ kernel, then its dK/dV kernel, on `stream` and returns
// cudaGetLastError() after them, or the error of a shared-memory request.

// bfloat16: the tensor-core kernels.  lse is the forward's (flash_mma_kernel
// with an lse output, log2 units); dd is scratch.
extern "C" int quiver_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dd, int b, int tq, int tk, int h, int kh, int hd, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, int q_offset, int kv_valid_len, int window, float scale,
    void* stream) {
  if (b == 0 || tq == 0 || h == 0 || tk == 0) return (int)cudaGetLastError();
  const BwdArgs a{q,    k,    v,    out,  dout, dq,     dk,       dv,
                  const_cast<void*>(lse), dd, b, tq, tk, h, kh, q_sb,
                  q_st, q_sh, k_sb, k_st, k_sh, v_sb,   v_st,     v_sh,
                  causal, q_offset, kv_valid_len, window, scale,
                  (cudaStream_t)stream};
  return by_width(hd, [&](auto w) {
    return launch_mma<decltype(w)::value>(a);
  });
}

// float32: the CUDA-core kernels; lse and dd are scratch.
extern "C" int quiver_flash_attention_bwd_fma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int b, int tq, int tk, int h, int kh, int hd, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, int q_offset, int kv_valid_len, int window, float scale,
    void* stream) {
  if (b == 0 || tq == 0 || h == 0 || tk == 0) return (int)cudaGetLastError();
  const BwdArgs a{q,    k,    v,    out,  dout, dq,     dk,       dv,
                  lse,  dd,   b,    tq,   tk,   h,      kh,       q_sb,
                  q_st, q_sh, k_sb, k_st, k_sh, v_sb,   v_st,     v_sh,
                  causal, q_offset, kv_valid_len, window, scale,
                  (cudaStream_t)stream};
  return by_width(hd, [&](auto w) {
    return launch_fma<decltype(w)::value>(a);
  });
}
