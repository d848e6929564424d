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
//       (causal and j > q_offset + i);  P = softmax_j(S);  O = P v
//
// for q (B, Tq, H, hd), k and v (B, Tk, K, hd), the KV head of query head h
// being h / (H/K), as
//
//   lse_i = log sum_j exp(S_ij),  P_ij = exp(S_ij - lse_i),
//   D_i = sum_d dO_id O_id,  dP = dO v^T,  dS = P o (dP - D),
//   dQ = dS k * scale,  dK = dS^T q * scale,  dV = P^T dO,
//
// dK and dV summed over the H/K query heads of each KV head.  D uses the O
// that the forward wrote (in its dtype), as FlashAttention-2 does, and
// kernels/flash_attention.py::flash_attention_backward_plain mirrors this
// arithmetic in float32.
//
// Bound on an H100.  The necessary work is the five products above, 2 * hd
// flops each for every visible (row, key) pair, 10 * hd in all (this kernel
// does 16 * hd: S three times, dP twice); the bytes are q, k, v, O, dO read
// once and dQ, dK, dV written once.  At the training shape (minicpm-2b: B 4,
// T 256, 36 heads of 64, causal, bf16) a call moves 37.7 MB against 3.0
// GFLOP: 11.3 us at 3.35 TB/s against 3.1 us at the bf16 tensor-core rate,
// so bound by the bytes; on float32 CUDA-core FMAs (67 TFLOP/s) the same
// 4.9 GFLOP this kernel does take 73 us.
//
// Design: a simple kernel that is right, on the CUDA cores in float32 FMAs
// (the tensor-core redesign is ROADMAP queue 2b's next item).  Two
// kernels, launched one after the other on the caller's stream; neither
// uses atomics, so two calls on the same inputs give the same bits:
//
// * bwd_dq_kernel, one block of 128 threads per (64-row query tile, head,
//   batch).  The Q and dO tiles stay in shared memory as float32.  It first
//   computes D from the O tile, then walks the visible K tiles twice: once
//   for each row's running max and denominator (the log-sum-exp), once to
//   recompute P, form dS = P o (dP - D) with dP from the V tile, stage dS in
//   shared memory and accumulate dQ in registers.  It writes dQ, and the
//   rows' lse and D to float32 scratch (the wrapper's torch.empty).
// * bwd_dkdv_kernel, one block of 128 threads per (64-key tile, KV head,
//   batch).  The K and V tiles stay in shared memory; it walks the group's
//   H/K query heads and, for each, the query tiles that can see the tile
//   (causal: from the first row at or after the tile's first key), reloads
//   Q, dO, lse and D, recomputes P^T and dS^T for its keys, stages both in
//   shared memory, and accumulates dV += P^T dO and dK += dS^T Q in
//   registers.  A key that no row sees gets zero gradients.
//
// Thread layout in both (as the CUDA-core forward, simt::flash_kernel):
// thread (ty, tx) = (tid / 16, tid % 16) owns tile rows 8 ty .. 8 ty + 7,
// tile columns tx + 16 c and output columns tx + 16 c; a row's max and sums
// reduce over the 16 lanes of a half-warp.  Tiles are read in 16-byte
// vectors (4 float32, 8 bf16) through the caller's batch, position and head
// strides, so the wrapper checks that every row starts on a 16-byte
// boundary.  Shared memory: A (4 * 64 (hd + 1) + 64 * 65) * 4 bytes, 83 KB
// at hd = 64 and 145 KB at hd = 128; B (4 * 64 (hd + 1) + 2 * 64 * 65 + 128)
// * 4 bytes, 100 KB at hd = 64 and 162 KB at hd = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bwd {

constexpr int kTile = 64;      // query rows (A) or keys (B) a block
constexpr int kThreads = 128;  // 8 row groups x 16 threads
constexpr int kPer = kTile / (kThreads / 16);  // tile rows a thread
constexpr int kCols = kTile / 16;              // tile columns a thread
constexpr int SS = kTile + 1;                  // row stride of a P/dS tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ void to_floats(const uint4 raw, float* out,
                                          float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void to_floats(const uint4 raw, float* out,
                                          __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);          // low half first
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

// rows [row0, row0 + n) of a (rows, HD) operand at row stride `stride`
// elements -> dst (kTile x (HD + 1) float32); rows past n are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int row0,
                                          int n) {
  constexpr int N = 16 / sizeof(T);  // elements a 16-byte vector
  constexpr int VPR = HD / N;        // vectors a row
  for (int e = threadIdx.x; e < kTile * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * N;
    float vals[N];
    if (r < n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * stride + c);
      to_floats(raw, vals, T());
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[r * (HD + 1) + c + i] = vals[i];
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, T* __restrict__ dq,
                  float* __restrict__ lse_out, float* __restrict__ dd_out,
                  int tq, int tk, int h, int group, long long q_sb,
                  long long q_st, long long q_sh, long long k_sb,
                  long long k_st, long long k_sh, long long v_sb,
                  long long v_st, long long v_sh, int causal, int q_offset,
                  int kv_valid_len, float scale) {
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
  const T* kb = k + bb * k_sb + (hh / group) * k_sh;
  const T* vb = v + bb * v_sb + (hh / group) * v_sh;

  load_tile<T, HD>(sq, q + bb * q_sb + hh * q_sh, q_st, q0, n_q);
  load_tile<T, HD>(sdo, dout + o_base, o_st, q0, n_q);
  load_tile<T, HD>(sk, o + o_base, o_st, q0, n_q);  // O, for D only
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

  // pass 1: each row's log-sum-exp
  float m[kPer], l[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    m[a] = kMasked;
    l[a] = 0.f;
  }
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    __syncthreads();  // the previous tile's reads (or D's) are done
    load_tile<T, HD>(sk, kb, k_st, j0, min(kTile, kv_end - j0));
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
        const bool vis = key < kv_end && (!causal || key <= q_pos);
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
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    __syncthreads();
    const int n_k = min(kTile, kv_end - j0);
    load_tile<T, HD>(sk, kb, k_st, j0, n_k);
    load_tile<T, HD>(sv, vb, v_st, j0, n_k);
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
        const bool vis = key < kv_end && (!causal || key <= q_pos);
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
    T* out = dq + o_base + (long long)(q0 + row) * o_st;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(out + tx + 16 * c, acc[a][c] * scale);
    if (tx == 0) {
      const long long at = ((long long)bb * h + hh) * tq + q0 + row;
      lse_out[at] = lse[a];
      dd_out[at] = dd[a];
    }
  }
}

// dout: (b, tq, h, HD) contiguous; lse, dd: (b, h, tq); dk, dv: (b, tk, kh,
// HD) contiguous
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                    int h, int kh, int group, long long q_sb, long long q_st,
                    long long q_sh, long long k_sb, long long k_st,
                    long long k_sh, long long v_sb, long long v_st,
                    long long v_sh, int causal, int q_offset,
                    int kv_valid_len, float scale) {
  constexpr int QS = HD + 1;
  constexpr int DC = HD / 16;
  extern __shared__ float sm[];
  float* sk = sm;              // kTile x QS
  float* sv = sk + kTile * QS;
  float* sq = sv + kTile * QS;
  float* sdo = sq + kTile * QS;
  float* sp = sdo + kTile * QS;  // kTile x SS: P^T (keys x query rows)
  float* sds = sp + kTile * SS;  // kTile x SS: dS^T
  float* slse = sds + kTile * SS;
  float* sdd = slse + kTile;

  const int j0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kv_end = min(kv_valid_len, tk);
  const long long o_st = (long long)h * HD;

  float acc_dk[kPer][DC], acc_dv[kPer][DC];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_dk[a][c] = acc_dv[a][c] = 0.f;

  if (j0 < kv_end) {
    const int n_k = min(kTile, kv_end - j0);
    load_tile<T, HD>(sk, k + bb * k_sb + kvh * k_sh, k_st, j0, n_k);
    load_tile<T, HD>(sv, v + bb * v_sb + kvh * v_sh, v_st, j0, n_k);
    // the first query tile with a row that sees key j0
    const int i_first = causal ? max(0, j0 - q_offset) / kTile * kTile : 0;
    for (int g = 0; g < group; ++g) {
      const int hh = kvh * group + g;
      const long long o_base = ((long long)bb * tq * h + hh) * HD;
      const float* lse_h = lse + ((long long)bb * h + hh) * tq;
      const float* dd_h = dd + ((long long)bb * h + hh) * tq;
      for (int i0 = i_first; i0 < tq; i0 += kTile) {
        const int n_q = min(kTile, tq - i0);
        __syncthreads();  // the previous tile's reads are done
        load_tile<T, HD>(sq, q + bb * q_sb + hh * q_sh, q_st, i0, n_q);
        load_tile<T, HD>(sdo, dout + o_base, o_st, i0, n_q);
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
                             (!causal || j0 + key <= q_offset + i0 + qr);
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
            gg[c] = sdo[i * QS + tx + 16 * c];
            qq[c] = sq[i * QS + tx + 16 * c];
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
      store(dk + at + tx + 16 * c, acc_dk[a][c] * scale);
      store(dv + at + tx + 16 * c, acc_dv[a][c]);
    }
  }
}

}  // namespace bwd

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
  int causal, q_offset, kv_valid_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_bwd(const BwdArgs& a) {
  auto ka = bwd::bwd_dq_kernel<T, HD>;
  auto kb = bwd::bwd_dkdv_kernel<T, HD>;
  constexpr size_t smem_a = bwd::dq_smem_bytes<HD>();
  constexpr size_t smem_b = bwd::dkdv_smem_bytes<HD>();
  if (const int err = allow_smem(ka, smem_a)) return err;
  if (const int err = allow_smem(kb, smem_b)) return err;
  const int group = a.h / a.kh;
  const dim3 grid_a((a.tq + bwd::kTile - 1) / bwd::kTile, a.h, a.b);
  ka<<<grid_a, bwd::kThreads, smem_a, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.out,
      (const T*)a.dout, (T*)a.dq, (float*)a.lse, (float*)a.dd, a.tq, a.tk,
      a.h, group, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb,
      a.v_st, a.v_sh, a.causal, a.q_offset, a.kv_valid_len, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b((a.tk + bwd::kTile - 1) / bwd::kTile, a.kh, a.b);
  kb<<<grid_b, bwd::kThreads, smem_b, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.dd, (T*)a.dk, (T*)a.dv, a.tq,
      a.tk, a.h, a.kh, group, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st,
      a.k_sh, a.v_sb, a.v_st, a.v_sh, a.causal, a.q_offset, a.kv_valid_len,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width(int hd, const BwdArgs& a) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(a);
    case 32: return launch_bwd<T, 32>(a);
    case 64: return launch_bwd<T, 64>(a);
    case 128: return launch_bwd<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, tq, h, hd) and k, v (b, tk, kh, hd) at the given element strides
// (batch, position, head; the head axis contiguous), all of one dtype
// (0 float32, 1 bfloat16); out, dout and dq (b, tq, h, hd) and dk, dv (b, tk,
// kh, hd) contiguous in that dtype; lse and dd (b, h, tq) float32 scratch.
// Launches bwd_dq_kernel, then bwd_dkdv_kernel, on `stream`; returns
// cudaGetLastError() after them, or the error of a shared-memory request.
extern "C" int quiver_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int dtype, int b, int tq, int tk, int h, int kh, int hd, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, int q_offset, int kv_valid_len, float scale, void* stream) {
  if (b == 0 || tq == 0 || h == 0 || tk == 0) return (int)cudaGetLastError();
  const BwdArgs a{q,    k,    v,    out,  dout, dq,     dk,       dv,
                  lse,  dd,   b,    tq,   tk,   h,      kh,       q_sb,
                  q_st, q_sh, k_sb, k_st, k_sh, v_sb,   v_st,     v_sh,
                  causal, q_offset, kv_valid_len, scale,
                  (cudaStream_t)stream};
  if (dtype == 0) return by_width<float>(hd, a);
  if (dtype == 1) return by_width<__nv_bfloat16>(hd, a);
  return (int)cudaErrorInvalidValue;
}
