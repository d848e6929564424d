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
// shapes (minicpm-2b: hd = 64, 36 heads, bf16) every call is bound by bytes:
// prefill (8 x 320 over a 384-row cache) moves 47 MB against 3.8 GFLOP
// (14.1 us at 3.35 TB/s against 3.8 us at 989 TFLOP/s), embed (64 docs x 64)
// 75 MB, and decode (8 x 1 at 352 keys) reads the visible cache, 26 MB, for
// 4 * hd flops a key.
//
// Three kernels, chosen by the wrapper (kernels/flash_attention.py) by dtype
// and Tq:
//
// * flash_mma_kernel: bf16 q/k/v, Tq > 1 (embed, prefill).  The products run
//   on the tensor cores.  One block of 4 warps per (64-row query tile, head,
//   batch), 16 query rows a warp.  The Q tile is copied to shared memory once
//   and loaded into mma A fragments with ldmatrix.  K and V tiles of 64 keys
//   stay in bf16 in a 2-stage ring in shared memory, filled with 16-byte
//   cp.async copies, so that tile j + 1 loads while tile j is computed; every
//   row is padded by 16 bytes, which puts the 8 rows an ldmatrix reads in 8
//   distinct groups of 4 banks.  S = Q K^T is
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (K's rows are the col-major
//   B operand as they lie); the scores are scaled (by scale * log2 e, so the
//   softmax runs on exp2) and masked to -1e30 in registers, the running max
//   and denominator stay in float32 registers, the max reduced over the quad
//   of lanes that share a row; P is rounded to bf16 in registers (the C
//   fragment of S is the A fragment of P, as in FlashAttention-2) and
//   O += P V is the same mma with V read through ldmatrix.trans.  The output
//   is normalised in float32, staged through the Q tile's shared memory and
//   written as bf16 in 16-byte stores.  The key loop stops at the last key
//   any row of the block can see, and masks only the tiles that cross a
//   mask edge.  Shared memory: (64 + 4 * 64) rows x (hd + 8) bf16, 45 KB at
//   hd = 64, 85 KB at hd = 128.  The grid is (heads, batch, query tiles)
//   with the query tiles issued last-first, so every block with the most
//   keys to walk starts before any with fewer (a causal prefill's blocks
//   range from 1 to Tq / 64 key tiles), and the short ones fill the tail.
//
// * flash_split_kernel + flash_merge_kernel: bf16, Tq = 1 (decode).  One
//   query row gives the tensor cores nothing to do, and a block per query
//   tile would leave the card idle, so the visible keys are cut into splits
//   of 64: one block of 128 threads per (split, KV head, batch) reads its K
//   and V rows once, with 16-byte cp.async copies, for all H/K query heads of
//   its group, and computes each head's partial (m, l, o) in float32 on the
//   CUDA cores into float32 scratch (the wrapper's torch.empty).  A split
//   whose keys are all masked writes m = -1e30, l = 0, o = 0.  The merge
//   kernel, one block per (query head, batch), rescales each split by
//   exp2(m_s - m), in one pass with a running max, and writes bf16; a fully
//   masked split weighs exp2(-1e30 - m) = 0 there, so the result is the
//   one-pass softmax's.  The merge is
//   launched as a programmatic dependent launch: it is scheduled while the
//   splits run and waits for them with griddepcontrol.wait, so its launch
//   overlaps their tail.  At minicpm-2b's decode (8 x 36 KV heads, 352
//   keys) that is 1 728 split blocks.
//
// * flash_kernel (namespace simt): float32 q, over float32 or bf16 k/v.
//   float32 FMAs on the CUDA cores, because TF32 tensor cores keep about 3
//   digits, outside the 2e-3 float32 tolerance. One block of 128 threads per
//   (64-row query tile, head, batch); the Q tile sits in shared memory as
//   float32, K and V tiles of 64 keys are streamed through shared memory (K
//   and Q at row stride hd + 1), thread (ty, tx) = (tid / 16, tid % 16) owns
//   query rows 8ty .. 8ty + 7, key columns tx + 16c and output columns tx +
//   16c; each row's max and sum by half-warp shuffles; the probabilities go
//   through shared memory for the P.V product. Shared memory (64 (hd + 1) * 2
//   + 64 hd + 64 * 65) * 4 bytes: 65 KB at hd = 64, 113 KB at hd = 128.
//
// The bf16 kernels take pointers and batch, position and head strides that
// keep every row on a 16-byte boundary; the wrapper checks that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace simt {

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

}  // namespace simt

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // query rows a block, 16 a warp
constexpr int kKeys = 64;      // keys a tile, and a decode split
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 elements (16 bytes) of row padding
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled where !in (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kRows + 4 * kKeys) * (HD + kPad) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int tq, int tk, int h, int group, long long q_sb,
                     long long q_st, long long q_sh, long long k_sb,
                     long long k_st, long long k_sh, long long v_sb,
                     long long v_st, long long v_sh, int causal, int q_offset,
                     int kv_valid_len, float scale_log2) {
  static_assert(HD % 16 == 0, "head width must be a multiple of 16");
  constexpr int RS = HD + kPad;     // row stride (elements) of every tile
  constexpr int CH = HD / 8;        // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;   // k-steps of Q K^T
  constexpr int NT = kKeys / 8;     // score n-tiles a warp
  constexpr int DT = HD / 8;        // output n-tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kRows x RS, then the output
  bf16* sk = sq + kRows * RS;                // 2 stages x kKeys x RS
  bf16* sv = sk + 2 * kKeys * RS;            // 2 stages x kKeys x RS

  // grid (heads, batch, query tiles), the tiles with the most keys first
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const bf16* qb = q + bb * q_sb + hh * q_sh;
  const bf16* kb = k + bb * k_sb + (hh / group) * k_sh;
  const bf16* vb = v + bb * v_sb + (hh / group) * v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wrow = warp * 16;  // this warp's first row in the tile

  // the last key any row of this block can see
  int kv_end = min(kv_valid_len, tk);
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kRows, tq));
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool in = q0 + r < tq;
    cp_async16(sq + r * RS + d, in ? qb + (long long)(q0 + r) * q_st + d : qb,
               in);
  }
  auto load_kv = [&](int tile) {
    const int j0 = tile * kKeys;
    bf16* dk = sk + (tile & 1) * kKeys * RS;
    bf16* dv = sv + (tile & 1) * kKeys * RS;
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int r = c / CH, d = (c % CH) * 8;
      const bool in = j0 + r < kv_end;  // rows past it load as zeros
      const long long row = j0 + r;
      cp_async16(dk + r * RS + d, in ? kb + row * k_st + d : kb, in);
      cp_async16(dv + r * RS + d, in ? vb + row * v_st + d : vb, in);
    }
  };
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // rows r0 and r0 + 8 of the tile: running max (log2 units) and this
  // thread's part of the denominator
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int r0 = q0 + wrow + lane / 4;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_kv(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        ldmatrix_x4(qf[s], sq + (wrow + lane % 16) * RS + s * 16 +
                               (lane / 16) * 8);
    }
    const bf16* tk_ = sk + (tile & 1) * kKeys * RS;
    const bf16* tv_ = sv + (tile & 1) * kKeys * RS;

    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, tk_ + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                           ks * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    const int j0 = tile * kKeys;
    // a tile that no mask edge crosses for any row of this warp
    const bool full = j0 + kKeys <= min(kv_valid_len, tk) &&
                      (!causal || j0 + kKeys - 1 <= q_offset + q0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (!full) {
          const int key = j0 + t * 8 + (lane % 4) * 2 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          const bool vis = key < kv_valid_len && key < tk &&
                           (!causal || key <= q_offset + row);
          x = vis ? x : kMasked;
        }
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key 0 is visible to every real row, so m is a real score from the
      // first tile on, and a masked score's exp2(-1e30 - m) is 0
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[t][e] - m[e >> 1]);
        s[t][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(b, tv_ + key * RS + dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is free for tile + 2
  }

  // each warp stages its own 16 rows in the Q tile (its Q fragments are in
  // registers) and writes them as 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  bf16* so = sq + wrow * RS;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int d = t * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(so + (lane / 4) * RS + d) =
        pack_bf16(o[t][0] * inv[0], o[t][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (lane / 4 + 8) * RS + d) =
        pack_bf16(o[t][2] * inv[1], o[t][3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    const int row = q0 + wrow + r;
    if (row < tq)
      *reinterpret_cast<uint4*>(out + (((long long)bb * tq + row) * h + hh) *
                                          HD +
                                d) =
          *reinterpret_cast<const uint4*>(so + r * RS + d);
  }
}

// Decode, Tq = 1: one block per (split of kKeys keys, KV head, batch).
// Partials of query head hq = kvh * group + g go to
// part_o[((b * h + hq) * n_split + split) * HD + d] and
// part_ml[((b * h + hq) * n_split + split) * 2 + {0, 1}] = (m, l), m in
// log2 units of the scaled score.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, float* __restrict__ part_o,
                       float* __restrict__ part_ml, int h, int group,
                       int n_split, long long q_sb, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       int causal, int q_offset, int kv_end,
                       float scale_log2) {
  constexpr int TPR = HD / 8;            // threads a key row, 8 dims each
  constexpr int RP = kThreads / TPR;     // key rows a pass
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);          // kKeys x HD
  bf16* sv = sk + kKeys * HD;                        // kKeys x HD
  float* sq = reinterpret_cast<float*>(sv + kKeys * HD);  // group x HD
  float* ss = sq + group * HD;                       // group x kKeys
  float* red = ss + group * kKeys;                   // 4 warps x group x HD

  // the merge may be scheduled now (programmatic dependent launch); it
  // waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = blockIdx.x, kvh = blockIdx.y, bb = blockIdx.z;
  const int j0 = split * kKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq0 = kvh * group;
  const long long part0 = ((long long)bb * h + hq0) * n_split + split;

  // the visible keys of the single query row are a prefix: j < last
  const int last = causal ? min(kv_end, q_offset + 1) : kv_end;
  const int n_vis = max(0, min(kKeys, last - j0));
  if (n_vis == 0) {  // a fully masked split: m = -1e30, l = 0, o = 0
    for (int e = tid; e < group * HD; e += kThreads)
      part_o[(part0 + (long long)(e / HD) * n_split) * HD + e % HD] = 0.f;
    for (int g = tid; g < group; g += kThreads) {
      part_ml[(part0 + (long long)g * n_split) * 2] = kMasked;
      part_ml[(part0 + (long long)g * n_split) * 2 + 1] = 0.f;
    }
    return;
  }

  const bf16* kb = k + bb * k_sb + kvh * k_sh;
  const bf16* vb = v + bb * v_sb + kvh * v_sh;
  for (int c = tid; c < kKeys * TPR; c += kThreads) {
    const int r = c / TPR, d = (c % TPR) * 8;
    const bool in = r < n_vis;  // rows past it load as zeros
    cp_async16(sk + r * HD + d, in ? kb + (long long)(j0 + r) * k_st + d : kb,
               in);
    cp_async16(sv + r * HD + d, in ? vb + (long long)(j0 + r) * v_st + d : vb,
               in);
  }
  cp_async_commit();
  for (int c = tid; c < group * TPR; c += kThreads) {
    const int g = c / TPR, d = (c % TPR) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + bb * q_sb + (hq0 + g) * q_sh + d);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p2[i]);
      sq[g * HD + d + 2 * i] = f.x;
      sq[g * HD + d + 2 * i + 1] = f.y;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int c = tid % TPR, r = tid / TPR;
  // scores: each thread dots its 8 dims of a key row with every head of
  // the group, summed over the row's TPR threads
  for (int j = r; j < kKeys; j += RP) {
    const uint4 raw = *reinterpret_cast<const uint4*>(sk + j * HD + c * 8);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float kf[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p2[i]);
      kf[2 * i] = f.x;
      kf[2 * i + 1] = f.y;
    }
    for (int g = 0; g < group; ++g) {
      const float* qg = sq + g * HD + c * 8;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qg[i], kf[i], dot);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (c == 0) ss[g * kKeys + j] = j < n_vis ? dot * scale_log2 : kMasked;
    }
  }
  __syncthreads();

  // each head's max and sum over the split, one warp a head
  for (int g = warp; g < group; g += kThreads / 32) {
    float* sg = ss + g * kKeys;
    const float a = sg[lane], b = sg[lane + 32];
    float mx = fmaxf(a, b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // n_vis >= 1, so mx is a real score and exp2(-1e30 - mx) = 0
    const float pa = exp2f(a - mx), pb = exp2f(b - mx);
    sg[lane] = pa;
    sg[lane + 32] = pb;
    float sum = pa + pb;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_ml[(part0 + (long long)g * n_split) * 2] = mx;
      part_ml[(part0 + (long long)g * n_split) * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // o = P V: each thread sums its 8 dims over its key rows, then the rows
  // of a warp by shuffles and the 4 warps through shared memory
  for (int g = 0; g < group; ++g) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int j = r; j < kKeys; j += RP) {
      const float p = ss[g * kKeys + j];
      const uint4 raw = *reinterpret_cast<const uint4*>(sv + j * HD + c * 8);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p2[i]);
        acc[2 * i] = fmaf(p, f.x, acc[2 * i]);
        acc[2 * i + 1] = fmaf(p, f.y, acc[2 * i + 1]);
      }
    }
#pragma unroll
    for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    if (lane < TPR) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(warp * group + g) * HD + c * 8 + i] = acc[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < group * HD; e += kThreads) {
    const float sum = red[e] + red[group * HD + e] + red[2 * group * HD + e] +
                      red[3 * group * HD + e];
    part_o[(part0 + (long long)(e / HD) * n_split) * HD + e % HD] = sum;
  }
}

template <int HD>
size_t split_smem_bytes(int group) {
  return 2 * (size_t)kKeys * HD * sizeof(bf16) +
         (size_t)group * (HD + kKeys + 4 * HD) * sizeof(float);
}

// One block per (query head, batch), one thread a dim: the splits' partials
// rescaled by exp2(m_s - m) into one softmax, written as bf16 (b, 1, h, HD).
// One pass, with a running max: each split's loads are independent of the
// previous split's arithmetic, so they are all in flight together.
template <int HD>
__global__ void flash_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   bf16* __restrict__ out, int h,
                                   int n_split) {
  // launched early (programmatic dependent launch): wait for the splits
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long row = (long long)blockIdx.y * h + blockIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * n_split;
  const int d = threadIdx.x < HD ? threadIdx.x : HD - 1;
  float mx = kMasked, den = 0.f, acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float2 p = ml[s];
    const float o = part_o[(row * n_split + s) * HD + d];
    const float m_new = fmaxf(mx, p.x);
    const float c_old = exp2f(mx - m_new), c_s = exp2f(p.x - m_new);
    den = fmaf(den, c_old, p.y * c_s);
    acc = fmaf(acc, c_old, o * c_s);
    mx = m_new;
  }
  if (threadIdx.x < HD)
    out[row * HD + d] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
}

}  // namespace tc

namespace {

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

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename TQ, typename TKV, int HD>
int launch_simt(const Args& a) {
  auto kernel = simt::flash_kernel<TQ, TKV, HD>;
  constexpr size_t smem = simt::smem_bytes<HD>();
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((a.tq + simt::kRows - 1) / simt::kRows, a.h, a.b);
  kernel<<<grid, simt::kThreads, smem, a.stream>>>(
      (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, (TQ*)a.out, a.tq,
      a.tk, a.h, a.h / a.kh, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh,
      a.v_sb, a.v_st, a.v_sh, a.causal, a.q_offset, a.kv_valid_len,
      a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const Args& a) {
  auto kernel = tc::flash_mma_kernel<HD>;
  constexpr size_t smem = tc::mma_smem_bytes<HD>();
  if (const int err = allow_smem(kernel, smem)) return err;
  const dim3 grid(a.h, a.b, (a.tq + tc::kRows - 1) / tc::kRows);
  kernel<<<grid, tc::kThreads, smem, a.stream>>>(
      (const tc::bf16*)a.q, (const tc::bf16*)a.k, (const tc::bf16*)a.v,
      (tc::bf16*)a.out, a.tq, a.tk, a.h, a.h / a.kh, a.q_sb, a.q_st, a.q_sh,
      a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.causal, a.q_offset,
      a.kv_valid_len, a.scale * tc::kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_split(const Args& a, float* part_o, float* part_ml, int n_split) {
  auto kernel = tc::flash_split_kernel<HD>;
  const int group = a.h / a.kh;
  const size_t smem = tc::split_smem_bytes<HD>(group);
  if (const int err = allow_smem(kernel, smem)) return err;
  const int kv_end = a.kv_valid_len < a.tk ? a.kv_valid_len : a.tk;
  kernel<<<dim3(n_split, a.kh, a.b), tc::kThreads, smem, a.stream>>>(
      (const tc::bf16*)a.q, (const tc::bf16*)a.k, (const tc::bf16*)a.v,
      part_o, part_ml, a.h, group, n_split, a.q_sb, a.q_sh, a.k_sb, a.k_st,
      a.k_sh, a.v_sb, a.v_st, a.v_sh, a.causal, a.q_offset, kv_end,
      a.scale * tc::kLog2e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.h, a.b);
  cfg.blockDim = dim3(HD < 32 ? 32 : HD);
  cfg.stream = a.stream;
  // scheduled while the splits run, so its launch overlaps their tail
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t merr =
      cudaLaunchKernelEx(&cfg, tc::flash_merge_kernel<HD>,
                         (const float*)part_o, (const float*)part_ml,
                         (tc::bf16*)a.out, a.h, n_split);
  if (merr != cudaSuccess) return (int)merr;
  return (int)cudaGetLastError();
}

// the head widths every route is instantiated for
template <typename F>
int by_width(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point: q (b, tq, h, hd) and k, v (b, tk, kh, hd) at the given
// element strides (batch, position, head; the head axis contiguous); out
// (b, tq, h, hd) contiguous in q's dtype.  Each returns cudaGetLastError()
// after its launches, or the error of a shared-memory request.

// float32 q over float32 (kv_dtype 0) or bfloat16 (kv_dtype 1) k/v: the
// CUDA-core kernel.
extern "C" int quiver_flash_attention(
    const void* q, const void* k, const void* v, void* out, int kv_dtype,
    int b, int tq, int tk, int h, int kh, int hd, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, int q_offset, int kv_valid_len, float scale, void* stream) {
  if (b == 0 || tq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{q,    k,    v,    out,  b,    tq,     tk,       h,
               kh,   q_sb, q_st, q_sh, k_sb, k_st,   k_sh,     v_sb,
               v_st, v_sh, causal, q_offset, kv_valid_len, scale,
               (cudaStream_t)stream};
  return by_width(hd, [&](auto w) {
    constexpr int HD = decltype(w)::value;
    if (kv_dtype == 0) return launch_simt<float, float, HD>(a);
    if (kv_dtype == 1) return launch_simt<float, __nv_bfloat16, HD>(a);
    return (int)cudaErrorInvalidValue;
  });
}

// bfloat16 q, k, v: the tensor-core kernel (any tq; the wrapper sends
// tq > 1).
extern "C" int quiver_flash_attention_mma(
    const void* q, const void* k, const void* v, void* out, int b, int tq,
    int tk, int h, int kh, int hd, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, int causal, int q_offset,
    int kv_valid_len, float scale, void* stream) {
  if (b == 0 || tq == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{q,    k,    v,    out,  b,    tq,     tk,       h,
               kh,   q_sb, q_st, q_sh, k_sb, k_st,   k_sh,     v_sb,
               v_st, v_sh, causal, q_offset, kv_valid_len, scale,
               (cudaStream_t)stream};
  return by_width(hd, [&](auto w) {
    return launch_mma<decltype(w)::value>(a);
  });
}

// bfloat16 q (tq = 1), k, v: the split-KV decode.  part_o (b, h, n_split,
// hd) and part_ml (b, h, n_split, 2) are float32 scratch; n_split =
// ceil(min(kv_valid_len, tk) / 64).
extern "C" int quiver_flash_decode_split(
    const void* q, const void* k, const void* v, void* out, void* part_o,
    void* part_ml, int n_split, int b, int tk, int h, int kh, int hd,
    long long q_sb, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, int q_offset, int kv_valid_len, float scale, void* stream) {
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  const Args a{q,    k,    v,    out,  b,    1,      tk,       h,
               kh,   q_sb, 0,    q_sh, k_sb, k_st,   k_sh,     v_sb,
               v_st, v_sh, causal, q_offset, kv_valid_len, scale,
               (cudaStream_t)stream};
  return by_width(hd, [&](auto w) {
    return launch_split<decltype(w)::value>(a, (float*)part_o,
                                            (float*)part_ml, n_split);
  });
}
