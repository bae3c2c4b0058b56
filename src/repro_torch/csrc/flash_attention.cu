// Flash attention over a full sequence, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (body _kernel): causal / sliding-window / tanh-softcap attention with the
// ends aligned (query i sits at position i + Skv - Sq), online softmax in
// f32, masked entries adding exactly 0.  Unlike the TPU kernel it takes
// grouped-query attention as it is: q (B, H, Sq, hd) and k, v (B, K, Skv,
// hd) with query head h reading kv head h / (H / K), so the KV is never
// repeated; every tensor is read through its strides (the last axis
// contiguous), so the model's (B, S, heads, hd) projections need no
// transpose copy; and any Sq and Skv are taken (tail tiles are masked).
//
// What bounds it on an H100: a causal call does about 4 * Sq * Skv/2 * hd
// flops per query head and moves q, k, v and out once.  For Llama-3-8B's
// heads in bf16 that is bytes up to about 740 tokens (S 512: 10.5 MB,
// 3.1 us, against 2.1 GFLOP, 2.2 us at 989 TFLOP/s) and operations
// beyond.
//
// Two kernels, chosen by dtype (one C entry; both are the kernel, neither
// is a fallback of the other):
//
// bf16 -> flash_attention_mma_kernel, on the tensor cores.  QK^T and P.V
// are mma.sync.m16n8k16 (bf16 in, f32 accumulate) with operands loaded by
// ldmatrix (.trans for V).  mma.sync and not wgmma: at S <= ~740 the call
// is bound by bytes, and mma.sync's rate (well above the 2.2 us of flops
// at S 512) is enough; it also keeps each warp's 16 rows, their scores and
// their online-softmax state in that warp's registers with no warpgroup
// synchronisation.  One CTA (4 warps) per (64 rows, kv head, batch row),
// a row being one (query, head-in-group) pair, so the G query heads of a
// kv head share each K/V tile; each warp owns 16 rows.  Q's fragments stay
// in registers for the whole KV walk (hd <= 128; at hd 256 they are
// re-read from shared memory per tile, to keep the 128 f32 accumulators of
// a row pair in registers).  K/V tiles of 64 keys arrive by cp.async (16
// bytes a thread, from per-thread base pointers advanced a tile at a time)
// into a 2-stage ring: the next tile loads while this one computes; tail
// keys are zero-filled (src-size 0) and masked.  Rows are padded by 16
// bytes in shared memory, so each ldmatrix phase of 8 rows touches 8
// distinct 16-byte bank groups; K and V fragments are loaded two mma steps
// ahead.  The scores stay in f32 registers, in the log2 domain (one exp2 an
// entry); the online softmax works on the accumulator fragments, with a
// shuffle across each row's 4 lanes for the running max, while each lane
// keeps its own part of the row sum until the end.  The softcap and mask
// branches are uniform per tile (a tile inside every row's band skips the
// mask), so the entries of a tile carry no branch of their own, and the
// output takes one reciprocal a row.  P is rounded to bf16 in registers
// and fed as the A operand of the P.V mma (the m16n8 accumulator layout is
// the m16n8k16 A layout); this is the TPU kernel's p.astype(v.dtype).
//
// f32 -> flash_attention_kernel, on the CUDA cores in f32: one CTA (256
// threads) per (64 rows, kv head, batch row); per tile, K lands transposed
// and V as is in shared memory; each thread computes a 4 x 4 block of
// scores over hd and adds p @ V for its 4 rows and hd / 16 dims.
//
// Both: each CTA walks the kv tiles of 64 keys IN ORDER from the first
// tile its window reaches to the last its causal frontier reaches.  The
// running max starts at -inf and a row takes no update while it has seen
// no valid key, so a fully masked tile adds exactly nothing.  No atomics
// and no split of the KV walk across CTAs: two calls are bitwise equal,
// and a row's bits depend only on its query row and its batch row's K/V
// (a batch row computes the same alone as inside a batch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kRows = 64;  // (query, head-in-group) rows per CTA
constexpr int kKeys = 64;  // keys per kv tile

struct Strides {
  long long b, h, s;  // in elements; the head_dim axis is contiguous
};

// -- bf16: tensor cores -------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;           // bf16 elements (16 bytes) of padding per smem row

template <int HD>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kRows + 4 * kKeys) * (HD + kPad) * sizeof(__nv_bfloat16);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int Sq, int Skv, int G, int causal, int window,
    float softcap, float scale) {
  constexpr int kLd = HD + kPad;      // smem row, in elements
  constexpr int kChunks = HD / 8;     // 16-byte chunks per row
  constexpr int kSteps = HD / 16;     // k-steps of QK^T, n-tile pairs of P.V
  constexpr bool kQInRegs = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kLd]
  __nv_bfloat16* sK = sQ + kRows * kLd;                             // [2][kKeys][kLd]
  __nv_bfloat16* sV = sK + 2 * kKeys * kLd;                         // [2][kKeys][kLd]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_rows = Sq * G;
  // the last row blocks walk the most tiles: launch them first
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int offset = Skv - Sq;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kRows * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* src = q;
    if (ok)
      src = q + b * qs.b + static_cast<long long>(kh * G + row % G) * qs.h +
            static_cast<long long>(row / G) * qs.s + c * 8;
    cp_async16(sQ + r * kLd + c * 8, src, ok);
  }
  cp_async_commit();

  // the kv range any row of this CTA attends to, in whole tiles
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int qpos_lo = row0 / G + offset, qpos_hi = last_row / G + offset;
  const int kv_hi = causal ? min(Skv, qpos_hi + 1) : Skv;
  const long long lo = static_cast<long long>(qpos_lo) - window + 1;
  const int t_start = lo > 0 ? static_cast<int>(lo / kKeys) * kKeys : 0;

  // each thread copies one 16-byte chunk column of every kRowStep-th key
  // row of a tile: fixed offsets, advanced by t0 rows per tile
  constexpr int kRowStep = kMmaThreads / kChunks, kLoads = kKeys / kRowStep;
  const int lr = tid / kChunks, lc = tid % kChunks;
  const __nv_bfloat16* kt = kb + lr * ks.s + lc * 8;
  const __nv_bfloat16* vt = vb + lr * vs.s + lc * 8;
  const long long kstep = kRowStep * ks.s, vstep = kRowStep * vs.s;
  auto load_tile = [&](int t0, int stage) {
    __nv_bfloat16* dk = sK + stage * kKeys * kLd + lr * kLd + lc * 8;
    __nv_bfloat16* dv = sV + stage * kKeys * kLd + lr * kLd + lc * 8;
    const __nv_bfloat16* gk = kt + t0 * ks.s;
    const __nv_bfloat16* gv = vt + t0 * vs.s;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const bool ok = t0 + lr + i * kRowStep < Skv;
      cp_async16(dk + i * kRowStep * kLd, ok ? gk + i * kstep : kb, ok);
      cp_async16(dv + i * kRowStep * kLd, ok ? gv + i * vstep : vb, ok);
    }
  };
  load_tile(t_start, 0);
  cp_async_commit();

  // this thread's rows: r_lo = warp*16 + lane/4 and r_lo + 8 (h = 0, 1)
  const int gid = lane / 4, tig = lane % 4;
  bool rvalid[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + gid + 8 * h;
    rvalid[h] = row < n_rows;
    qpos[h] = rvalid[h] ? row / G + offset : 0;
  }
  const __nv_bfloat16* sQw = sQ + warp * 16 * kLd;
  // ldmatrix row addresses: A (16 x 16 of Q), B pairs of K (16 keys x 16
  // dims), V transposed (16 keys x 16 dims)
  const int a_off = (lane % 16) * kLd + (lane / 16) * 8;
  const int k_off = ((lane % 8) + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
  const int v_off = ((lane % 8) + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  cp_async_wait<1>();  // Q has landed (the first tile may still be in flight)
  __syncthreads();
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], sQw + a_off + kk * 16);
  }

  float o[2 * kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const bool rows_full = row0 + kRows <= n_rows;
  // scores go to the log2 domain (exp2 below): x * log2(e)
  const float scale2 = scale * kLog2e, cap2 = softcap * kLog2e, inv_cap = 1.f / softcap;

  for (int it = 0, t0 = t_start; t0 < kv_hi; ++it, t0 += kKeys) {
    const int stage = it & 1;
    if (t0 + kKeys < kv_hi) {
      load_tile(t0 + kKeys, stage ^ 1);  // its stage was last read before the loop's end barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tk = sK + stage * kKeys * kLd;
    const __nv_bfloat16* tv = sV + stage * kKeys * kLd;

    // S = Q K^T over the steps i = (kk, np): 16 dims x 16 keys each, every
    // B fragment loaded two steps ahead of its mma (a ring of 3)
    float s[8][4];  // 8 n-tiles of 8 keys; [0..1] row r_lo, [2..3] row r_lo + 8
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    constexpr int kQkSteps = kSteps * 4;
    uint32_t kfr[3][4];
    ldmatrix_x4(kfr[0], tk + k_off);
    ldmatrix_x4(kfr[1], tk + k_off + 16 * kLd);
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < kQkSteps; ++i) {
      if (i + 2 < kQkSteps)
        ldmatrix_x4(kfr[(i + 2) % 3], tk + k_off + ((i + 2) % 4) * 16 * kLd + ((i + 2) / 4) * 16);
      const int kk = i / 4, np = i % 4;
      if (np == 0) {
        if constexpr (kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, sQw + a_off + kk * 16);
        }
      }
      mma_bf16(s[2 * np], a, kfr[i % 3][0], kfr[i % 3][1]);
      mma_bf16(s[2 * np + 1], a, kfr[i % 3][2], kfr[i % 3][3]);
    }
    // the first V fragments load while the softmax runs
    constexpr int kPvSteps = 4 * kSteps;
    uint32_t vfr[3][4];
    ldmatrix_x4_trans(vfr[0], tv + v_off);
    ldmatrix_x4_trans(vfr[1], tv + v_off + (1 / kSteps) * 16 * kLd + (1 % kSteps) * 16);

    // scores -> log2 domain, masked entries -inf; the branches are uniform
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = cap2 * tanhf(s[j][e] * scale * inv_cap);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }
    // a tile needs no mask when every key is valid for every row of the CTA
    if (!rows_full || t0 + kKeys > Skv || (causal && t0 + kKeys - 1 > qpos_lo) ||
        qpos_hi - t0 >= window) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, key = t0 + 8 * j + 2 * tig + e % 2;
          const bool valid = rvalid[h] && key < Skv && (!causal || key <= qpos[h]) &&
                             qpos[h] - key < window;
          s[j][e] = valid ? s[j][e] : -INFINITY;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[h], mt);
      // while a row has seen no valid key (m_new = -inf) it subtracts 0
      // instead: every p is exp2(-inf) = 0 and its o and l stay exactly 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = ex2(m_run[h] - m_use);  // 0 while m_run is still -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = ex2(s[j][e] - m_use);  // exactly 0 where masked
          psum += s[j][e];
        }
      l_run[h] = l_run[h] * alpha + psum;  // this lane's keys; summed over the row at the end
      m_run[h] = m_new;
#pragma unroll
      for (int n = 0; n < 2 * kSteps; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
    }

    // O += P V over the steps i = (kk, dp): 16 keys x 16 dims each, V's
    // fragments two steps ahead; P (unnormalized, rounded to bf16) is the A
    // operand as it is
#pragma unroll
    for (int i = 0; i < kPvSteps; ++i) {
      if (i + 2 < kPvSteps)
        ldmatrix_x4_trans(vfr[(i + 2) % 3], tv + v_off + ((i + 2) / kSteps) * 16 * kLd +
                                                ((i + 2) % kSteps) * 16);
      const int kk = i / kSteps, dp = i % kSteps;
      if (dp == 0) {
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      mma_bf16(o[2 * dp], a, vfr[i % 3][0], vfr[i % 3][1]);
      mma_bf16(o[2 * dp + 1], a, vfr[i % 3][2], vfr[i % 3][3]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // normalize, stage the warp's 16 rows in its own rows of sQ, and write
  // them out 16 bytes a lane
  __nv_bfloat16* so = sQ + warp * 16 * kLd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);  // one division a row
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n)
      *reinterpret_cast<__nv_bfloat162*>(so + (gid + 8 * h) * kLd + 8 * n + 2 * tig) =
          __floats2bfloat162_rn(o[n][2 * h] * inv_l, o[n][2 * h + 1] * inv_l);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + warp * 16 + r;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst = out + b * os.b + static_cast<long long>(kh * G + row % G) * os.h +
                         static_cast<long long>(row / G) * os.s + c * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(so + r * kLd + c * 8);
  }
}

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPStride = kKeys + 4;  // padded row of the probability tile

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(HD) * kRows + static_cast<size_t>(HD) * kKeys +
         static_cast<size_t>(kKeys) * HD + static_cast<size_t>(kRows) * kPStride;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, Strides qs, Strides ks, Strides vs, Strides os, int Sq, int Skv,
    int G, int causal, int window, float softcap, float scale) {
  constexpr int kDimGroups = HD / 64;  // float4 groups of dims per thread, 64 dims apart
  extern __shared__ float smem[];
  float* q_t = smem;                  // [HD][kRows]   q tile, transposed
  float* k_t = q_t + HD * kRows;      // [HD][kKeys]   k tile, transposed
  float* v_s = k_t + HD * kKeys;      // [kKeys][HD]   v tile
  float* p_s = v_s + kKeys * HD;      // [kRows][kPStride] probabilities

  const int tid = threadIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = Sq * G;
  const int row0 = blockIdx.x * kRows;
  const int offset = Skv - Sq;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx % kRows, d = idx / kRows;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int qi = row / G, g = row % G;
      x = q[b * qs.b + static_cast<long long>(kh * G + g) * qs.h +
            static_cast<long long>(qi) * qs.s + d];
    }
    q_t[d * kRows + r] = x;
  }

  const int rg = tid / 16;  // row group: rows rg*4 .. rg*4+3
  const int cg = tid % 16;  // key group (scores) / dim group (PV)
  int qpos[4];
  bool rvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + rg * 4 + i;
    rvalid[i] = row < n_rows;
    qpos[i] = rvalid[i] ? row / G + offset : 0;
  }
  // the kv range any row of this CTA attends to, in whole tiles
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int qpos_lo = row0 / G + offset, qpos_hi = last_row / G + offset;
  const int kv_hi = causal ? min(Skv, qpos_hi + 1) : Skv;
  const long long lo = static_cast<long long>(qpos_lo) - window + 1;
  const int t_start = lo > 0 ? static_cast<int>(lo / kKeys) * kKeys : 0;

  float m_run[4], l_run[4], acc[4][kDimGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int y = 0; y < kDimGroups; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][y][x] = 0.f;
  }

  for (int t0 = t_start; t0 < kv_hi; t0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done (and q_t is written)
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int c = idx % kKeys, d = idx / kKeys;
      const int key = t0 + c;
      k_t[d * kKeys + c] = key < Skv ? kb[static_cast<long long>(key) * ks.s + d] : 0.f;
    }
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int d = idx % HD, c = idx / HD;
      const int key = t0 + c;
      v_s[c * HD + d] = key < Skv ? vb[static_cast<long long>(key) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kRows + rg * 4);
      const float4 bk = *reinterpret_cast<const float4*>(k_t + d * kKeys + cg * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(get(a, i), get(bk, j), s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool valid[4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + cg * 4 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = x;
        valid[j] = rvalid[i] && key < Skv && (!causal || key <= qpos[i]) && (qpos[i] - key < window);
        if (valid[j]) mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run[i], mt);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {  // uniform across the row group
        alpha = expf(m_run[i] - m_new);  // 0 while m_run is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
          psum += p[j];
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int y = 0; y < kDimGroups; ++y)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][y][x] *= alpha;
      *reinterpret_cast<float4*>(p_s + (rg * 4 + i) * kPStride + cg * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    for (int j = 0; j < kKeys; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (rg * 4 + i) * kPStride + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = v_s + (j + jj) * HD + cg * 4;
#pragma unroll
        for (int y = 0; y < kDimGroups; ++y) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + y * 64);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = get(pr[i], jj);
            acc[i][y][0] = fmaf(pij, vv.x, acc[i][y][0]);
            acc[i][y][1] = fmaf(pij, vv.y, acc[i][y][1]);
            acc[i][y][2] = fmaf(pij, vv.z, acc[i][y][2]);
            acc[i][y][3] = fmaf(pij, vv.w, acc[i][y][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rvalid[i]) continue;
    const int row = row0 + rg * 4 + i;
    const int qi = row / G, g = row % G;
    float* orow = out + b * os.b + static_cast<long long>(kh * G + g) * os.h +
                  static_cast<long long>(qi) * os.s;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int y = 0; y < kDimGroups; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) orow[y * 64 + cg * 4 + x] = acc[i][y][x] / l;
  }
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  Strides qs, ks, vs, os;
  int B, K, Sq, Skv, G, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_mma(const Args& a) {
  const size_t smem = mma_smem_bytes<HD>();
  static bool configured[64] = {};  // per device; setting it twice is harmless
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid((a.Sq * a.G + kRows - 1) / kRows, a.K, a.B);
  flash_attention_mma_kernel<HD><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out), a.qs, a.ks,
      a.vs, a.os, a.Sq, a.Skv, a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq * a.G + kRows - 1) / kRows, a.K, a.B);
  flash_attention_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.qs, a.ks, a.vs, a.os, a.Sq,
      a.Skv, a.G, a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<HD>(a);
  if (dtype == 1) return launch_mma<HD>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, K, Skv, hd), out (B, H, Sq, hd), each given
// by its data pointer and its batch, head and sequence strides in
// elements (head_dim contiguous; for bf16 every pointer 16-byte aligned and
// every stride a multiple of 8).  H = K * G; hd in {64, 128, 256};
// window >= 1 (2**30 = none); softcap <= 0 means none; dtype: 0 = float32
// (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                               long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                               long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                               int B, int K, int G, int Sq, int Skv, int hd, int causal,
                               int window, float softcap, float scale, int dtype, void* stream) {
  const Args a{q, k, v, out, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, B, K, Sq, Skv, G, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (hd) {
    case 64: err = launch<64>(a, dtype); break;
    case 128: err = launch<128>(a, dtype); break;
    case 256: err = launch<256>(a, dtype); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
