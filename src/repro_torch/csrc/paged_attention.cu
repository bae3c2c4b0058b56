// Paged attention over a KV block table, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:paged_attention
// (body _kernel).  T queries per row attend to that row's KV, read through
// the block table; query t sits at logical position cache_len + t.  Masks:
// causal, a runtime sliding window (2**30 = global), optional tanh softcap.
// Online softmax in f32; masked entries add exactly 0; the probabilities
// are rounded to V's dtype before the P.V product (the TPU kernel's
// p.astype(v.dtype)).
//
// What bounds it on an H100: bytes.  A decode tick reads each row's live
// K and V once (Llama-3-8B heads: 4 KB a head per 16-key block) and does
// about 4 * G * hd flops a key, far below the ~295 flops a byte at which
// the tensor cores would bound it; so the live KV bytes over 3.35 TB/s are
// the bound.  A one-CTA-per-query walk of the blocks cannot reach it: at
// decode it starts only K * B CTAs for 132 SMs and waits on each block in
// turn, and in a prefill chunk every query re-reads the same blocks.
//
// Design: two launches, no atomics.
//
// 1. Split.  The KV walk is cut into splits of kSplit = 128 logical key
//    positions, a constant of the kernel (never derived from the shapes or
//    the lengths).  One CTA per (64 rows, kv head, split, batch row), a row
//    being one (query, head-in-group) pair of that kv head, so the G query
//    heads of a kv head share each K/V tile and, for T > 1, 64 / G queries
//    of one row share it too (a G that does not divide 64 lets a query's
//    heads fall into two CTAs; each row is computed on its own).  A CTA
//    whose split lies past every row's frontier, or below every row's
//    window, exits at once.  Otherwise one thread per key of the split
//    reads the key's block-table entry (only the keys some row attends to,
//    so trash entries past the frontier are never read), and the split's
//    K and V arrive by cp.async in 16-byte pieces, bf16 as stored, into
//    shared memory: Q, then K and V of each 64-key tile as their own
//    groups, all in flight at once, so the first tile's scores start while
//    the rest still loads.  Rows are padded by 16 bytes, so each ldmatrix
//    phase of 8 rows touches 8 distinct bank groups.
// 2. Tensor cores (bf16).  Each warp owns 16 rows.  Per 64-key tile: S =
//    Q K^T by mma.sync m16n8k16 from ldmatrix fragments, in the log2
//    domain (one exp2 an entry), the online softmax on the accumulator
//    fragments (max across each row's 4 lanes; each lane keeps its own part
//    of the row sum until the end), P rounded to bf16 in registers as the
//    A operand of O += P V (ldmatrix .trans for V).  The CTA writes each
//    row's f32 partial (m, l, unnormalised O) of the split to a scratch
//    buffer the wrapper allocates.  A head_dim below 64, 128 or 256 is
//    padded to it with zero columns (never written out).
// 3. Combine.  One warp per output row walks that row's splits in order,
//    0 upward, and only those that reach its frontier and its window:
//    O = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s.
//
// Contracts (chip_smoke.py holds them bitwise on the card):
// - A T-wide call equals T one-query calls.  A row's splits, its tiles and
//   their order depend only on its position, the window and kSplit.  A
//   tile a packed neighbour needs but this row does not is an exact no-op
//   for it: every entry masked, p = 0, alpha = 1 (m unchanged), and a row
//   that has seen no live key yet subtracts 0 instead of -inf, so its l and
//   O stay exactly 0 with no NaN.
// - The nb bucket changes no bit: a wider table only adds CTAs that exit.
// - An inactive row (cache_len 0 on trash block 0) attends to its one key
//   and writes a finite output.
//
// f32 (and a bf16 call whose head_dim is not a multiple of 8, whose rows
// cp.async cannot copy in 16-byte pieces): the same splits and combine on
// the CUDA cores.  One CTA per (kv head, query,
// split, batch row), one warp per head of the group; the split's keys
// arrive 32 at a time as f32 in shared memory, lane j holds score j.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kSplit = 128;             // logical key positions per split
constexpr int kKeys = 64;               // keys per softmax tile
constexpr int kTiles = kSplit / kKeys;  // tiles per split
constexpr int kRows = 64;               // (query, head-in-group) rows per CTA
constexpr int kThreads = 128;           // 4 warps x 16 rows
constexpr int kPad = 8;                 // bf16 elements (16 bytes) of padding per smem row
static_assert(kThreads == kSplit, "one thread per key resolves the split's table entries");

struct Args {
  const void *q, *k, *v;  // q (B, T, K, G, hd); k, v (num_blocks, bs, K, hd)
  const int* table;       // (B, nb)
  const int* clen;        // (B,)
  float* part_o;          // (n_split, R, hd), R = B * T * K * G
  float* part_ml;         // (n_split, R, 2): running max (log2 domain) and sum
  void* out;              // (B, T, K, G, hd)
  int B, T, K, G, hd, nb, bs, n_split, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// waits until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// the keys a query at position p attends to: [p - window + 1, min(p, cap - 1)]
__device__ __forceinline__ int key_lo(int p, int window) { return max(p - window + 1, 0); }

// -- bf16: tensor cores -------------------------------------------------------

template <int HD>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kRows + 2 * kSplit) * (HD + kPad) * sizeof(__nv_bfloat16) +
         kSplit * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_split_mma_kernel(const Args a) {
  constexpr int kLd = HD + kPad;   // smem row, in elements
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  constexpr int kSteps = HD / 16;  // k-steps of QK^T, n-tile pairs of P.V
  constexpr bool kQInRegs = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kLd]
  __nv_bfloat16* sK = sQ + kRows * kLd;                             // [kSplit][kLd]
  __nv_bfloat16* sV = sK + kSplit * kLd;                            // [kSplit][kLd]
  int* sRow = reinterpret_cast<int*>(sV + kSplit * kLd);            // [kSplit] pool row or -1

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.n_split, split = blockIdx.z % a.n_split;
  const int G = a.G, n_rows = a.T * G;
  const int row0 = blockIdx.x * kRows;
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int clen = a.clen[b];
  const int cap = a.nb * a.bs;  // keys the table can hold
  const int s0 = split * kSplit;
  // the keys of this split that some row of the CTA attends to
  const int k_lo = max(s0, key_lo(clen + row0 / G, a.window));
  const int k_hi = min(min(s0 + kSplit, clen + last_row / G + 1), cap);  // exclusive
  if (k_lo >= k_hi) return;  // past every frontier or below every window

  {  // one thread per key: its pool row (block * bs + offset), -1 outside [k_lo, k_hi)
    const int key = s0 + tid;
    sRow[tid] = key >= k_lo && key < k_hi
                    ? a.table[static_cast<size_t>(b) * a.nb + key / a.bs] * a.bs + key % a.bs
                    : -1;
  }
  const int hd_chunks = a.hd / 8;
  for (int idx = tid; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int row = row0 + r;
    const bool ok = row < n_rows && c < hd_chunks;
    const __nv_bfloat16* src = q;
    if (ok)
      src = q + ((((size_t)b * a.T + row / G) * a.K + h) * G + row % G) * a.hd + c * 8;
    cp_async16(sQ + r * kLd + c * 8, src, ok);
  }
  cp_async_commit();
  __syncthreads();  // sRow is written

  // each thread copies one 16-byte chunk column of every kRowStep-th key row
  // of a tile; K then V of each tile are their own groups, all in flight
  constexpr int kRowStep = kThreads / kChunks, kLoads = kKeys / kRowStep;
  const int lr = tid / kChunks, lc = tid % kChunks;
  const bool lc_ok = lc < hd_chunks;
  const size_t pool_row = static_cast<size_t>(a.K) * a.hd;  // elements per pool row
  bool live[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    live[i] = s0 + i * kKeys < k_hi && s0 + (i + 1) * kKeys > k_lo;  // uniform over the CTA
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (live[i]) {
        const __nv_bfloat16* base = (which ? v : k) + static_cast<size_t>(h) * a.hd + lc * 8;
        __nv_bfloat16* dst = (which ? sV : sK) + (i * kKeys + lr) * kLd + lc * 8;
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int pr = sRow[i * kKeys + lr + j * kRowStep];
          const bool ok = pr >= 0 && lc_ok;
          cp_async16(dst + j * kRowStep * kLd, ok ? base + pr * pool_row : base, ok);
        }
      }
      cp_async_commit();
    }
  }

  // this thread's rows: r_lo = warp*16 + lane/4 and r_lo + 8 (hh = 0, 1);
  // row hh attends to keys lo[hh] .. hi[hh] (none when lo > hi)
  const int gid = lane / 4, tig = lane % 4;
  const int wrow0 = row0 + warp * 16;
  const bool warp_live = wrow0 < n_rows;
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = wrow0 + gid + 8 * hh;
    const int p = clen + row / G;
    lo[hh] = row < n_rows ? key_lo(p, a.window) : 1;
    hi[hh] = row < n_rows ? min(p, cap - 1) : 0;
  }
  // the warp's tiles need no mask where every key is valid for all 16 rows
  const bool warp_full = wrow0 + 16 <= n_rows;
  const int w_hi_min = min(clen + wrow0 / G, cap - 1);
  const int w_lo_max = clen + min(wrow0 + 15, n_rows - 1) / G - a.window + 1;

  const __nv_bfloat16* sQw = sQ + warp * 16 * kLd;
  // ldmatrix row addresses: A (16 x 16 of Q), B pairs of K (16 keys x 16
  // dims), V transposed (16 keys x 16 dims)
  const int a_off = (lane % 16) * kLd + (lane / 16) * 8;
  const int k_off = ((lane % 8) + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
  const int v_off = ((lane % 8) + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  float o[2 * kSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // scores go to the log2 domain (exp2 below): x * log2(e)
  const float scale2 = a.scale * kLog2e, cap2 = a.softcap * kLog2e, inv_cap = 1.f / a.softcap;
  int i_first = 0;  // the first live tile loads Q's fragments
  while (!live[i_first]) ++i_first;

#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    if (!live[i]) continue;  // uniform: no row attends to a key of this tile
    const int t0 = s0 + i * kKeys;
    cp_async_wait_pending(2 * (kTiles - 1 - i) + 1);  // Q and this tile's K have landed
    __syncthreads();
    const __nv_bfloat16* tk = sK + i * kKeys * kLd;
    const __nv_bfloat16* tv = sV + i * kKeys * kLd;
    float s[8][4];  // 8 n-tiles of 8 keys; [0..1] row r_lo, [2..3] row r_lo + 8
    if (warp_live) {
      if constexpr (kQInRegs) {
        if (i == i_first) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], sQw + a_off + kk * 16);
        }
      }
      // S = Q K^T over the steps j = (kk, np): 16 dims x 16 keys each, every
      // B fragment loaded two steps ahead of its mma (a ring of 3)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      constexpr int kQkSteps = kSteps * 4;
      uint32_t kfr[3][4], af[4];
      ldmatrix_x4(kfr[0], tk + k_off);
      ldmatrix_x4(kfr[1], tk + k_off + 16 * kLd);
#pragma unroll
      for (int j = 0; j < kQkSteps; ++j) {
        if (j + 2 < kQkSteps)
          ldmatrix_x4(kfr[(j + 2) % 3], tk + k_off + ((j + 2) % 4) * 16 * kLd + ((j + 2) / 4) * 16);
        const int kk = j / 4, np = j % 4;
        if (np == 0) {
          if constexpr (kQInRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
          } else {
            ldmatrix_x4(af, sQw + a_off + kk * 16);
          }
        }
        mma_bf16(s[2 * np], af, kfr[j % 3][0], kfr[j % 3][1]);
        mma_bf16(s[2 * np + 1], af, kfr[j % 3][2], kfr[j % 3][3]);
      }

      // scores -> log2 domain, masked entries -inf; the branches are uniform
      if (a.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = cap2 * tanhf(s[j][e] * a.scale * inv_cap);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
      }
      if (!warp_full || t0 + kKeys - 1 > w_hi_min || t0 < w_lo_max) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e / 2, key = t0 + 8 * j + 2 * tig + e % 2;
            s[j][e] = lo[hh] <= key && key <= hi[hh] ? s[j][e] : -INFINITY;
          }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_run[hh], mt);
        // while a row has seen no valid key (m_new = -inf) it subtracts 0
        // instead: every p is exp2(-inf) = 0 and its O and l stay exactly 0;
        // a tile that leaves m unchanged rescales by exactly 1
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = m_new == m_run[hh] ? 1.f : ex2(m_run[hh] - m_use);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            s[j][e] = ex2(s[j][e] - m_use);  // exactly 0 where masked
            psum += s[j][e];
          }
        l_run[hh] = l_run[hh] * alpha + psum;  // this lane's keys; summed over the row at the end
        m_run[hh] = m_new;
#pragma unroll
        for (int n = 0; n < 2 * kSteps; ++n) {
          o[n][2 * hh] *= alpha;
          o[n][2 * hh + 1] *= alpha;
        }
      }
    }
    cp_async_wait_pending(2 * (kTiles - 1 - i));  // this tile's V has landed
    __syncthreads();
    if (warp_live) {
      // O += P V over the steps j = (kk, dp): 16 keys x 16 dims each, V's
      // fragments two steps ahead; P (unnormalised, rounded to bf16) is the
      // A operand as it is
      constexpr int kPvSteps = 4 * kSteps;
      uint32_t vfr[3][4], af[4];
      ldmatrix_x4_trans(vfr[0], tv + v_off);
      ldmatrix_x4_trans(vfr[1], tv + v_off + (1 / kSteps) * 16 * kLd + (1 % kSteps) * 16);
#pragma unroll
      for (int j = 0; j < kPvSteps; ++j) {
        if (j + 2 < kPvSteps)
          ldmatrix_x4_trans(vfr[(j + 2) % 3], tv + v_off + ((j + 2) / kSteps) * 16 * kLd +
                                                  ((j + 2) % kSteps) * 16);
        const int kk = j / kSteps, dp = j % kSteps;
        if (dp == 0) {
          af[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          af[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          af[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          af[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        mma_bf16(o[2 * dp], af, vfr[j % 3][0], vfr[j % 3][1]);
        mma_bf16(o[2 * dp + 1], af, vfr[j % 3][2], vfr[j % 3][3]);
      }
    }
  }
  if (!warp_live) return;

  // this split's partial of each row whose walk includes it
  const size_t R = static_cast<size_t>(a.B) * a.T * a.K * G;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = wrow0 + gid + 8 * hh;
    if (lo[hh] > hi[hh] || split < lo[hh] / kSplit || split > hi[hh] / kSplit) continue;
    const size_t r = (((size_t)b * a.T + row / G) * a.K + h) * G + row % G;
    const size_t base = static_cast<size_t>(split) * R + r;
    float* po = a.part_o + base * a.hd;
#pragma unroll
    for (int n = 0; n < 2 * kSteps; ++n)
      if (8 * n < a.hd)
        *reinterpret_cast<float2*>(po + 8 * n + 2 * tig) = make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
    if (tig == 0) *reinterpret_cast<float2*>(a.part_ml + base * 2) = make_float2(m_run[hh], l);
  }
}

// -- f32 (and odd bf16 shapes): CUDA cores --------------------------------------

constexpr int kMaxHdPerLane = 8;  // head_dim <= 256
constexpr int kStepKeys = 32;     // keys a step: lane j holds score j

template <typename T>
__global__ void paged_attention_split_kernel(const Args a) {
  extern __shared__ float smem[];
  float* ks = smem;                         // [kStepKeys][hd]
  float* vs = smem + kStepKeys * a.hd;      // [kStepKeys][hd]
  __shared__ int sRow[kSplit];

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int h = blockIdx.x, t = blockIdx.y;
  const int b = blockIdx.z / a.n_split, split = blockIdx.z % a.n_split;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = a.hd;
  const int p = a.clen[b] + t;
  const int lo = key_lo(p, a.window), hi = min(p, a.nb * a.bs - 1);
  const int s0 = split * kSplit;
  const int k_lo = max(s0, lo), k_hi = min(s0 + kSplit - 1, hi);  // inclusive
  if (k_lo > k_hi) return;  // no key of this split is live for the query
  for (int i = threadIdx.x; i < kSplit; i += blockDim.x) {
    const int key = s0 + i;
    sRow[i] = key >= k_lo && key <= k_hi
                  ? a.table[static_cast<size_t>(b) * a.nb + key / a.bs] * a.bs + key % a.bs
                  : -1;
  }

  const size_t r = (((size_t)b * a.T + t) * a.K + h) * a.G + g;
  float qr[kMaxHdPerLane], acc[kMaxHdPerLane];
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hd ? to_f(q[r * hd + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const float scale2 = a.scale * kLog2e, cap2 = a.softcap * kLog2e;
  const size_t pool_row = static_cast<size_t>(a.K) * hd;

  for (int c0 = s0 + (k_lo - s0) / kStepKeys * kStepKeys; c0 <= k_hi; c0 += kStepKeys) {
    __syncthreads();  // the previous step's tiles are no longer read (and sRow is written)
    for (int e = threadIdx.x; e < kStepKeys * hd; e += blockDim.x) {
      const int j = e / hd, d = e % hd;
      const int pr = sRow[c0 - s0 + j];
      const size_t src = pr * pool_row + static_cast<size_t>(h) * hd + d;
      ks[e] = pr >= 0 ? to_f(k[src]) : 0.f;
      vs[e] = pr >= 0 ? to_f(v[src]) : 0.f;
    }
    __syncthreads();

    float my_s = -INFINITY;  // lane j: score of key c0 + j, -inf where masked
    for (int j = 0; j < kStepKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part += qr[i] * ks[j * hd + d];
      }
      const float s = warp_sum(part);
      const float s2 = a.softcap > 0.f ? cap2 * tanhf(s * a.scale / a.softcap) : s * scale2;
      const int key = c0 + j;
      if (lane == j && key >= lo && key <= hi) my_s = s2;
    }
    const float m_new = fmaxf(m, warp_max(my_s));
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m_new == m ? 1.f : exp2f(m - m_use);
    const float p_own = exp2f(my_s - m_use);  // exactly 0 where masked
    l = l * alpha + warp_sum(p_own);
    const float pv = to_f(from_f<T>(p_own));  // p rounded to V's dtype
#pragma unroll
    for (int i = 0; i < kMaxHdPerLane; ++i) acc[i] *= alpha;
    for (int j = 0; j < kStepKeys; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] += pj * vs[j * hd + d];
      }
    }
    m = m_new;
  }

  const size_t base = static_cast<size_t>(split) * a.B * a.T * a.K * a.G + r;
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) a.part_o[base * hd + d] = acc[i];
  }
  if (lane == 0) *reinterpret_cast<float2*>(a.part_ml + base * 2) = make_float2(m, l);
}

// -- combine ------------------------------------------------------------------

constexpr int kCombineRows = 4;  // rows (warps) per CTA

template <typename T>
__global__ void __launch_bounds__(32 * kCombineRows) paged_attention_combine_kernel(const Args a) {
  const size_t R = static_cast<size_t>(a.B) * a.T * a.K * a.G;
  const size_t r = static_cast<size_t>(blockIdx.x) * kCombineRows + threadIdx.x / 32;
  if (r >= R) return;
  const int lane = threadIdx.x % 32;
  const int t = static_cast<int>(r / (a.K * a.G) % a.T), b = static_cast<int>(r / (R / a.B));
  const int p = a.clen[b] + t;
  const int lo = key_lo(p, a.window), hi = min(p, a.nb * a.bs - 1);
  T* o = static_cast<T*>(a.out) + r * a.hd;
  if (lo > hi) {  // no key at all (a table too narrow for the row): zeros
    for (int d = lane; d < a.hd; d += 32) o[d] = from_f<T>(0.f);
    return;
  }
  const int s_lo = lo / kSplit, s_hi = hi / kSplit;
  float M = -INFINITY;
  for (int s = s_lo; s <= s_hi; ++s) M = fmaxf(M, a.part_ml[(s * R + r) * 2]);
  float L = 0.f;
  for (int s = s_lo; s <= s_hi; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(a.part_ml + (s * R + r) * 2);
    L += exp2f(ml.x - M) * ml.y;
  }
  const float inv_l = 1.f / fmaxf(L, 1e-30f);
  for (int d = lane; d < a.hd; d += 32) {
    float acc = 0.f;
    for (int s = s_lo; s <= s_hi; ++s)
      acc += exp2f(a.part_ml[(s * R + r) * 2] - M) * a.part_o[(s * R + r) * a.hd + d];
    o[d] = from_f<T>(acc * inv_l);
  }
}

// -- launch -------------------------------------------------------------------

template <int HD>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  static bool configured[64] = {};  // per device; setting it twice is harmless
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(paged_attention_split_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev] = true;
  }
  const dim3 grid((a.T * a.G + kRows - 1) / kRows, a.K, a.B * a.n_split);
  paged_attention_split_mma_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cuda_cores(const Args& a, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kStepKeys) * a.hd * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_split_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.K, a.T, a.B * a.n_split);
  paged_attention_split_kernel<T><<<grid, 32 * a.G, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const Args& a, cudaStream_t stream) {
  const size_t R = static_cast<size_t>(a.B) * a.T * a.K * a.G;
  const unsigned blocks = static_cast<unsigned>((R + kCombineRows - 1) / kCombineRows);
  paged_attention_combine_kernel<T><<<blocks, 32 * kCombineRows, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Logical key positions per split: the wrapper sizes the partials' scratch
// as (ceil(nb * bs / split), B * T * K * G) rows.
extern "C" int paged_attention_split_size() { return kSplit; }

// q (B, T, K, G, hd), cache_k/v (num_blocks, bs, K, hd), table (B, nb) and
// cache_len (B,) int32, out like q; part_o (n_split * B*T*K*G * hd) and
// part_ml (n_split * B*T*K*G * 2) f32 scratch, n_split = ceil(nb * bs /
// split size).  hd <= 256, G <= 32; for bf16, q, cache_k and cache_v
// 16-byte aligned; window >= 1 (2**30 = global); softcap <= 0 means none;
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (0 = success); the wrapper raises otherwise.
extern "C" int paged_attention(const void* q, const void* cache_k, const void* cache_v,
                               const void* table, const void* cache_len, void* out, void* part_o,
                               void* part_ml, int B, int Tq, int K, int G, int hd, int nb, int bs,
                               int window, float softcap, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, cache_k, cache_v, static_cast<const int*>(table),
               static_cast<const int*>(cache_len), static_cast<float*>(part_o),
               static_cast<float*>(part_ml), out, B, Tq, K, G, hd, nb, bs,
               (nb * bs + kSplit - 1) / kSplit, window, softcap, scale};
  cudaError_t err;
  if (dtype == 0) {
    err = launch_cuda_cores<float>(a, s);
    if (err == cudaSuccess) err = launch_combine<float>(a, s);
  } else if (dtype == 1) {
    if (hd % 8 != 0) err = launch_cuda_cores<__nv_bfloat16>(a, s);
    else if (hd <= 64) err = launch_mma<64>(a, s);
    else if (hd <= 128) err = launch_mma<128>(a, s);
    else err = launch_mma<256>(a, s);
    if (err == cudaSuccess) err = launch_combine<__nv_bfloat16>(a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
