// Paged attention over a KV block table, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:paged_attention
// (body _kernel).  T queries per row attend to that row's KV blocks read
// through the block table; query t sits at logical position cache_len + t.
// Masks: causal, a runtime sliding window (2**30 = global), optional tanh
// softcap.  Online softmax in f32; masked entries add exactly 0.
//
// What bounds it on an H100: bytes.  Each (row, query, kv-head) reads its
// live K and V blocks once (2 * bs * hd * elem bytes per block) and does
// ~4 * G * hd flops per key, far below the ~295 flops/byte the tensor
// cores need, so the live KV bytes over 3.35 TB/s are the bound.
//
// Design: one CTA per (kv-head, query, row), one warp per query row of
// the G-wide group.  The CTA walks the row's table entries IN ORDER up to
// the query's frontier and skips blocks that lie fully below the window,
// exactly the TPU kernel's skip rule; it never splits over KV and uses no
// atomics.  Each CTA's arithmetic depends only on its own query and its
// own live blocks, so a T-wide call equals T one-query calls bitwise and
// the result does not depend on the nb bucket.  The block's K and V land
// in shared memory as f32; a warp computes its bs scores with a fixed
// butterfly reduction (lane jj keeps score jj, so bs <= 32), then updates
// (m, l, acc) with the exact-zero `where` of the TPU kernel.  The
// probabilities are rounded to V's dtype before the PV product, as the TPU
// kernel's p.astype(v.dtype) does.  Speed is later work: no cp.async, TMA
// or wgmma yet, and small-batch decode leaves most SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHdPerLane = 8;  // head_dim <= 256
constexpr float kNeg = -2.0e38f;

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

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q,          // (B, Tq, K, G, hd)
    const T* __restrict__ cache_k,    // (num_blocks, bs, K, hd)
    const T* __restrict__ cache_v,
    const int* __restrict__ table,    // (B, nb)
    const int* __restrict__ cache_len,  // (B,)
    T* __restrict__ out,              // (B, Tq, K, G, hd)
    int Tq, int K, int G, int hd, int nb, int bs, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, hd)
  float* vs = smem + bs * hd;  // (bs, hd)

  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qpos = cache_len[b] + t;

  const size_t qoff = ((((size_t)b * Tq + t) * K + h) * G + g) * hd;
  float qr[kMaxHdPerLane], acc[kMaxHdPerLane];
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hd ? to_f(q[qoff + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const int j_hi = min(qpos / bs, nb - 1);  // last block holding a live key
  for (int j = 0; j <= j_hi; ++j) {
    // skip blocks entirely below the window (every entry would mask to 0)
    if (qpos - ((j + 1) * bs - 1) >= window) continue;
    const int blk = table[(size_t)b * nb + j];
    __syncthreads();  // the previous block's tiles are no longer read
    for (int e = threadIdx.x; e < bs * hd; e += blockDim.x) {
      const int r = e / hd, d = e % hd;
      const size_t src = (((size_t)blk * bs + r) * K + h) * hd + d;
      ks[e] = to_f(cache_k[src]);
      vs[e] = to_f(cache_v[src]);
    }
    __syncthreads();

    // lane jj holds score jj of this block
    float my_s = kNeg;
    bool my_mask = false;
    for (int jj = 0; jj < bs; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part += qr[i] * ks[jj * hd + d];
      }
      float s = warp_sum(part) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kpos = j * bs + jj;
      const bool mk = (qpos >= kpos) && (qpos - kpos < window);
      if (lane == jj) {
        my_s = mk ? s : kNeg;
        my_mask = mk;
      }
    }
    const float m_new = fmaxf(m, warp_max(my_s));
    const float alpha = expf(m - m_new);
    const float p = my_mask ? expf(my_s - m_new) : 0.f;  // exact zero when masked
    l = l * alpha + warp_sum(p);
    const float pv = to_f(from_f<T>(p));  // p rounded to V's dtype
#pragma unroll
    for (int i = 0; i < kMaxHdPerLane; ++i) acc[i] *= alpha;
    for (int jj = 0; jj < bs; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, pv, jj);
#pragma unroll
      for (int i = 0; i < kMaxHdPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] += pj * vs[jj * hd + d];
      }
    }
    m = m_new;
  }

  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxHdPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[qoff + d] = from_f<T>(acc[i] / lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* table, const int* clen,
                   void* out, int B, int Tq, int K, int G, int hd, int nb, int bs, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(K, Tq, B);
  paged_attention_kernel<T><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table, clen,
      static_cast<T*>(out), Tq, K, G, hd, nb, bs, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means none.  Returns the
// cudaError_t of the launch (0 = success); the wrapper raises otherwise.
extern "C" int paged_attention(const void* q, const void* cache_k, const void* cache_v,
                               const void* table, const void* cache_len, void* out, int B, int Tq,
                               int K, int G, int hd, int nb, int bs, int window, float softcap,
                               float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* cl = static_cast<const int*>(cache_len);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, cache_k, cache_v, tab, cl, out, B, Tq, K, G, hd, nb, bs, window,
                        softcap, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, cache_k, cache_v, tab, cl, out, B, Tq, K, G, hd, nb, bs, window,
                                softcap, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
