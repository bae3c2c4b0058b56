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
// beyond.  This first version computes on the CUDA cores in f32 (67
// TFLOP/s), 15x below the bf16 tensor-core rate; tensor cores (mma/wgmma)
// and TMA are later work.
//
// Design: one CTA (256 threads) per (64 rows, kv head, batch row), where a
// row is one (query, head-in-group) pair: the G query heads that share a
// kv head share each K/V tile loaded into shared memory.  The CTA walks
// the kv tiles of 64 keys IN ORDER from the first tile its window reaches
// to the last its causal frontier reaches.  Per tile: K lands transposed
// and V as is in shared memory as f32; each thread computes a 4 x 4 block
// of scores (4 rows, 4 keys) over hd; the 16 threads of a row group
// reduce the row max and sum with a fixed butterfly; p = exp(s - m_new)
// (exactly 0 where masked, and no update at all while a row has seen no
// valid key, so a fully masked tile adds nothing); p is rounded to V's
// dtype, as the TPU kernel's p.astype(v.dtype) does, and each thread adds
// p @ V for its 4 rows and hd / 16 dims.  No atomics and no split over
// KV, so results are deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;             // (query, head-in-group) rows per CTA
constexpr int kKeys = 64;             // keys per kv tile
constexpr int kPStride = kKeys + 4;   // padded row of the probability tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Strides {
  long long b, h, s;  // in elements; the head_dim axis is contiguous
};

template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(HD) * kRows + static_cast<size_t>(HD) * kKeys +
         static_cast<size_t>(kKeys) * HD + static_cast<size_t>(kRows) * kPStride;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    Strides qs, Strides ks, Strides vs, Strides os, int Sq, int Skv, int G, int causal,
    int window, float softcap, float scale) {
  constexpr int kDimGroups = HD / 64;  // float4 groups of dims per thread, 64 dims apart
  extern __shared__ float smem[];
  float* q_t = smem;                  // [HD][kRows]   q tile, transposed
  float* k_t = q_t + HD * kRows;      // [HD][kKeys]   k tile, transposed
  float* v_s = k_t + HD * kKeys;      // [kKeys][HD]   v tile
  float* p_s = v_s + kKeys * HD;      // [kRows][kPStride] rounded probabilities

  const int tid = threadIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = Sq * G;
  const int row0 = blockIdx.x * kRows;
  const int offset = Skv - Sq;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int r = idx % kRows, d = idx / kRows;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows) {
      const int qi = row / G, g = row % G;
      x = to_f(q[b * qs.b + static_cast<long long>(kh * G + g) * qs.h +
                 static_cast<long long>(qi) * qs.s + d]);
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
      k_t[d * kKeys + c] = key < Skv ? to_f(kb[static_cast<long long>(key) * ks.s + d]) : 0.f;
    }
    for (int idx = tid; idx < kKeys * HD; idx += kThreads) {
      const int d = idx % HD, c = idx / HD;
      const int key = t0 + c;
      v_s[c * HD + d] = key < Skv ? to_f(vb[static_cast<long long>(key) * vs.s + d]) : 0.f;
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
      float4 pr;
      pr.x = to_f(from_f<T>(p[0]));
      pr.y = to_f(from_f<T>(p[1]));
      pr.z = to_f(from_f<T>(p[2]));
      pr.w = to_f(from_f<T>(p[3]));
      *reinterpret_cast<float4*>(p_s + (rg * 4 + i) * kPStride + cg * 4) = pr;
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
    T* orow = out + b * os.b + static_cast<long long>(kh * G + g) * os.h +
              static_cast<long long>(qi) * os.s;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int y = 0; y < kDimGroups; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) orow[y * 64 + cg * 4 + x] = from_f<T>(acc[i][y][x] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
                   Strides vs, Strides os, int B, int K, int Sq, int Skv, int G, int causal,
                   int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq * G + kRows - 1) / kRows, K, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, os, Sq, Skv, G, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out,
                        Strides qs, Strides ks, Strides vs, Strides os, int B, int K, int Sq,
                        int Skv, int G, int causal, int window, float softcap, float scale,
                        cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, os, B, K, Sq, Skv, G, causal, window,
                           softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, os, B, K, Sq, Skv, G, causal, window,
                            softcap, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, qs, ks, vs, os, B, K, Sq, Skv, G, causal, window,
                            softcap, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, K, Skv, hd), out (B, H, Sq, hd), each given
// by its data pointer and its batch, head and sequence strides in
// elements (head_dim contiguous).  H = K * G; hd in {64, 128, 256};
// window >= 1 (2**30 = none); softcap <= 0 means none; dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                               long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                               long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                               int B, int K, int G, int Sq, int Skv, int hd, int causal,
                               int window, float softcap, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_hd<float>(hd, q, k, v, out, qs, ks, vs, os, B, K, Sq, Skv, G, causal, window,
                             softcap, scale, s);
  } else if (dtype == 1) {
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, qs, ks, vs, os, B, K, Sq, Skv, G, causal,
                                     window, softcap, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
