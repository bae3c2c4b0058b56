// GLASS local-importance sums, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/local_stats.py:local_stats (bodies
// _norms_kernel and _accum_kernel): out[j] = sum_t mask[t] * |h[t, j]| /
// (||h[t, :]||_2 + 1e-6) over a (T, m) hidden-activation stream, f32 out.
// The optional f32 row mask is the token_mask of
// models/ffn.py:ffn_forward_with_stats, which the TPU kernel lacks; a null
// mask counts every row.
//
// What bounds it on an H100: bytes.  The function reads h once (T * m *
// elem bytes) and writes m floats; it does ~4 flops per element, far
// below the card's flops per byte.
//
// Design: three launches, each with a fixed summation order and no
// atomics, so two calls on the same input give the same bits (a stat that
// wandered between runs would move near-tie blocks between GLASS masks).
//   1. row_norm_kernel: one CTA per row; denom[t] = sqrt(sum h^2) + 1e-6,
//      reduced in a fixed butterfly + warp order.
//   2. col_partial_kernel: a CTA per (256 columns, 32 rows); each thread
//      adds its column over the tile's rows in row order into
//      partial[tile, col].  The TPU grid carried the column sums across
//      row tiles in order; a GPU grid has no order, hence the partials.
//   3. col_final_kernel: each thread adds its column's partials in tile
//      order (skipped when there is one tile: pass 2 writes out directly).
// The second pass reads h again (from L2 when it fits); speed is later
// work: no vector loads, and pass 1 could fuse into pass 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 32;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) row_norm_kernel(const T* __restrict__ h,
                                                            float* __restrict__ denom, int m) {
  __shared__ float warp_sums[kThreads / 32];
  const T* row = h + static_cast<size_t>(blockIdx.x) * m;
  float s = 0.f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float x = to_f(row[j]);
    s = fmaf(x, x, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tot += warp_sums[w];
    denom[blockIdx.x] = sqrtf(tot) + kEps;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) col_partial_kernel(
    const T* __restrict__ h, const float* __restrict__ denom, const float* __restrict__ mask,
    float* __restrict__ partial, int T_rows, int m) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  const int t0 = blockIdx.y * kRowsPerTile;
  const int t1 = min(T_rows, t0 + kRowsPerTile);
  float acc = 0.f;
  for (int t = t0; t < t1; ++t) {
    float a = fabsf(to_f(h[static_cast<size_t>(t) * m + col])) / denom[t];
    if (mask != nullptr) a *= mask[t];
    acc += a;
  }
  partial[static_cast<size_t>(blockIdx.y) * m + col] = acc;
}

__global__ void __launch_bounds__(kThreads) col_final_kernel(const float* __restrict__ partial,
                                                             float* __restrict__ out, int n_tiles,
                                                             int m) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += partial[static_cast<size_t>(i) * m + col];
  out[col] = s;
}

template <typename T>
cudaError_t launch(const void* h, const float* mask, float* denom, float* partial, float* out,
                   int T_rows, int m, cudaStream_t stream) {
  const T* hp = static_cast<const T*>(h);
  const int n_tiles = (T_rows + kRowsPerTile - 1) / kRowsPerTile;
  const int col_blocks = (m + kThreads - 1) / kThreads;
  row_norm_kernel<T><<<T_rows, kThreads, 0, stream>>>(hp, denom, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* dst = n_tiles == 1 ? out : partial;
  col_partial_kernel<T><<<dim3(col_blocks, n_tiles), kThreads, 0, stream>>>(hp, denom, mask, dst,
                                                                           T_rows, m);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 1) return err;
  col_final_kernel<<<col_blocks, kThreads, 0, stream>>>(partial, out, n_tiles, m);
  return cudaGetLastError();
}

}  // namespace

// The number of row tiles pass 2 uses; the wrapper sizes the partial
// buffer (n_tiles, m) f32 from it.
extern "C" int local_stats_row_tiles(int T_rows) {
  return (T_rows + kRowsPerTile - 1) / kRowsPerTile;
}

// h (T, m) contiguous; mask (T,) f32 or null; denom (T,) f32 and partial
// (n_tiles, m) f32 scratch; out (m,) f32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launches (0 = success).
extern "C" int local_stats(const void* h, const void* mask, void* denom, void* partial, void* out,
                           int T_rows, int m, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mk = static_cast<const float*>(mask);
  float* dn = static_cast<float*>(denom);
  float* pt = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(h, mk, dn, pt, o, T_rows, m, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(h, mk, dn, pt, o, T_rows, m, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
