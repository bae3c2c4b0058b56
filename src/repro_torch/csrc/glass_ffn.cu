// Block-sparse GLASS FFN, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels repro/kernels/glass_ffn.py:
//   glass_ffn_block_sparse          (bodies _kernel, _kernel_scaled, _tile_contrib)
//   glass_ffn_block_sparse_rowwise  (bodies _kernel_rowwise, _kernel_rowwise_scaled)
// y = sum over the listed blocks, in list order, of
//     scale_i * (act(x Wg[:, blk]) * (x Wu[:, blk])) Wd[blk, :]
// (ungated: act(x Wu[:, blk]) Wd[blk, :]); h is rounded to the weight dtype
// before the down product, as _tile_contrib does; y is f32.  A 0.0 scale
// drops a tile exactly; a null scale pointer means unscaled.  The shared
// kernel takes one list for all rows, the rowwise kernel one list per row.
//
// What bounds it on an H100: bytes.  At decode a call streams the listed
// (d x bs) tiles of Wg and Wu and the (bs x d) tiles of Wd once (Llama-3-8B
// at density 0.5: 3 * 4096 * 128 * 2 B * 56 = 176 MB) and does 2 flops per
// weight element per row, so with a handful of rows it sits far below the
// tensor cores' flops-per-byte line: the weight bytes over 3.35 TB/s bound it.
//
// Design: the TPU kernel adds every tile into one output block because its
// grid runs in order.  A GPU grid does not, so each call is two launches
// and no atomics:
//   1. hidden: one CTA per (row group, active block, 32-column slice of the
//      block).  It computes h over all of d in f32 (x staged through shared
//      memory, 8 warps splitting d, reduced in a fixed order), rounds h to
//      the weight dtype and writes it to a (B, nb_keep * bs) scratch buffer.
//      Each weight tile is read once per row group.
//   2. down: one CTA per (row group, 32 output columns).  It walks the list
//      IN ORDER and adds scale_i * (h_i Wd[blk_i, cols]) in f32, so the sum
//      is deterministic and a 0.0 scale is an exact no-op.
// Loads are scalar (64 contiguous bytes per warp and weight row); speed is
// later work (vector loads, cp.async/TMA pipelines, wgmma at larger batch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;    // hidden columns (phase 1) / output columns (phase 2) per CTA
constexpr int kSlices = 8;   // warps splitting the reduction dimension
constexpr int kRows = 8;     // rows per CTA (shared-list kernel)
constexpr int kChunk = 256;  // x columns staged in shared memory per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act codes: 0 silu, 1 gelu (tanh approximation), 2 relu, 3 relu^2
__device__ __forceinline__ float act_fn(float v, int act) {
  switch (act) {
    case 0: return v / (1.f + expf(-v));
    case 1: return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case 2: return fmaxf(v, 0.f);
    default: { const float r = fmaxf(v, 0.f); return r * r; }
  }
}

template <typename T>
__global__ void hidden_kernel(const T* __restrict__ x,       // (B, d)
                              const T* __restrict__ w_gate,  // (d, m) or null
                              const T* __restrict__ w_up,    // (d, m)
                              const int* __restrict__ idx,   // (nb_keep,) or (B, nb_keep)
                              T* __restrict__ hbuf,          // (B, nb_keep * bs)
                              int B, int d, int m, int bs, int nbk, int rows_per_cta,
                              int list_stride, int act) {
  __shared__ float xs[kRows][kChunk];
  __shared__ float red_u[kSlices][kRows][kCols];
  __shared__ float red_g[kSlices][kRows][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int slices = (bs + kCols - 1) / kCols;
  const int i = blockIdx.x / slices;
  const int c = (blockIdx.x % slices) * kCols + tx;  // column within the block
  const int r0 = blockIdx.y * rows_per_cta;
  const int rows = min(rows_per_cta, B - r0);
  const int blk = idx[(size_t)r0 * list_stride + i];
  const bool valid = c < bs;
  const bool gated = w_gate != nullptr;
  const size_t col = (size_t)blk * bs + c;

  float au[kRows], ag[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) au[r] = ag[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();  // the previous chunk of x is no longer read
    for (int e = ty * kCols + tx; e < rows * kc; e += kCols * kSlices) {
      const int r = e / kc, kk = e % kc;
      xs[r][kk] = to_f(x[(size_t)(r0 + r) * d + k0 + kk]);
    }
    __syncthreads();
    if (valid) {
      for (int kk = ty; kk < kc; kk += kSlices) {
        const size_t w = (size_t)(k0 + kk) * m + col;
        const float wu = to_f(w_up[w]);
        const float wg = gated ? to_f(w_gate[w]) : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {
            au[r] += xs[r][kk] * wu;
            ag[r] += xs[r][kk] * wg;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    red_u[ty][r][tx] = au[r];
    red_g[ty][r][tx] = ag[r];
  }
  __syncthreads();
  if (ty == 0 && valid) {
    for (int r = 0; r < rows; ++r) {
      float u = 0.f, g = 0.f;
      for (int s = 0; s < kSlices; ++s) {
        u += red_u[s][r][tx];
        g += red_g[s][r][tx];
      }
      const float hv = gated ? act_fn(g, act) * u : act_fn(u, act);
      hbuf[(size_t)(r0 + r) * nbk * bs + (size_t)i * bs + c] = from_f<T>(hv);
    }
  }
}

template <typename T>
__global__ void down_kernel(const T* __restrict__ hbuf,      // (B, nb_keep * bs)
                            const T* __restrict__ w_down,    // (m, d)
                            const int* __restrict__ idx,     // (nb_keep,) or (B, nb_keep)
                            const float* __restrict__ scale,  // like idx, or null
                            float* __restrict__ y,           // (B, d) f32
                            int B, int d, int bs, int nbk, int rows_per_cta, int list_stride) {
  __shared__ float red[kSlices][kRows][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const int r0 = blockIdx.y * rows_per_cta;
  const int rows = min(rows_per_cta, B - r0);
  const bool valid = col < d;
  const int* lst = idx + (size_t)r0 * list_stride;
  const float* sc = scale != nullptr ? scale + (size_t)r0 * list_stride : nullptr;
  const size_t hstride = (size_t)nbk * bs;

  float yacc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) yacc[r] = 0.f;

  for (int i = 0; i < nbk; ++i) {  // list order: the sum is deterministic
    const int blk = lst[i];
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    if (valid) {
      for (int c = ty; c < bs; c += kSlices) {
        const float w = to_f(w_down[((size_t)blk * bs + c) * d + col]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) part[r] += to_f(hbuf[(size_t)(r0 + r) * hstride + (size_t)i * bs + c]) * w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[ty][r][tx] = part[r];
    __syncthreads();
    if (ty == 0) {
      const float s = sc != nullptr ? sc[i] : 1.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float contrib = 0.f;
        for (int sl = 0; sl < kSlices; ++sl) contrib += red[sl][r][tx];
        yacc[r] += s * contrib;  // s == 0.0 adds an exact zero
      }
    }
    __syncthreads();
  }
  if (ty == 0 && valid) {
    for (int r = 0; r < rows; ++r) y[(size_t)(r0 + r) * d + col] = yacc[r];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                   const int* idx, const float* scale, void* hbuf, float* y, int B, int d, int m,
                   int bs, int nbk, int rowwise, int act, cudaStream_t stream) {
  const int rows_per_cta = rowwise ? 1 : kRows;
  const int list_stride = rowwise ? nbk : 0;
  const int row_groups = (B + rows_per_cta - 1) / rows_per_cta;
  const dim3 block(kCols, kSlices);
  const dim3 grid1(nbk * ((bs + kCols - 1) / kCols), row_groups);
  hidden_kernel<T><<<grid1, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_gate), static_cast<const T*>(w_up), idx,
      static_cast<T*>(hbuf), B, d, m, bs, nbk, rows_per_cta, list_stride, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((d + kCols - 1) / kCols, row_groups);
  down_kernel<T><<<grid2, block, 0, stream>>>(static_cast<const T*>(hbuf),
                                              static_cast<const T*>(w_down), idx, scale, y, B, d,
                                              bs, nbk, rows_per_cta, list_stride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rowwise: 0 = one shared list, 1 = one
// list per row.  w_gate and block_scale may be null.  hbuf is the caller's
// (B, nb_keep * bs) scratch in the weight dtype.  Returns the cudaError_t
// of the launches (0 = success); the wrapper raises otherwise.
extern "C" int glass_ffn(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                         const void* block_idx, const void* block_scale, void* hbuf, void* y,
                         int B, int d, int m, int bs, int nbk, int rowwise, int act, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(block_idx);
  const float* sc = static_cast<const float*>(block_scale);
  float* out = static_cast<float*>(y);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, w_gate, w_up, w_down, idx, sc, hbuf, out, B, d, m, bs, nbk, rowwise,
                        act, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, w_gate, w_up, w_down, idx, sc, hbuf, out, B, d, m, bs, nbk,
                                rowwise, act, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
