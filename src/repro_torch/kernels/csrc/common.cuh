// Helpers shared by the port's streaming kernels (fused_aggregate.cu,
// fused_memory.cu, relay_block.cu): element widening, 16-byte column
// loads, the alignment test that picks the vector path, the column-block
// grid, and the weighted row reduction of the aggregation kernels.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// V consecutive elements at p, widened to f32: one 16-byte load on the
// vector path (V * sizeof(T) == 16, p 16-byte aligned), else one element.
template <typename T, int V>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float (&x)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(e[k]);
  } else {
    static_assert(V == 1, "the scalar path loads one element");
    x[0] = to_f32(p[0]);
  }
}

// Rows of x are 16-byte aligned when the base is and a row is a whole
// number of 16-byte words.
template <typename T>
bool rows_aligned(const void* x, int64_t d) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (d * static_cast<int64_t>(sizeof(T))) % 16 == 0;
}

dim3 grid_for(int64_t d, int64_t block_d) {
  return dim3(static_cast<unsigned>((d + block_d - 1) / block_d));
}

// out[c] = sum_j w[j] * x[j, c] over this block's columns
// [blockIdx.x * block_d, min((blockIdx.x + 1) * block_d, d)).
template <typename T, int V>
__device__ __forceinline__ void weighted_rows(const float* __restrict__ w,
                                              const T* __restrict__ x,
                                              float* __restrict__ out, int n,
                                              int64_t d, int64_t block_d) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * block_d;
  const int64_t c1 = c0 + block_d < d ? c0 + block_d : d;
  const int64_t step = static_cast<int64_t>(blockDim.x) * V;
  for (int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * V; c < c1; c += step) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float xv[V];
      load_cols<T, V>(x + static_cast<int64_t>(j) * d + c, xv);
      const float wj = w[j];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, xv[k]));
    }
    if constexpr (V % 4 == 0) {
      float4* o = reinterpret_cast<float4*>(out + c);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) out[c + k] = acc[k];
    }
  }
}

}  // namespace
