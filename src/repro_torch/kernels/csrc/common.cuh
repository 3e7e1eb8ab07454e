// Helpers shared by the port's streaming kernels (fused_aggregate.cu,
// fused_memory.cu): element widening, 16-byte column loads, the
// alignment test that picks the vector path, and the column-block grid.
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

}  // namespace
