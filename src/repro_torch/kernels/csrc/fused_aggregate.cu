// ColRel PS aggregation kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_aggregate.py:
//   fused_aggregate_pallas (pallas_call at line 79)  -> fused_aggregate_kernel
//     out = (1/n) tau_up @ ((A * tau_dd^T) @ X)
//   row_stream_pallas      (pallas_call at line 122) -> row_stream_kernel
//     out = w @ X
// and of src/repro/kernels/fused_dequant.py:
//   fused_dequant_aggregate_pallas (pallas_call at line 90) -> fused_dequant_kernel
//     out = ((1/n) tau_up @ (A * tau_dd^T) * scale^T) @ Q
// X is an (n, d) row-major stack (f32 or bf16; row_stream also int8, and
// the dequant kernel takes the int8 wire stack Q with one f32 scale per
// row) and out is (d,) f32.  All three reduce the stack over its n rows
// with one weight row while streaming the d columns, so every output
// column depends on its own input column only.
//
// What bounds them: bytes.  X is read once and out written once: n*d*elt
// + 4*d bytes against 2*n*d flops, far below the card's ~20 flops/byte
// f32 ridge.  At the main path's n=10, d=272,282 f32 that is 11.98 MB,
// 3.6 us at 3.35 TB/s; for the int8 stack of the quantized path 3.81 MB,
// 1.14 us.
//
// What the design does about it:
// * X crosses device memory exactly once.  Where the TPU kernel recomputes
//   the mask and the collapsed weight row per grid step in VMEM, each
//   block here recomputes w (O(n^2) flops) into shared memory and then
//   streams its column range; there is no second pass and no (n, d)
//   intermediate.
// * Loads are 16 bytes a thread (4 f32, 8 bf16 or 16 int8 columns) with
//   neighbouring threads on neighbouring addresses, whenever the rows are
//   16-byte aligned (d*elt % 16 == 0 and an aligned base).  Otherwise, as
//   for the 10-value fc bias, the kernel takes the scalar path.
// * The row loop is unrolled so that several rows' loads are in flight
//   per thread.
// * No host-side padding: each block masks its ragged last columns.
//
// Arithmetic: f32 accumulation in row order, products and sums rounded
// separately (__fmul_rn / __fadd_rn, no FMA contraction), w scaled by a
// float inv_n.  The plain PyTorch versions in kernels/fused_aggregate.py
// run the same operations in the same order, so kernel and plain version
// agree to the bit.
//
// Each launcher returns cudaGetLastError() so that a refused launch is
// reported by the Python wrapper.  The kernels allocate nothing.

#include "common.cuh"

namespace {

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

// w_j = inv_n * sum_i tau_up[i] * (A[i, j] * tau_dd[j, i]), i in order,
// then times scale[j] where a scale row is given.
__device__ __forceinline__ void collapse_row(const float* __restrict__ A,
                                             const float* __restrict__ tau_up,
                                             const float* __restrict__ tau_dd,
                                             const float* __restrict__ scale,
                                             float* __restrict__ w, int n, float inv_n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float m = __fmul_rn(A[i * n + j], tau_dd[j * n + i]);
      s = __fadd_rn(s, __fmul_rn(tau_up[i], m));
    }
    s = __fmul_rn(s, inv_n);
    w[j] = scale ? __fmul_rn(s, scale[j]) : s;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fused_aggregate_kernel(const float* __restrict__ A, const float* __restrict__ tau_up,
                       const float* __restrict__ tau_dd, const T* __restrict__ x,
                       float* __restrict__ out, int n, int64_t d, int64_t block_d,
                       float inv_n) {
  extern __shared__ float w[];
  collapse_row(A, tau_up, tau_dd, nullptr, w, n, inv_n);
  __syncthreads();
  weighted_rows<T, V>(w, x, out, n, d, block_d);
}

// The quantized path's twin: the per-row dequant scales fold into the
// weight row in shared memory (ws_j = w_j * scale_j), so the int8 stack is
// read as it is and no f32 stack exists.
template <int V>
__global__ void __launch_bounds__(kThreads)
fused_dequant_kernel(const float* __restrict__ A, const float* __restrict__ tau_up,
                     const float* __restrict__ tau_dd, const float* __restrict__ scale,
                     const int8_t* __restrict__ q, float* __restrict__ out, int n,
                     int64_t d, int64_t block_d, float inv_n) {
  extern __shared__ float w[];
  collapse_row(A, tau_up, tau_dd, scale, w, n, inv_n);
  __syncthreads();
  weighted_rows<int8_t, V>(w, q, out, n, d, block_d);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
row_stream_kernel(const float* __restrict__ w_in, const T* __restrict__ x,
                  float* __restrict__ out, int n, int64_t d, int64_t block_d) {
  extern __shared__ float w[];
  for (int j = threadIdx.x; j < n; j += blockDim.x) w[j] = w_in[j];
  __syncthreads();
  weighted_rows<T, V>(w, x, out, n, d, block_d);
}

template <typename T>
cudaError_t launch_fused(const float* A, const float* tau_up, const float* tau_dd,
                         const void* x, float* out, int n, int64_t d, int64_t block_d,
                         float inv_n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  if (rows_aligned<T>(x, d))
    fused_aggregate_kernel<T, V><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, xt, out, n, d, block_d, inv_n);
  else
    fused_aggregate_kernel<T, 1><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, xt, out, n, d, block_d, inv_n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_stream(const float* w, const void* x, float* out, int n, int64_t d,
                              int64_t block_d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  if (rows_aligned<T>(x, d))
    row_stream_kernel<T, V><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        w, xt, out, n, d, block_d);
  else
    row_stream_kernel<T, 1><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        w, xt, out, n, d, block_d);
  return cudaGetLastError();
}

cudaError_t launch_dequant(const float* A, const float* tau_up, const float* tau_dd,
                           const float* scale, const int8_t* q, float* out, int n, int64_t d,
                           int64_t block_d, float inv_n, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (rows_aligned<int8_t>(q, d))
    fused_dequant_kernel<16><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, scale, q, out, n, d, block_d, inv_n);
  else
    fused_dequant_kernel<1><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, scale, q, out, n, d, block_d, inv_n);
  return cudaGetLastError();
}

}  // namespace

// Element type codes shared with kernels/fused_aggregate.py.
enum : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

extern "C" int repro_fused_aggregate(const float* A, const float* tau_up, const float* tau_dd,
                                     const void* x, float* out, int n, int64_t d,
                                     int64_t block_d, int dtype, float inv_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_fused<float>(A, tau_up, tau_dd, x, out, n, d, block_d, inv_n, s);
    case kBF16: return launch_fused<__nv_bfloat16>(A, tau_up, tau_dd, x, out, n, d, block_d, inv_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_row_stream(const float* w, const void* x, float* out, int n, int64_t d,
                                int64_t block_d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_row_stream<float>(w, x, out, n, d, block_d, s);
    case kBF16: return launch_row_stream<__nv_bfloat16>(w, x, out, n, d, block_d, s);
    case kI8: return launch_row_stream<int8_t>(w, x, out, n, d, block_d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_fused_dequant_aggregate(const float* A, const float* tau_up,
                                             const float* tau_dd, const float* scale,
                                             const int8_t* q, float* out, int n, int64_t d,
                                             int64_t block_d, float inv_n, void* stream) {
  return launch_dequant(A, tau_up, tau_dd, scale, q, out, n, d, block_d, inv_n,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
