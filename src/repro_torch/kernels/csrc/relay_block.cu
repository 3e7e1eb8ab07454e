// Block-sparse clustered relaying kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/relay_block.py:
//   block_relay_mix_pallas      (pallas_call at line 71)  -> relay_mix_kernel<T, false>
//     out_c = (A_c * tau_c^T) @ X_c            per cluster c, (n, d) in X's dtype
//   block_fused_aggregate_pallas (pallas_call at line 137) -> block_collapse_kernel,
//                                                              then block_stream_kernel
//     out = (1/n) sum_c tau_up_c @ ((A_c * tau_c^T) @ X_c)        (d,) f32
//   block_row_stream_pallas     (pallas_call at line 190) -> block_stream_kernel
//     out = sum_c w_c @ X_c                                        (d,) f32
// and of src/repro/kernels/relay_mix.py:
//   relay_mix_pallas            (pallas_call at line 54)  -> relay_mix_kernel<T, true>
//     out = M @ X with the (n, n) mask M given: the C = 1 case of the first.
// X is an (n, d) = (C*m, d) row-major stack (f32 or bf16); A, tau are the
// (C, m, m) per-cluster relay weights and D2D realizations, tau_up (n,).
//
// What bounds them: bytes.  The aggregations read X once and write (d,):
// n*d*elt + 4*d bytes against 2*n*d flops (plus n*m for the collapse).  At
// n=10, d=272,282 f32 that is 11.98 MB, 3.58 us at 3.35 TB/s.  The relay
// mixes read X once and write (n, d): 2*n*d*elt bytes against 2*n*m*d
// flops, far below the f32 ridge for m <= 64 (21.78 MB, 6.50 us at n=10,
// d=272,282 f32; 134.2 MB, 40.1 us for relay_mix at n=16, d=2^20 f32).
//
// What the design does about it:
// * No sequential grid.  The Pallas aggregation carries its output tile
//   across an innermost cluster axis that runs in order on the TPU core.
//   GPU blocks run in parallel, so here each thread owns columns and loops
//   over all n rows of the stack itself, in global row order: clusters are
//   consecutive row ranges, so sum_c w_c @ X_c is one weighted row sum with
//   the per-cluster rows laid end to end.  No atomics.
// * Collapse once.  Kernel 1 recomputes its (n,) weight row in every block
//   (n^2 MACs); blocked, that would be n*m MACs and 2*n*m floats of blocks
//   per block (8 MB at n=2^14, m=64).  block_collapse_kernel instead writes
//   w_flat[c*m + j] = inv_n * sum_i tau_up[c*m+i] * (A_c[i,j] * tau_c[j,i])
//   once, one thread per client, and the streaming pass reads it through
//   the cache: the row is never staged in shared memory, so n is not bound
//   by it (n = 16,384 with m = 64 runs).
// * The two launches overlap (programmatic dependent launch): the stream
//   is launched with programmatic stream serialization, the collapse lets
//   it start at once (griddepcontrol.launch_dependents), and each stream
//   block requests its first X loads before griddepcontrol.wait, which
//   returns once the collapse has finished and its w is visible.  Kernel 9
//   launches the same stream on its own, and the wait returns at once.
// * The streaming pass is the row reduction of kernels 1-2 (common.cuh's
//   weighted_rows): all of a thread's rows in flight before its first add,
//   a grid sized so every block is resident at once, 16-byte loads when
//   the rows are 16-byte aligned, else the scalar path.
// * The relay mixes give each block one cluster's (m, m) mask in shared
//   memory (computed as A_c * tau_c^T, or copied when given) and a range of
//   columns, one column per thread.  A thread sums 16 output rows at a time
//   in registers over j = 0..m-1 in order, re-reading x[:, col] from L1 for
//   each group of 16, so device memory sees X once.  m*m floats must fit
//   the 48 KB a launch gets without opting in: m <= 110 (the wrappers raise
//   past it).
//
// Arithmetic: f32, products and sums rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction), sums in index order, the collapse scaled
// by a float inv_n.  The plain PyTorch versions in kernels/relay_block.py
// and kernels/relay_mix.py run the same operations in the same order, so
// kernels and plain versions agree to the bit.  With C = 1 the collapse and
// the stream are those of fused_aggregate_kernel, so block_fused_aggregate
// equals fused_aggregate to the bit, and block_row_stream equals
// row_stream.
//
// Each launcher returns cudaGetLastError(); the kernels allocate nothing.

#include "common.cuh"

namespace {

constexpr int kRowGroup = 16;  // output rows a relay-mix thread sums at once

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// w[c*m + j] = inv_n * sum_i tau_up[c*m + i] * (A[c, i, j] * tau[c, j, i]), i in order.
// It lets the stream behind it launch at once (programmatic dependent
// launch): the stream's blocks request their first X loads while this runs.
__global__ void __launch_bounds__(kThreads)
block_collapse_kernel(const float* __restrict__ A, const float* __restrict__ tau_up,
                      const float* __restrict__ tau, float* __restrict__ w, int n, int m,
                      float inv_n) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int c = k / m, j = k - c * m;
  const float* Ac = A + static_cast<int64_t>(c) * m * m;
  const float* tc = tau + static_cast<int64_t>(c) * m * m;
  const float* uc = tau_up + static_cast<int64_t>(c) * m;
  float s = 0.0f;
  for (int i = 0; i < m; ++i) {
    const float mij = __fmul_rn(Ac[i * m + j], tc[j * m + i]);
    s = __fadd_rn(s, __fmul_rn(uc[i], mij));
  }
  w[k] = __fmul_rn(s, inv_n);
}

// griddepcontrol.wait returns once the collapse kernel ahead of it has
// finished and its w is visible; launched on its own (kernel 9, w given),
// there is nothing to wait for and it returns at once.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
block_stream_kernel(const float* __restrict__ w, const T* __restrict__ x,
                    float* __restrict__ out, int n, int64_t d, int64_t cols) {
  weighted_rows<T, V>(w, x, out, n, d, cols,
                      [] { asm volatile("griddepcontrol.wait;" ::: "memory"); });
}

// out[c*m + i, col] = sum_j mask_c[i, j] * x[c*m + j, col], j in order;
// blockIdx.y is the cluster, blockIdx.x a range of kThreads columns.
template <typename T, bool kGivenMask>
__global__ void __launch_bounds__(kThreads)
relay_mix_kernel(const float* __restrict__ A, const float* __restrict__ tau,
                 const T* __restrict__ x, T* __restrict__ out, int m, int64_t d) {
  extern __shared__ float mask[];
  const int c = blockIdx.y;
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int k = threadIdx.x; k < m * m; k += blockDim.x) {
    if constexpr (kGivenMask) {
      mask[k] = A[k];
    } else {
      const int i = k / m, j = k - i * m;
      mask[k] = __fmul_rn(A[c * mm + k], tau[c * mm + j * m + i]);
    }
  }
  __syncthreads();
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const T* xc = x + static_cast<int64_t>(c) * m * d + col;
  T* oc = out + static_cast<int64_t>(c) * m * d + col;
  for (int i0 = 0; i0 < m; i0 += kRowGroup) {
    float acc[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) acc[r] = 0.0f;
    for (int j = 0; j < m; ++j) {
      float xv[1];
      load_cols<T, 1>(xc + static_cast<int64_t>(j) * d, xv);
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r)
        if (i0 + r < m) acc[r] = __fadd_rn(acc[r], __fmul_rn(mask[(i0 + r) * m + j], xv[0]));
    }
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
      if (i0 + r < m) store_f32(oc + static_cast<int64_t>(i0 + r) * d, acc[r]);
  }
}

// The stream, launched behind the collapse with programmatic stream
// serialization (dependent) or on its own.
template <typename T, int V>
cudaError_t launch_stream_v(const float* w, const T* x, float* out, int n, int64_t d,
                            int64_t block_d, bool dependent, cudaStream_t stream) {
  const int64_t cols =
      stream_cols(d, block_d, V, resident_blocks((const void*)block_stream_kernel<T, V>, 0));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = stream_grid(d, cols);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, block_stream_kernel<T, V>, w, x, out, n, d, cols);
}

template <typename T>
cudaError_t launch_stream(const float* w, const void* x, float* out, int n, int64_t d,
                          int64_t block_d, bool dependent, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const cudaError_t err =
      rows_aligned<T>(x, d) ? launch_stream_v<T, V>(w, xt, out, n, d, block_d, dependent, stream)
                            : launch_stream_v<T, 1>(w, xt, out, n, d, block_d, dependent, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool kGivenMask>
cudaError_t launch_mix(const float* A, const float* tau, const void* x, void* out, int C,
                       int m, int64_t d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads), static_cast<unsigned>(C));
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  relay_mix_kernel<T, kGivenMask><<<grid, kThreads, smem, stream>>>(
      A, tau, static_cast<const T*>(x), static_cast<T*>(out), m, d);
  return cudaGetLastError();
}

}  // namespace

// Element type codes shared with kernels/relay_block.py and kernels/relay_mix.py.
enum : int { kF32 = 0, kBF16 = 1 };

extern "C" int repro_block_fused_aggregate(const float* A, const float* tau_up,
                                           const float* tau, const void* x, float* w,
                                           float* out, int C, int m, int64_t d,
                                           int64_t block_d, int dtype, float inv_n,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = C * m;
  block_collapse_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      A, tau_up, tau, w, n, m, inv_n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case kF32: return launch_stream<float>(w, x, out, n, d, block_d, true, s);
    case kBF16: return launch_stream<__nv_bfloat16>(w, x, out, n, d, block_d, true, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_block_row_stream(const float* w, const void* x, float* out, int n,
                                      int64_t d, int64_t block_d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_stream<float>(w, x, out, n, d, block_d, false, s);
    case kBF16: return launch_stream<__nv_bfloat16>(w, x, out, n, d, block_d, false, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_block_relay_mix(const float* A, const float* tau, const void* x,
                                     void* out, int C, int m, int64_t d, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_mix<float, false>(A, tau, x, out, C, m, d, s);
    case kBF16: return launch_mix<__nv_bfloat16, false>(A, tau, x, out, C, m, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_relay_mix(const float* mix, const void* x, void* out, int n, int64_t d,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_mix<float, true>(mix, nullptr, x, out, 1, n, d, s);
    case kBF16: return launch_mix<__nv_bfloat16, true>(mix, nullptr, x, out, 1, n, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
