// ColRel PS aggregation kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_aggregate.py:
//   fused_aggregate_pallas (pallas_call at line 79)  -> fused_aggregate_kernel
//     out = (1/n) tau_up @ ((A * tau_dd^T) @ X)
//   row_stream_pallas      (pallas_call at line 122) -> row_stream_kernel
//     out = w @ X, over a list of segments in one launch
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
// * The stream is common.cuh's weighted_rows: a thread's loads of up to 12
//   rows go out before its first add, the collapse into shared memory runs
//   while they are in flight, and the grid is sized from d and the
//   kernel's occupancy so that every block is resident at once (at most
//   block_d columns a block).  row_stream reads its given w through the
//   cache.
// * No host-side padding: each block masks its ragged last columns.
// * row_stream_kernel takes the round's segment list (common.cuh's segment
//   table): the segmented colrel and quantized paths make one launch a
//   round over their 61 leaves where they made 61, each ~6 us of launch and
//   latency for at most 1.5 MB.  Each block streams its segment's columns
//   with weighted_rows into the segment's columns of the round's (d,)
//   delta; a segment takes the 16-byte path when its rows are aligned (the
//   10-wide fc bias takes the scalar one), and writes its outputs one
//   element at a time where its first column of the delta is not 16-byte
//   aligned (every leaf after that bias).  Each output column depends on
//   its own input column only, so the grouped launch gives the per-segment
//   and the monolithic results to the bit.  A single segment is a table of
//   one entry.
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
                       float* __restrict__ out, int n, int64_t d, int64_t cols,
                       float inv_n) {
  extern __shared__ float w[];
  weighted_rows<T, V>(w, x, out, n, d, cols, blockIdx.x, [&] {
    collapse_row(A, tau_up, tau_dd, nullptr, w, n, inv_n);
    __syncthreads();
  });
}

// The quantized path's twin: the per-row dequant scales fold into the
// weight row in shared memory (ws_j = w_j * scale_j), so the int8 stack is
// read as it is and no f32 stack exists.
template <int V>
__global__ void __launch_bounds__(kThreads)
fused_dequant_kernel(const float* __restrict__ A, const float* __restrict__ tau_up,
                     const float* __restrict__ tau_dd, const float* __restrict__ scale,
                     const int8_t* __restrict__ q, float* __restrict__ out, int n,
                     int64_t d, int64_t cols, float inv_n) {
  extern __shared__ float w[];
  weighted_rows<int8_t, V>(w, q, out, n, d, cols, blockIdx.x, [&] {
    collapse_row(A, tau_up, tau_dd, scale, w, n, inv_n);
    __syncthreads();
  });
}

// One segment of the round: its (n, d) stack, rows contiguous, and its first
// column in out.
struct RowSegment {
  const void* x;
  int64_t d;
  int64_t off;
  int32_t first_block;
  int32_t vec;  // rows 16-byte aligned: the 16-byte path
};

struct RowSegments {
  int32_t count;
  int64_t cols;
  RowSegment seg[kMaxSegments];
};

// The weight row is given: it is read through the cache, not staged.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
row_stream_kernel(const float* __restrict__ w, float* __restrict__ out, int n,
                  const __grid_constant__ RowSegments tab) {
  const RowSegment& s = tab.seg[find_segment(tab)];
  const T* x = static_cast<const T*>(s.x);
  const int64_t block = static_cast<int64_t>(blockIdx.x) - s.first_block;
  if (s.vec)
    weighted_rows<T, V>(w, x, out + s.off, n, s.d, tab.cols, block, [] {});
  else
    weighted_rows<T, 1>(w, x, out + s.off, n, s.d, tab.cols, block, [] {});
}

template <typename T>
cudaError_t launch_fused(const float* A, const float* tau_up, const float* tau_dd,
                         const void* x, float* out, int n, int64_t d, int64_t block_d,
                         float inv_n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  if (rows_aligned<T>(x, d)) {
    const int64_t cols = stream_cols(
        d, block_d, V, resident_blocks((const void*)fused_aggregate_kernel<T, V>, smem));
    fused_aggregate_kernel<T, V><<<stream_grid(d, cols), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, xt, out, n, d, cols, inv_n);
  } else {
    const int64_t cols = stream_cols(
        d, block_d, 1, resident_blocks((const void*)fused_aggregate_kernel<T, 1>, smem));
    fused_aggregate_kernel<T, 1><<<stream_grid(d, cols), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, xt, out, n, d, cols, inv_n);
  }
  return cudaGetLastError();
}

// table: count rows of (x pointer, d); the segments' outputs follow each
// other in out.
template <typename T>
cudaError_t launch_row_stream(const float* w, const int64_t* table, int count, float* out,
                              int n, int64_t block_d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (count < 1 || count > kMaxSegments) return cudaErrorInvalidValue;
  RowSegments tab{};
  tab.count = count;
  int64_t total = 0;
  bool any_vec = false;
  for (int s = 0; s < count; ++s) {
    RowSegment& e = tab.seg[s];
    e.x = reinterpret_cast<const void*>(table[2 * s]);
    e.d = table[2 * s + 1];
    e.off = total;
    e.vec = rows_aligned<T>(e.x, e.d);
    any_vec = any_vec || e.vec;
    total += e.d;
  }
  // the stream's width over the total columns, for a card that holds
  // `resident` blocks less one partial block a segment
  const int64_t resident = resident_blocks((const void*)row_stream_kernel<T, V>, 0);
  const int64_t blocks = place_segments(
      tab, stream_cols(total, block_d, any_vec ? V : 1, resident > count ? resident - count
                                                                          : resident));
  row_stream_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(w, out, n, tab);
  return cudaGetLastError();
}

cudaError_t launch_dequant(const float* A, const float* tau_up, const float* tau_dd,
                           const float* scale, const int8_t* q, float* out, int n, int64_t d,
                           int64_t block_d, float inv_n, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  if (rows_aligned<int8_t>(q, d)) {
    const int64_t cols = stream_cols(
        d, block_d, 16, resident_blocks((const void*)fused_dequant_kernel<16>, smem));
    fused_dequant_kernel<16><<<stream_grid(d, cols), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, scale, q, out, n, d, cols, inv_n);
  } else {
    const int64_t cols = stream_cols(
        d, block_d, 1, resident_blocks((const void*)fused_dequant_kernel<1>, smem));
    fused_dequant_kernel<1><<<stream_grid(d, cols), kThreads, smem, stream>>>(
        A, tau_up, tau_dd, scale, q, out, n, d, cols, inv_n);
  }
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

extern "C" int repro_row_stream(const float* w, const int64_t* table, int count, float* out,
                                int n, int64_t block_d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_row_stream<float>(w, table, count, out, n, block_d, s);
    case kBF16: return launch_row_stream<__nv_bfloat16>(w, table, count, out, n, block_d, s);
    case kI8: return launch_row_stream<int8_t>(w, table, count, out, n, block_d, s);
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
