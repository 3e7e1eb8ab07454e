// Helpers shared by the port's streaming kernels (fused_aggregate.cu,
// fused_memory.cu, relay_block.cu): element widening, 16-byte column
// loads, the alignment test that picks the vector path, the weighted row
// stream of the aggregation kernels, the segment table of the kernels that
// run one launch over a round's segment list, and the grouped row stream
// that kernels 2 and 9 share.
//
// The stream is the row reduction out = w @ X of five TPU kernels: kernels
// 1, 2 and 6 (src/repro/kernels/fused_aggregate.py fused_aggregate_pallas
// and row_stream_pallas, fused_dequant.py fused_dequant_aggregate_pallas)
// and 8 and 9 (relay_block.py block_fused_aggregate_pallas and
// block_row_stream_pallas).  It is bound by bytes: the (n, d) stack read
// once and the (d,) row written, 11.98 MB at the main path's n = 10, d =
// 272,282 f32, 3.6 us at 3.35 TB/s.  Its first design unrolled the row loop
// by 4 over a grid of fused_block_d columns a block: at most four 16-byte
// loads in flight a thread, one wave of 133 blocks, 12-14% of the memory
// rate.  This one requests all n <= 12 rows' loads of a thread before the
// first add, overlaps the making of the weight row with them, and sizes the
// grid from d and the kernel's occupancy so that every block is resident
// from the start (weighted_rows and stream_cols below).
#pragma once

#include <cstdint>
#include <type_traits>
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

// -- the weighted row stream of kernels 1, 2, 6, 8 and 9 ----------------------
//
// out[c] = sum_j w[j] * x[j, c], j in order, over one block's columns.
//
// The stream is bound by bytes (n*d*elt read once, 4*d written), so what
// matters is how many bytes the card has in flight and that no block waits
// for a second wave.  A thread owns V columns (one 16-byte word a row on the
// vector path) and requests the loads of kRowBatch rows before it adds the
// first of them: at n <= kRowBatch every row of its columns is requested at
// once.  ready() runs once per block, by every thread, after the first batch
// is requested and before w is read: it is where the weight row is made (the
// collapse into shared memory and a barrier, or griddepcontrol.wait behind a
// collapse kernel), so that work overlaps the first loads.  stream_cols
// sizes the blocks from d and the kernel's occupancy so that every block is
// resident from the start.
//
// Products and sums are rounded on their own (__fmul_rn / __fadd_rn, no
// FMA contraction) in global row order, so the result does not depend on
// the column partition, the batch size or the grid: the plain versions,
// per-segment passes and the C = 1 clustered kernels agree to the bit.
constexpr int kRowBatch = 12;

template <typename T, int V>
struct RowWord {
  // one row's V columns as loaded: a 16- or 8-byte word, or one element
  using type = typename std::conditional<
      V == 1, T,
      typename std::conditional<V * sizeof(T) == 16, uint4, uint2>::type>::type;
};

template <typename T, int V>
__device__ __forceinline__ typename RowWord<T, V>::type load_word(const T* __restrict__ p) {
  using Word = typename RowWord<T, V>::type;
  if constexpr (V == 1) {
    return p[0];
  } else {
    static_assert(sizeof(Word) == V * sizeof(T), "a word is 8 or 16 bytes");
    return __ldg(reinterpret_cast<const Word*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void widen_word(const typename RowWord<T, V>::type& raw,
                                           float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(raw);
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(e[k]);
  }
}

// Rows [j0, j0 + kRowBatch) of column group c, rows past n left alone.
template <typename T, int V>
__device__ __forceinline__ void load_batch(typename RowWord<T, V>::type (&b)[kRowBatch],
                                           const T* __restrict__ x, int64_t c, int j0, int n,
                                           int64_t d) {
#pragma unroll
  for (int r = 0; r < kRowBatch; ++r)
    if (j0 + r < n) b[r] = load_word<T, V>(x + static_cast<int64_t>(j0 + r) * d + c);
}

template <typename T, int V>
__device__ __forceinline__ void add_batch(float (&acc)[V],
                                          const typename RowWord<T, V>::type (&b)[kRowBatch],
                                          const float* w, int j0, int n) {
#pragma unroll
  for (int r = 0; r < kRowBatch; ++r) {
    if (j0 + r < n) {
      float xv[V];
      widen_word<T, V>(b[r], xv);
      const float wj = w[j0 + r];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, xv[k]));
    }
  }
}

// V consecutive f32 outputs at p: 16-byte stores where p is 16-byte
// aligned, else one element at a time (a segment's columns of a round's
// (d,) delta start wherever the segments before it end).
template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
      float4* o = reinterpret_cast<float4*>(p);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        o[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = v[k];
}

// Columns [block * cols, min((block + 1) * cols, d)) of out = w @ x.
template <typename T, int V, typename Ready>
__device__ __forceinline__ void weighted_rows(const float* w, const T* __restrict__ x,
                                              float* __restrict__ out, int n, int64_t d,
                                              int64_t cols, int64_t block, Ready ready) {
  using Word = typename RowWord<T, V>::type;
  const int64_t c0 = block * cols;
  const int64_t c1 = c0 + cols < d ? c0 + cols : d;
  const int64_t step = static_cast<int64_t>(blockDim.x) * V;
  int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * V;
  Word rows[kRowBatch];
  if (c < c1) load_batch<T, V>(rows, x, c, 0, n, d);
  ready();
  for (bool first = true; c < c1; c += step, first = false) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += kRowBatch) {
      if (!first || j0 > 0) load_batch<T, V>(rows, x, c, j0, n, d);
      add_batch<T, V>(acc, rows, w, j0, n);
    }
    store_cols<V>(out + c, acc);
  }
}

// How many blocks of kThreads the card holds at once for this kernel with
// `smem` bytes of dynamic shared memory: its SM count times its occupancy.
inline int64_t resident_blocks(const void* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess || per_sm < 1)
    per_sm = 1;
  return static_cast<int64_t>(sms) * per_sm;
}

// The stream's columns a block: as few as give every resident block of the
// card a share (one wave, several blocks an SM), rounded up to a whole
// number of one warp's 16-byte passes (32*V columns) or, past one pass of
// the whole block, of block passes, so that no thread does more passes than
// another; never more than block_d (the reference's fused_block_d, an upper
// bound here).
inline int64_t stream_cols(int64_t d, int64_t block_d, int V, int64_t resident) {
  const int64_t share = (d + resident - 1) / resident;
  const int64_t unit = static_cast<int64_t>(share <= kThreads * V ? 32 : kThreads) * V;
  const int64_t cols = (share + unit - 1) / unit * unit;
  return cols < block_d ? cols : block_d;
}

inline dim3 stream_grid(int64_t d, int64_t cols) {
  return dim3(static_cast<unsigned>((d + cols - 1) / cols));
}

// -- one launch over a round's segment list (kernels 2, 4, 5 and 9) -----------
//
// The segmented paths stream a round's leaves (61 of them for cifar_cnn_full,
// 10 to 36,864 columns wide) as separate (n, d_i) tensors.  One launch covers
// them all: the launcher fills a table of the segments, passed by value as a
// __grid_constant__ kernel parameter (no copy to the device, no host sync),
// gives every segment ceil(d_i / cols) blocks of one column width `cols`
// (so blocks follow the columns), and each block finds its segment by a
// binary search of the segments' first blocks.  kMaxSegments entries keep
// the table and the kernels' other arguments inside the classic 4 KB of
// kernel parameters (no large-parameter support needed); the Python
// wrappers raise past it.
constexpr int kMaxSegments = 96;

// The segment (index into tab.seg) of this block: the last whose first block
// is at most blockIdx.x.  Every segment has at least one block.
template <typename Table>
__device__ __forceinline__ int find_segment(const Table& tab) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.seg[mid].first_block <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Each segment's first block, for blocks of `cols` columns (a table whose
// entries carry d and first_block); returns the grid's size.
template <typename Table>
int64_t place_segments(Table& tab, int64_t cols) {
  tab.cols = cols;
  int64_t blocks = 0;
  for (int s = 0; s < tab.count; ++s) {
    tab.seg[s].first_block = static_cast<int32_t>(blocks);
    blocks += (tab.seg[s].d + cols - 1) / cols;
  }
  return blocks;
}

// -- the grouped row stream (kernels 2 and 9) ----------------------------------
//
// out = w @ [x_0 | x_1 | ...] over a round's segments, one launch: the body
// of fused_aggregate.cu's row_stream_kernel (kernel 2) and relay_block.cu's
// block_row_segments_kernel (kernel 9, the (C, m) rows laid end to end as
// one (n,) row: clusters are consecutive row ranges).  The weight row is
// given and read through the cache, not staged, so n is not bound by
// shared memory.

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

template <typename T, int V>
__device__ __forceinline__ void segment_rows(const float* __restrict__ w,
                                             float* __restrict__ out, int n,
                                             const RowSegments& tab) {
  const RowSegment& s = tab.seg[find_segment(tab)];
  const T* x = static_cast<const T*>(s.x);
  const int64_t block = static_cast<int64_t>(blockIdx.x) - s.first_block;
  if (s.vec)
    weighted_rows<T, V>(w, x, out + s.off, n, s.d, tab.cols, block, [] {});
  else
    weighted_rows<T, 1>(w, x, out + s.off, n, s.d, tab.cols, block, [] {});
}

// Fills tab from `table`, count rows of (x pointer, d) whose outputs follow
// each other in out, for blocks of `kernel`; returns the grid's size, or 0
// for a count the table cannot take.  The stream's width is that of the
// total columns for a card that holds `resident` blocks less one partial
// block a segment.
template <typename T>
int64_t place_row_segments(RowSegments& tab, const int64_t* table, int count, int64_t block_d,
                           const void* kernel) {
  constexpr int V = 16 / sizeof(T);
  if (count < 1 || count > kMaxSegments) return 0;
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
  const int64_t resident = resident_blocks(kernel, 0);
  return place_segments(
      tab, stream_cols(total, block_d, any_vec ? V : 1, resident > count ? resident - count
                                                                          : resident));
}

}  // namespace
