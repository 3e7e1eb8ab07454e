// The memory strategy's select-accumulate-update for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_memory.py:
//   fused_memory_update_pallas (pallas_call at line 81)  -> fused_memory_kernel<..., true, ...>
//   memory_stream_pallas       (pallas_call at line 134) -> fused_memory_kernel<..., false, ...>
// Over the round's (n, d) update stack X (f32 or bf16) and the (n, d) f32
// replay buffer B:
//     tilde   = (A * tau_dd^T) @ X                      (ColRel D2D consensus)
//     contrib = tau_up * tilde + (1 - tau_up) * B       (select)
//     delta   = (1/n) sum_i contrib_i                   (accumulate, (d,) f32)
//     B      <- contrib                                 (update, in place)
// The first kernel computes the realized mask A * tau_dd^T itself; the
// segment-streaming twin receives it (the caller computes it once a
// round).  Both run over common.cuh's segment table: the monolithic update
// is a table of one entry (the whole stack), the segmented memory path one
// launch a round over its leaves' (n, d_i) segments, each writing the
// matching columns of the carried buffer (row stride d) and of the delta.
//
// What bounds them: bytes.  X and B are read once, contrib and delta
// written once: (elt + 12) * n * d + 4 * d bytes against 2 n^2 d + 4 n d
// flops.  At the main path's n=10, d=272,282 f32 that is 33.76 MB, 10.08 us
// at 3.35 TB/s; the flops (54.5 MFLOP) take 0.8 us at the f32 rate.
//
// What the design does about it.  The first design walked the n output
// rows of a column and loaded B[i, c] only after storing row i - 1 (B is
// written in place, so it cannot be __restrict__ and the compiler could
// not hoist the loads): n dependent round trips to device memory a column
// pass, over a grid of fused_block_d columns a block (18 blocks for a
// 36,864-wide leaf on 132 SMs), one launch per leaf.  Now:
// * A thread requests every load of its columns before its first add: the
//   n rows of X and the n rows of B at n <= kRowBatch (12; the main path's
//   n is 10), in batches of kRowBatch rows past it.  B is read whole into
//   registers before the first write-back; the thread owns those columns,
//   so the in-place update stays safe and no copy of the buffer is made.
//   The mask and the selector are built in shared memory while the first
//   loads are in flight.
// * One launch covers the round's segments (common.cuh's segment table).
//   A block takes one pass of its threads over its columns (512 on the
//   pair path, 256 on the scalar one, at most block_d), so no thread waits
//   on a second round trip of its own; the grid holds about two waves at
//   the main path's size.  A one-wave grid sized from occupancy
//   (stream_cols) gave each thread two or three passes and was slower.
// * tilde never reaches device memory, and the (n, n) mask and the uplink
//   selector live in shared memory: (n^2 + 2n) floats within the 48 KB a
//   launch gets without opting in, so n <= 109 (the Python wrapper raises
//   past it).
// * Loads: the carried buffer's rows (272,282 floats) are not whole 16-byte
//   words, but they are whole 8-byte ones, as is every leaf's first column
//   of cifar_cnn_full (all widths are even).  So where a segment allows it
//   (n <= kRowBatch, d and both row strides even, X, B and the delta 2-
//   element aligned) a thread owns two neighbouring columns and moves every
//   operand as one 2-element word a row: X 8 bytes of f32 or 4 of bf16,
//   B and contrib 8 bytes, the delta 8 bytes.  A warp's word loads of one
//   row cover 256 contiguous bytes of f32.  Otherwise a thread owns one
//   column and every access is a coalesced scalar.  Four columns a thread
//   (X as 16-byte words, B as scalars) needed 128 registers and spilled;
//   two take 96-98 and no spills.  The launch instantiates the pair body
//   only when a segment takes it.
//
// Arithmetic: f32, products and sums rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction), tilde summed over j in order, delta
// summed over i in order and scaled by a float inv_n.  The plain PyTorch
// versions in kernels/fused_memory.py run the same operations in the same
// order, so kernel, plain version, segmented and monolithic runs agree to
// the bit, whichever body a column takes.
//
// Each launcher returns cudaGetLastError(); the kernels allocate nothing.

#include "common.cuh"

namespace {

// One segment: its (n, d) update columns at row stride ldx, and its first
// column in the buffer and in the delta.
struct MemSegment {
  const void* x;
  int64_t ldx;
  int64_t d;
  int64_t off;
  int32_t first_block;
  int32_t pairs;  // two columns a thread, every operand as 2-element words
};

struct MemSegments {
  int32_t count;
  int64_t cols;
  MemSegment seg[kMaxSegments];
};

// Two consecutive elements of a row of X as one load: 8 bytes of f32, 4 of
// bf16.
template <typename T>
struct PairWord;
template <>
struct PairWord<float> {
  using type = uint2;
};
template <>
struct PairWord<__nv_bfloat16> {
  using type = unsigned int;
};

template <typename T>
__device__ __forceinline__ float2 widen_pair(const typename PairWord<T>::type& raw) {
  const T* e = reinterpret_cast<const T*>(&raw);
  return make_float2(to_f32(e[0]), to_f32(e[1]));
}

// contrib = t * tilde + (1 - t) * b
__device__ __forceinline__ float contrib_of(float ti, float oti, float tilde, float b) {
  return __fadd_rn(__fmul_rn(ti, tilde), __fmul_rn(oti, b));
}

// n <= kRowBatch, two columns a thread, X, B and the delta as 2-element
// words: all n words of X and of B in registers before the first add.
template <typename T, typename Ready>
__device__ __forceinline__ void rows_in_pairs(const float* m, const float* t, const float* omt,
                                              const T* __restrict__ x, int64_t ldx, float* buf,
                                              int64_t ldb, float* __restrict__ delta, int n,
                                              int64_t c0, int64_t c1, float inv_n, Ready ready) {
  using Word = typename PairWord<T>::type;
  const int64_t step = static_cast<int64_t>(blockDim.x) * 2;
  int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * 2;
  Word xw[kRowBatch];
  float2 bv[kRowBatch];
  auto load = [&] {
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r)
      if (r < n) xw[r] = __ldg(reinterpret_cast<const Word*>(x + r * ldx + c));
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r)
      if (r < n) bv[r] = *reinterpret_cast<const float2*>(buf + r * ldb + c);
  };
  if (c < c1) load();
  ready();
  for (bool first = true; c < c1; c += step, first = false) {
    if (!first) load();
    float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      if (i < n) {
        float2 tl = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j) {
          if (j < n) {
            const float2 xv = widen_pair<T>(xw[j]);
            const float mij = m[i * n + j];
            tl.x = __fadd_rn(tl.x, __fmul_rn(mij, xv.x));
            tl.y = __fadd_rn(tl.y, __fmul_rn(mij, xv.y));
          }
        }
        const float2 v = make_float2(contrib_of(t[i], omt[i], tl.x, bv[i].x),
                                     contrib_of(t[i], omt[i], tl.y, bv[i].y));
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        *reinterpret_cast<float2*>(buf + i * ldb + c) = v;
      }
    }
    *reinterpret_cast<float2*>(delta + c) =
        make_float2(__fmul_rn(acc.x, inv_n), __fmul_rn(acc.y, inv_n));
  }
}

// One column a thread, any n: output rows in batches of kRowBatch, each
// batch's B requested at once (with the first batch of X), X in batches of
// kRowBatch rows, from the cache after the first output batch.  At n <=
// kRowBatch every load of the column is requested before the first add.
template <typename T, typename Ready>
__device__ __forceinline__ void rows_batched(const float* m, const float* t, const float* omt,
                                             const T* __restrict__ x, int64_t ldx, float* buf,
                                             int64_t ldb, float* __restrict__ delta, int n,
                                             int64_t c0, int64_t c1, float inv_n, Ready ready) {
  const int64_t step = blockDim.x;
  int64_t c = c0 + threadIdx.x;
  float bv[kRowBatch];
  T xw[kRowBatch];
  auto load_b = [&](int i0) {
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r)
      if (i0 + r < n) bv[r] = buf[(i0 + r) * ldb + c];
  };
  auto load_x = [&](int j0) {
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r)
      if (j0 + r < n) xw[r] = x[(j0 + r) * ldx + c];
  };
  if (c < c1) {
    load_b(0);
    load_x(0);
  }
  ready();
  for (bool first = true; c < c1; c += step, first = false) {
    float acc = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kRowBatch) {
      if (!first || i0 > 0) load_b(i0);
      float tl[kRowBatch];
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) tl[r] = 0.0f;
      for (int j0 = 0; j0 < n; j0 += kRowBatch) {
        if (!first || i0 > 0 || j0 > 0) load_x(j0);
#pragma unroll
        for (int r = 0; r < kRowBatch; ++r) {
          if (i0 + r < n) {
            const float* mi = m + (i0 + r) * n + j0;
#pragma unroll
            for (int q = 0; q < kRowBatch; ++q)
              if (j0 + q < n) tl[r] = __fadd_rn(tl[r], __fmul_rn(mi[q], to_f32(xw[q])));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowBatch; ++r) {
        if (i0 + r < n) {
          const float v = contrib_of(t[i0 + r], omt[i0 + r], tl[r], bv[r]);
          acc = __fadd_rn(acc, v);
          buf[(i0 + r) * ldb + c] = v;
        }
      }
    }
    delta[c] = __fmul_rn(acc, inv_n);
  }
}

// Shared memory: the (n, n) mask m, then tau_up t and 1 - tau_up.  kPairs:
// some segment of the launch takes the two-column body.
template <typename T, bool kMaskFromA, bool kPairs>
__global__ void __launch_bounds__(kThreads)
fused_memory_kernel(const float* __restrict__ A, const float* __restrict__ tau_dd,
                    const float* __restrict__ mix, const float* __restrict__ tau_up, float* buf,
                    int64_t ldb, float* __restrict__ delta, int n, float inv_n,
                    const __grid_constant__ MemSegments tab) {
  extern __shared__ float smem[];
  float* m = smem;
  float* t = smem + n * n;
  float* omt = t + n;
  auto ready = [&] {
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      if constexpr (kMaskFromA) {
        const int i = e / n, j = e % n;
        m[e] = __fmul_rn(A[e], tau_dd[j * n + i]);  // m[i, j] = A[i, j] * tau_dd[j, i]
      } else {
        m[e] = mix[e];
      }
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      t[i] = tau_up[i];
      omt[i] = __fsub_rn(1.0f, tau_up[i]);
    }
    __syncthreads();
  };
  const MemSegment& s = tab.seg[find_segment(tab)];
  const T* x = static_cast<const T*>(s.x);
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) - s.first_block) * tab.cols;
  const int64_t c1 = c0 + tab.cols < s.d ? c0 + tab.cols : s.d;
  if (kPairs && s.pairs)
    rows_in_pairs<T>(m, t, omt, x, s.ldx, buf + s.off, ldb, delta + s.off, n, c0, c1, inv_n,
                     ready);
  else
    rows_batched<T>(m, t, omt, x, s.ldx, buf + s.off, ldb, delta + s.off, n, c0, c1, inv_n,
                    ready);
}

// table: count rows of (x pointer, row stride, d); the segments' columns
// follow each other in buf and delta.
template <typename T, bool kMaskFromA>
cudaError_t launch_memory(const float* A, const float* tau_dd, const float* mix,
                          const float* tau_up, const int64_t* table, int count, float* buf,
                          int64_t ldb, float* delta, int n, int64_t block_d, float inv_n,
                          cudaStream_t stream) {
  if (count < 1 || count > kMaxSegments) return cudaErrorInvalidValue;
  MemSegments tab{};
  tab.count = count;
  int64_t total = 0;
  bool pairs = false;
  for (int s = 0; s < count; ++s) {
    MemSegment& e = tab.seg[s];
    e.x = reinterpret_cast<const void*>(table[3 * s]);
    e.ldx = table[3 * s + 1];
    e.d = table[3 * s + 2];
    e.off = total;
    e.pairs = n <= kRowBatch && e.d % 2 == 0 && e.ldx % 2 == 0 && ldb % 2 == 0 &&
              reinterpret_cast<uintptr_t>(e.x) % (2 * sizeof(T)) == 0 &&
              reinterpret_cast<uintptr_t>(buf + e.off) % 8 == 0 &&
              reinterpret_cast<uintptr_t>(delta + e.off) % 8 == 0;
    pairs = pairs || e.pairs;
    total += e.d;
  }
  // one pass of the block's threads over its columns (at most block_d)
  const int64_t cols = static_cast<int64_t>(kThreads) * (pairs ? 2 : 1);
  const int64_t blocks = place_segments(tab, cols < block_d ? cols : block_d);
  const size_t smem = static_cast<size_t>(n) * (n + 2) * sizeof(float);
  if (pairs)
    fused_memory_kernel<T, kMaskFromA, true>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(A, tau_dd, mix, tau_up, buf,
                                                                    ldb, delta, n, inv_n, tab);
  else
    fused_memory_kernel<T, kMaskFromA, false>
        <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(A, tau_dd, mix, tau_up, buf,
                                                                    ldb, delta, n, inv_n, tab);
  return cudaGetLastError();
}

// Element type codes shared with kernels/fused_memory.py.
enum : int { kF32 = 0, kBF16 = 1 };

}  // namespace

extern "C" int repro_fused_memory_update(const float* A, const float* tau_up,
                                         const float* tau_dd, const void* x, int64_t ldx,
                                         float* buf, int64_t ldb, float* delta, int n,
                                         int64_t d, int64_t block_d, int dtype, float inv_n,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t table[3] = {static_cast<int64_t>(reinterpret_cast<uintptr_t>(x)), ldx, d};
  switch (dtype) {
    case kF32:
      return launch_memory<float, true>(A, tau_dd, nullptr, tau_up, table, 1, buf, ldb, delta,
                                        n, block_d, inv_n, s);
    case kBF16:
      return launch_memory<__nv_bfloat16, true>(A, tau_dd, nullptr, tau_up, table, 1, buf, ldb,
                                                delta, n, block_d, inv_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_memory_stream(const float* mix, const float* tau_up, const int64_t* table,
                                   int count, float* buf, int64_t ldb, float* delta, int n,
                                   int64_t block_d, int dtype, float inv_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_memory<float, false>(nullptr, nullptr, mix, tau_up, table, count, buf, ldb,
                                         delta, n, block_d, inv_n, s);
    case kBF16:
      return launch_memory<__nv_bfloat16, false>(nullptr, nullptr, mix, tau_up, table, count,
                                                 buf, ldb, delta, n, block_d, inv_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
