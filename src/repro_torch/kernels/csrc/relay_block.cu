// Block-sparse clustered relaying kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/relay_block.py:
//   block_relay_mix_pallas      (pallas_call at line 71)  -> relay_mix_kernel<T, false>
//     out_c = (A_c * tau_c^T) @ X_c            per cluster c, (n, d) in X's dtype
//   block_fused_aggregate_pallas (pallas_call at line 137) -> block_collapse_kernel,
//                                                              then block_stream_kernel
//     out = (1/n) sum_c tau_up_c @ ((A_c * tau_c^T) @ X_c)        (d,) f32
//   block_row_stream_pallas     (pallas_call at line 190) -> block_stream_kernel,
//                                                              and block_row_segments_kernel
//     out = sum_c w_c @ X_c                                        (d,) f32
//     (one segment, or a round's segment list in one launch)
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
//   launches the same stream on its own for one segment, and the wait
//   returns at once.
// * One launch a round for kernel 9.  The segmented clustered path streams
//   a round's 61 cifar_cnn_full leaves (10 to 36,864 columns, at most
//   1.5 MB each at n = 10); launched one by one, each paid ~6 us of launch,
//   ramp and tail.  block_row_segments_kernel takes the round's segment
//   list as common.cuh's segment table and runs kernel 2's grouped body
//   (segment_rows) with the (C, m) rows laid end to end as one (n,) row,
//   read through the cache, so n = 16,384 runs.  Each output column depends
//   on its own input column only, so the grouped launch equals the
//   per-segment kernel, kernel 8 and, at C = 1, the grouped kernel 2 to
//   the bit.
// * The streaming pass is the row reduction of kernels 1-2 (common.cuh's
//   weighted_rows): all of a thread's rows in flight before its first add,
//   a grid sized so every block is resident at once, 16-byte loads when
//   the rows are 16-byte aligned, else the scalar path.
// * The relay mixes (bytes above; their products, rounded one by one, are
//   2*n*m*d FP32 instructions, 537 M at n = 16, d = 2^20, ~18 us of issue
//   beside 40 us of bytes).  A thread requests the loads of a whole row
//   group before its first product: one 16-byte word a row (V consecutive
//   columns) when the rows of x and out are 16-byte aligned, else 4
//   scalars 32 columns apart (a warp's 128 columns in 4 coalesced loads a
//   row).  At m <= 16 all m rows stay in registers while 16 / V output rows
//   at a time are summed against the mask in shared memory, so each byte
//   of x is read once.  At m > 16 a thread takes 4 columns (an 8-byte word
//   in bf16) and sums R output rows at a time, streaming x in groups of 4
//   rows: ceil(m / R) passes over x, the later ones from L2 as far as the
//   resident blocks' rows fit there; R = 16 on the vector path and 8 on
//   the scalar one (3 blocks an SM instead of 2).  Stores are 16-byte (8-byte) streaming
//   stores (st.global.cs: the output is not read back), or coalesced
//   scalars.  The grid is one wave sized from the kernel's occupancy
//   (resident_blocks), each block's columns a whole number of a warp's
//   passes so that the blocks spread evenly over the SMs: blockIdx.y walks
//   the clusters and blockIdx.x a range of columns, so a block stages one
//   cluster's (m, m) mask (computed as A_c * tau_c^T, or copied when given)
//   and walks its columns.  m*m floats must fit the 48 KB a launch gets
//   without opting in: m <= 110 (the wrappers raise past it).
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
  weighted_rows<T, V>(w, x, out, n, d, cols, blockIdx.x,
                      [] { asm volatile("griddepcontrol.wait;" ::: "memory"); });
}

// Kernel 9 over a round's segment list (common.cuh's segment_rows).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
block_row_segments_kernel(const float* __restrict__ w, float* __restrict__ out, int n,
                          const __grid_constant__ RowSegments tab) {
  segment_rows<T, V>(w, out, n, tab);
}

// -- the relay mixes (kernels 3 and 7) ----------------------------------------
//
// out[c*m + i, col] = sum_j mask_c[i, j] * x[c*m + j, col], j in order, for
// the clusters c = blockIdx.y, blockIdx.y + gridDim.y, ... and the columns
// [blockIdx.x * cols, min((blockIdx.x + 1) * cols, d)).
constexpr int kMixBatch = 16;  // rows of x a thread holds in registers at m <= 16

// A thread's columns: a 16-byte word on the vector path at m <= 16, else 4.
template <typename T, bool kVec, bool kTall>
constexpr int kMixCols = kVec && !kTall ? static_cast<int>(16 / sizeof(T)) : 4;

// One row's V columns of a thread, as loaded.  The vector path (rows of x
// and out 16-byte aligned) takes V consecutive columns in one word of up to
// 16 bytes; the scalar path takes V columns 32 apart, so that a warp's 32*V
// columns are V coalesced loads a row and a thread has V loads a row in
// flight.
template <int kBytes>
struct WordOf;
template <>
struct WordOf<16> {
  using type = uint4;
};
template <>
struct WordOf<8> {
  using type = uint2;
};
template <>
struct WordOf<4> {
  using type = unsigned int;
};

template <typename T, bool kVec, int V>
struct MixRow;

template <typename T, int V>
struct MixRow<T, true, V> {
  using Word = typename WordOf<static_cast<int>(V * sizeof(T))>::type;
  Word w;
  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t, int64_t) {
    w = __ldg(reinterpret_cast<const Word*>(p));
  }
  __device__ __forceinline__ void widen(float (&x)[V]) const {
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(e[k]);
  }
};

template <typename T, int V>
struct MixRow<T, false, V> {
  static constexpr int kApart = 32;  // between a thread's columns
  T e[V];
  __device__ __forceinline__ void load(const T* __restrict__ p, int64_t col, int64_t c1) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (col + kApart * k < c1) e[k] = p[kApart * k];
  }
  __device__ __forceinline__ void widen(float (&x)[V]) const {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = to_f32(e[k]);
  }
};

// V consecutive values rounded to T, in one streaming store of V*sizeof(T)
// bytes (st.global.cs: the output is not read back)
template <typename T, int V>
__device__ __forceinline__ void store_stream(T* p, const float (&v)[V]) {
  constexpr int kWords = static_cast<int>(V * sizeof(T) / 4);
  uint32_t w[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    if constexpr (sizeof(T) == 4) {
      w[q] = __float_as_uint(v[q]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  if constexpr (kWords == 4) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(w[0]), "r"(w[1]),
                 "r"(w[2]), "r"(w[3])
                 : "memory");
  } else if constexpr (kWords == 2) {
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(w[0]), "r"(w[1])
                 : "memory");
  } else {
    asm volatile("st.global.cs.u32 [%0], %1;" ::"l"(p), "r"(w[0]) : "memory");
  }
}

// Two shapes of the same sums.  At m <= 16 (kTall false) all m rows of x
// stay in registers while R = 16 / V output rows at a time are summed, so x
// is read once.  At m > 16 (kTall true) a thread takes 4 columns and sums R
// output rows at a time, streaming x in groups of 4 rows, so x is read
// ceil(m / R) times: R = 16 on the vector path (128 registers, 2 blocks an
// SM), 8 on the scalar one (80 registers, 3 blocks an SM, which measured
// faster there than 16 rows at 2 blocks).
template <typename T, bool kVec, bool kGivenMask, bool kTall>
__global__ void __launch_bounds__(kThreads)
relay_mix_kernel(const float* __restrict__ A, const float* __restrict__ tau,
                 const T* __restrict__ x, T* __restrict__ out, int C, int m, int64_t d,
                 int64_t cols) {
  constexpr int V = kMixCols<T, kVec, kTall>;
  constexpr int R = kTall ? (kVec ? 16 : 8) : 16 / V;  // output rows at once
  constexpr int kBatch = kTall ? 4 : kMixBatch;
  using Row = MixRow<T, kVec, V>;
  extern __shared__ float mask[];
  const int64_t mm = static_cast<int64_t>(m) * m;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int64_t c1 = c0 + cols < d ? c0 + cols : d;
  const int64_t step = static_cast<int64_t>(blockDim.x) * V;
  const int64_t first = kVec ? c0 + static_cast<int64_t>(threadIdx.x) * V
                             : c0 + (threadIdx.x / 32) * 32 * V + threadIdx.x % 32;
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    if (c != static_cast<int>(blockIdx.y)) __syncthreads();  // the last cluster's mask is read
    for (int k = threadIdx.x; k < mm; k += blockDim.x) {
      if constexpr (kGivenMask) {
        mask[k] = A[k];
      } else {
        const int i = k / m, j = k - i * m;
        mask[k] = __fmul_rn(A[c * mm + k], tau[c * mm + j * m + i]);
      }
    }
    __syncthreads();
    const T* xc = x + static_cast<int64_t>(c) * m * d;
    T* oc = out + static_cast<int64_t>(c) * m * d;
    for (int64_t col = first; col < c1; col += step) {
      Row rows[kBatch];
      auto load = [&](int j0) {
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
          if (j0 + r < m) rows[r].load(xc + static_cast<int64_t>(j0 + r) * d + col, col, c1);
      };
      if constexpr (!kTall) load(0);
      for (int i0 = 0; i0 < m; i0 += R) {
        float acc[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[r][k] = 0.0f;
        for (int j0 = 0; j0 < (kTall ? m : 1); j0 += kBatch) {  // m <= kBatch if !kTall
          if constexpr (kTall) load(j0);
#pragma unroll
          for (int jj = 0; jj < kBatch; ++jj) {
            if (j0 + jj < m) {
              float xv[V];
              rows[jj].widen(xv);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if (i0 + r < m) {
                  const float w = mask[(i0 + r) * m + j0 + jj];
#pragma unroll
                  for (int k = 0; k < V; ++k) acc[r][k] = __fadd_rn(acc[r][k], __fmul_rn(w, xv[k]));
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (i0 + r < m) {
            T* o = oc + static_cast<int64_t>(i0 + r) * d + col;
            if constexpr (kVec) {
              store_stream(o, acc[r]);
            } else {
#pragma unroll
              for (int k = 0; k < V; ++k)
                if (col + Row::kApart * k < c1) store_f32(o + Row::kApart * k, acc[r][k]);
            }
          }
        }
      }
    }
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

// table: count rows of (x pointer, d); the segments' outputs follow each
// other in out.
template <typename T>
cudaError_t launch_block_segments(const float* w, const int64_t* table, int count, float* out,
                                  int n, int64_t block_d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  RowSegments tab{};
  const int64_t blocks = place_row_segments<T>(tab, table, count, block_d,
                                               (const void*)block_row_segments_kernel<T, V>);
  if (blocks < 1) return cudaErrorInvalidValue;
  block_row_segments_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      w, out, n, tab);
  return cudaGetLastError();
}

// One wave: the card's resident blocks shared out among the clusters, each
// block's columns a whole number of a warp's passes (32 * V), so that the
// blocks spread evenly over the SMs (a thread may make one pass more than
// another of its block).
template <typename T, bool kVec, bool kGivenMask, bool kTall>
cudaError_t launch_mix_v(const float* A, const float* tau, const T* x, T* out, int C, int m,
                         int64_t d, cudaStream_t stream) {
  constexpr int V = kMixCols<T, kVec, kTall>;
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  const int64_t resident =
      resident_blocks((const void*)relay_mix_kernel<T, kVec, kGivenMask, kTall>, smem);
  const int64_t per_cluster = resident > C ? resident / C : 1;
  const int64_t share = (d + per_cluster - 1) / per_cluster, unit = 32 * V;
  const int64_t cols = (share + unit - 1) / unit * unit;
  const dim3 grid(stream_grid(d, cols).x, static_cast<unsigned>(C < 65535 ? C : 65535));
  relay_mix_kernel<T, kVec, kGivenMask, kTall><<<grid, kThreads, smem, stream>>>(
      A, tau, x, out, C, m, d, cols);
  return cudaGetLastError();
}

template <typename T, bool kGivenMask, bool kTall>
cudaError_t launch_mix_t(const float* A, const float* tau, const void* x, void* out, int C,
                         int m, int64_t d, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  return rows_aligned<T>(x, d) && rows_aligned<T>(out, d)
             ? launch_mix_v<T, true, kGivenMask, kTall>(A, tau, xt, ot, C, m, d, stream)
             : launch_mix_v<T, false, kGivenMask, kTall>(A, tau, xt, ot, C, m, d, stream);
}

template <typename T, bool kGivenMask>
cudaError_t launch_mix(const float* A, const float* tau, const void* x, void* out, int C,
                       int m, int64_t d, cudaStream_t stream) {
  return m > kMixBatch ? launch_mix_t<T, kGivenMask, true>(A, tau, x, out, C, m, d, stream)
                       : launch_mix_t<T, kGivenMask, false>(A, tau, x, out, C, m, d, stream);
}

template <typename T, bool kVec>
int mix_blocks_per_sm(int m) {
  int per_sm = 0;
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  const cudaError_t err =
      m > kMixBatch
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, relay_mix_kernel<T, kVec, true, true>, kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, relay_mix_kernel<T, kVec, true, false>, kThreads, smem);
  return err == cudaSuccess ? per_sm : -1;
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

// w: the (C, m) rows flattened to (n,); table: count rows of (x pointer, d).
extern "C" int repro_block_row_stream_segments(const float* w, const int64_t* table, int count,
                                               float* out, int n, int64_t block_d, int dtype,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_block_segments<float>(w, table, count, out, n, block_d, s);
    case kBF16: return launch_block_segments<__nv_bfloat16>(w, table, count, out, n, block_d, s);
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

// Blocks of the relay-mix kernel one SM holds for an (m, m) mask, on the
// 16-byte path (vector != 0) or the scalar one; -1 if the query fails.
extern "C" int repro_relay_mix_blocks_per_sm(int m, int dtype, int vector) {
  switch (dtype) {
    case kF32: return vector ? mix_blocks_per_sm<float, true>(m) : mix_blocks_per_sm<float, false>(m);
    case kBF16:
      return vector ? mix_blocks_per_sm<__nv_bfloat16, true>(m)
                    : mix_blocks_per_sm<__nv_bfloat16, false>(m);
    default: return -1;
  }
}
