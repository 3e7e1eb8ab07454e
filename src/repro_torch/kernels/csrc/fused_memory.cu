// The memory strategy's select-accumulate-update for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_memory.py:
//   fused_memory_update_pallas (pallas_call at line 81)  -> fused_memory_kernel<..., true>
//   memory_stream_pallas       (pallas_call at line 134) -> fused_memory_kernel<..., false>
// Over the round's (n, d) update stack X (f32 or bf16) and the (n, d) f32
// replay buffer B:
//     tilde   = (A * tau_dd^T) @ X                      (ColRel D2D consensus)
//     contrib = tau_up * tilde + (1 - tau_up) * B       (select)
//     delta   = (1/n) sum_i contrib_i                   (accumulate, (d,) f32)
//     B      <- contrib                                 (update, in place)
// The first kernel computes the realized mask A * tau_dd^T itself; the
// segment-streaming twin receives it (the caller computes it once a
// round) and runs over one leaf's (n, d_i) columns, whose buffer columns
// are a strided view of the carried (n, d) buffer.
//
// What bounds them: bytes.  X and B are read once, contrib and delta
// written once: (elt + 12) * n * d + 4 * d bytes against 2 n^2 d + 4 n d
// flops.  At the main path's n=10, d=272,282 f32 that is 33.76 MB, 10.08 us
// at 3.35 TB/s; the flops (54.5 MFLOP) take 0.8 us at the f32 rate.
//
// What the design does about it:
// * tilde never reaches device memory.  Each thread owns V columns; for
//   every output row i it sums tilde_i = sum_j m[i, j] * x[j, c] in j
//   order, mixes it with B[i, c] and writes contrib[i, c] straight away.
//   Re-reading x[:, c] for each i hits the L1 cache (a block's column tile
//   is n * block_d * elt bytes), so device memory sees X once.
// * The (n, n) mask and the uplink selector live in shared memory, so the
//   n^2 weights of every column cost no device-memory traffic.  That
//   bounds n: (n^2 + 2n) floats must fit the 48 KB a launch gets without
//   opting in, n <= 109 (the Python wrapper raises past it).
// * B is updated in place: each thread reads B[i, c] before it writes
//   contrib to the same address, and no thread touches another's columns,
//   so the buffer needs no copy and no second allocation.  B is therefore
//   read with plain loads and is not declared __restrict__.
// * Loads are 16 bytes a thread when every row of X and B is 16-byte
//   aligned and d is a whole number of vectors; otherwise (as for the
//   full-width buffer, whose rows are 272,282 floats) the scalar path.
//
// Arithmetic: f32, products and sums rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction), tilde summed over j in order, delta
// summed over i in order and scaled by a float inv_n.  The plain PyTorch
// versions in kernels/fused_memory.py run the same operations in the same
// order, so kernel, plain version, segmented and monolithic runs agree to
// the bit.
//
// Each launcher returns cudaGetLastError(); the kernels allocate nothing.

#include "common.cuh"

namespace {

// V consecutive f32 values of the replay buffer: plain (coherent) loads,
// since the kernel writes the buffer it reads.
template <int V, bool kVec>
__device__ __forceinline__ void load_buf(const float* p, float (&b)[V]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) b[k] = p[k];
  }
}

template <int V, bool kVec>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

// Shared memory: the (n, n) mask m, then tau_up t and 1 - tau_up.
template <typename T, int V, bool kMaskFromA>
__global__ void __launch_bounds__(kThreads)
fused_memory_kernel(const float* __restrict__ A, const float* __restrict__ tau_dd,
                    const float* __restrict__ mix, const float* __restrict__ tau_up,
                    const T* __restrict__ x, int64_t ldx, float* buf, int64_t ldb,
                    float* __restrict__ delta, int n, int64_t d, int64_t block_d,
                    float inv_n) {
  extern __shared__ float smem[];
  float* m = smem;
  float* t = smem + n * n;
  float* omt = t + n;
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

  constexpr bool kVec = V % 4 == 0;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * block_d;
  const int64_t c1 = c0 + block_d < d ? c0 + block_d : d;
  const int64_t step = static_cast<int64_t>(blockDim.x) * V;
  for (int64_t c = c0 + static_cast<int64_t>(threadIdx.x) * V; c < c1; c += step) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float* mi = m + i * n;
      float tl[V];
#pragma unroll
      for (int k = 0; k < V; ++k) tl[k] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float xv[V];
        load_cols<T, V>(x + static_cast<int64_t>(j) * ldx + c, xv);
        const float mij = mi[j];
#pragma unroll
        for (int k = 0; k < V; ++k) tl[k] = __fadd_rn(tl[k], __fmul_rn(mij, xv[k]));
      }
      float* bi = buf + static_cast<int64_t>(i) * ldb + c;
      float bv[V];
      load_buf<V, kVec>(bi, bv);
      const float ti = t[i], oti = omt[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        bv[k] = __fadd_rn(__fmul_rn(ti, tl[k]), __fmul_rn(oti, bv[k]));
        acc[k] = __fadd_rn(acc[k], bv[k]);
      }
      store_f32<V, kVec>(bi, bv);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(acc[k], inv_n);
    store_f32<V, kVec>(delta + c, acc);
  }
}

bool aligned16(const void* p, int64_t row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

template <typename T, bool kMaskFromA>
cudaError_t launch_memory(const float* A, const float* tau_dd, const float* mix,
                          const float* tau_up, const void* x, int64_t ldx, float* buf,
                          int64_t ldb, float* delta, int n, int64_t d, int64_t block_d,
                          float inv_n, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(n) * (n + 2) * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const bool vec = d % V == 0 && aligned16(x, ldx * static_cast<int64_t>(sizeof(T))) &&
                   aligned16(buf, ldb * 4) && aligned16(delta, 0);
  if (vec)
    fused_memory_kernel<T, V, kMaskFromA><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_dd, mix, tau_up, xt, ldx, buf, ldb, delta, n, d, block_d, inv_n);
  else
    fused_memory_kernel<T, 1, kMaskFromA><<<grid_for(d, block_d), kThreads, smem, stream>>>(
        A, tau_dd, mix, tau_up, xt, ldx, buf, ldb, delta, n, d, block_d, inv_n);
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
  switch (dtype) {
    case kF32:
      return launch_memory<float, true>(A, tau_dd, nullptr, tau_up, x, ldx, buf, ldb, delta,
                                        n, d, block_d, inv_n, s);
    case kBF16:
      return launch_memory<__nv_bfloat16, true>(A, tau_dd, nullptr, tau_up, x, ldx, buf, ldb,
                                                delta, n, d, block_d, inv_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_memory_stream(const float* mix, const float* tau_up, const void* x,
                                   int64_t ldx, float* buf, int64_t ldb, float* delta, int n,
                                   int64_t d, int64_t block_d, int dtype, float inv_n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_memory<float, false>(nullptr, nullptr, mix, tau_up, x, ldx, buf, ldb,
                                         delta, n, d, block_d, inv_n, s);
    case kBF16:
      return launch_memory<__nv_bfloat16, false>(nullptr, nullptr, mix, tau_up, x, ldx, buf,
                                                 ldb, delta, n, d, block_d, inv_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
