// Causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (pallas_call at line 81) -> flash_attention_kernel<T, D>
//     out[b] = softmax(q[b] k[b]^T / sqrt(D), causal) v[b]     per b in [0, BH)
// q, k, v are (BH, T, D) row-major, f32 or bf16, read into f32; the output
// is (BH, T, D) in q's dtype.  D is 32, 64 or 128.
//
// What bounds it: operations.  A causal pass does 4*D flops per live
// (query, key) pair, 4*BH*D*T(T+1)/2 in all, against 4*BH*T*D*elt bytes of
// q, k, v and out.  At the seamless prefill shape (BH=64, T=4096, D=64,
// bf16) that is 137.5 GFLOP and 134 MB: 0.139 ms at the card's 989 TFLOP/s
// dense bf16 tensor-core rate, 0.040 ms at 3.35 TB/s.  This kernel does its
// products on the CUDA cores in f32 FMAs, whose peak (67 TFLOP/s) puts its
// own floor near 2.1 ms there; tensor-core tiles (mma.sync or wgmma), TMA
// and a bf16 PV product are later work.
//
// What the design does:
// * No sequential grid.  The Pallas kernel carries the running max m, sum
//   l and accumulator acc in VMEM scratch across an innermost kv grid axis
//   that the TPU runs in order.  Here one block owns one (bh, 128-row query
//   tile) pair and loops over the kv tiles itself, so the state never
//   leaves the block: m and l live in registers, acc in registers (each
//   thread owns one query row, or half of one at D = 128, where the two
//   lanes of a row add their partial scores with one shuffle).
// * Dead blocks are skipped as the Pallas kernel skips them (its pl.when
//   at line 36): the kv loop stops at the tile holding the block's last
//   query row, and a warp stops inside that tile after its own last row.
//   Keys past a row are masked to -1e30 before the online softmax, as in
//   the Pallas kernel.
// * K and V tiles of 4096 floats each (128, 64 or 32 keys at D = 32, 64,
//   128) are staged in shared memory with 16-byte loads, widened to f32;
//   every thread then reads a key's 4-float group once per 4 FMAs, and the
//   warp's lanes read the same address (a broadcast).
// * Scores are taken 16 keys at a time: 16 independent FMA chains, one
//   rescale of acc (one expf) per 16 keys, then the 16 p*v products.
// * The heaviest query tiles (the last ones) are launched first.
// * A ragged tail in T is masked in the kernel: query rows past T load 0
//   and store nothing, key rows past T are staged as 0 and are causally
//   dead for every live row.  No atomics, no cross-block reduction; the
//   result is deterministic.
//
// Arithmetic: f32 FMAs and expf (the accurate one), scores scaled by a
// float 1/sqrt(D) after the dot product, out = acc / max(l, 1e-30) as in
// the Pallas kernel.  The plain version (kernels/flash_attention.py) is the
// dense softmax of src/repro/kernels/ref.py; the two agree within 2e-5 in
// f32 (the reference's own bound for its kernel), not to the bit.
//
// The launcher returns cudaGetLastError(); the kernel allocates nothing.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 128;       // query rows a block owns
constexpr int kChunk = 16;         // keys scored per online-softmax step
constexpr int kTileFloats = 4096;  // floats of one staged K or V tile

template <int D>
struct Tile {
  static constexpr int R = D > 64 ? D / 64 : 1;  // lanes sharing one query row
  static constexpr int DR = D / R;               // head dims a lane owns
  static constexpr int G = DR / 4;               // its 4-float groups
  static constexpr int NT = kBlockQ * R;         // threads a block
  static constexpr int BKV = kTileFloats / D;    // keys a staged tile
  static_assert(D % 4 == 0 && DR % 4 == 0 && BKV % kChunk == 0, "tile shape");
};

// Lane `part` of a row owns the 4-float groups c*R + part, c < G: the R
// lanes of a row read neighbouring 16-byte words of a key (no bank clash).
template <int D>
__device__ __forceinline__ int group_dim(int c, int part) {
  return 4 * (c * Tile<D>::R + part);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [k0, k0 + BKV) of one (T, D) matrix into dst as f32; rows past T
// are zero.  A 16-byte vector never straddles a row (D * elt % 16 == 0).
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, float* __restrict__ dst,
                                           int k0, int t_len) {
  using Tl = Tile<D>;
  constexpr int V = 16 / sizeof(T);
  const int live = (t_len - k0 < Tl::BKV ? t_len - k0 : Tl::BKV) * D;
  const T* p = src + static_cast<int64_t>(k0) * D;
  for (int e = threadIdx.x * V; e < Tl::BKV * D; e += Tl::NT * V) {
    float x[V];
    if (e < live) {
      load_cols<T, V>(p + e, x);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; i += 4) store4(dst + e + i, x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int t_len, float scale) {
  using Tl = Tile<D>;
  constexpr int R = Tl::R, G = Tl::G, BKV = Tl::BKV;
  __shared__ __align__(16) float ks[BKV * D];
  __shared__ __align__(16) float vs[BKV * D];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * t_len * D;  // this (b, h)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;              // heaviest tiles first
  const int row = threadIdx.x / R, part = threadIdx.x % R;
  const int qi = q0 + row;
  const bool live = qi < t_len;
  // the last query row of this warp and of this block: no key beyond it is seen
  const int warp_last = q0 + ((threadIdx.x / 32) * 32 + 31) / R;
  const int block_last = min(q0 + kBlockQ, t_len) - 1;

  float qr[4 * G], acc[4 * G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[4 * c + i] = live ? to_f32(q[base + static_cast<int64_t>(qi) * D +
                                      group_dim<D>(c, part) + i])
                           : 0.0f;
      acc[4 * c + i] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  const int n_tiles = block_last / BKV + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, D>(k + base, ks, k0, t_len);
    stage_tile<T, D>(v + base, vs, k0, t_len);
    __syncthreads();
    const int kend = min(BKV, warp_last - k0 + 1);  // warp-uniform
    for (int j0 = 0; j0 < kend; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.0f;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const int d0 = group_dim<D>(c, part);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (j0 + j) * D + d0);
          s[j] = fmaf(qr[4 * c], kv.x, s[j]);
          s[j] = fmaf(qr[4 * c + 1], kv.y, s[j]);
          s[j] = fmaf(qr[4 * c + 2], kv.z, s[j]);
          s[j] = fmaf(qr[4 * c + 3], kv.w, s[j]);
        }
      }
      if constexpr (R > 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int off = 1; off < R; off <<= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = (k0 + j0 + j <= qi) ? s[j] * scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - mx);
        l += p;
#pragma unroll
        for (int c = 0; c < G; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j0 + j) * D +
                                                             group_dim<D>(c, part));
          acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m = mx;
    }
  }

  if (!live) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* o = out + base + static_cast<int64_t>(qi) * D;
#pragma unroll
  for (int c = 0; c < G; ++c)
    store4(o + group_dim<D>(c, part), acc[4 * c] * inv, acc[4 * c + 1] * inv,
           acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int t_len,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((t_len + kBlockQ - 1) / kBlockQ));
  flash_attention_kernel<T, D><<<grid, Tile<D>::NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t_len, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const void* q, const void* k, const void* v, void* out, int bh,
                           int t_len, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, bh, t_len, stream);
    case 64: return launch<T, 64>(q, k, v, out, bh, t_len, stream);
    case 128: return launch<T, 128>(q, k, v, out, bh, t_len, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Element type codes shared with kernels/flash_attention.py.
enum : int { kFlashF32 = 0, kFlashBF16 = 1 };

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int bh, int t_len, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFlashF32: return launch_for_dim<float>(q, k, v, out, bh, t_len, d, s);
    case kFlashBF16: return launch_for_dim<__nv_bfloat16>(q, k, v, out, bh, t_len, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
