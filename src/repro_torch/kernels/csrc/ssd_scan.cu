// Chunked SSD (Mamba2) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas (pallas_call at line 88) -> ssd_scan_kernel<T>
// For every (b, h) slice, from a zero state S (Dk x Dv, f32), chunk by chunk
// of Q tokens with c the chunk-local inclusive cumsum of the log decays:
//   y_t = sum_{s<=t} (q_t . k_s) exp(min(c_t - c_s, 0)) v_s + exp(c_t) q_t S
//   S   = exp(c_last) S + sum_s k_s exp(min(c_last - c_s, 0)) v_s^T
// q, k are (..., T, Dk), v and out (..., T, Dv), f32 or bf16, read into f32;
// log_decay (..., T) is f32 and <= 0; out is in q's dtype.  Every exponent
// is <= 0, and the min(., 0) clamps stay so that rounding cannot make one
// positive.  All arithmetic is f32, as in the Pallas kernel, which widens v
// to f32 before its PV product.
//
// What bounds it: bytes.  At the jamba prefill shape (BH = 4 x 256, T =
// 4096, Dk = 16, Dv = 64, Q = 64, bf16) the (BH, T, .) interface moves 1.359
// GB (q, k, v, out and the f32 log decays), 0.41 ms at 3.35 TB/s, against
// ~61 GFLOP of full products, 0.06 ms at the bf16 tensor-core rate.  This
// kernel does its products on the CUDA cores in f32 FMAs; tensor-core tiles
// (mma.sync or wgmma) and TMA staging are later work.
//
// What the design does:
// * No sequential grid.  The Pallas kernel carries S in VMEM scratch across
//   an innermost chunk grid axis that the TPU runs in order.  Here one block
//   owns one (b, h) slice and loops over its chunks itself, so S stays in
//   shared memory for the whole sequence and no cross-block state exists.
// * Strided operands.  Each operand is addressed as b*sb + h*sh + t*st + i,
//   with the block's slice split as bh = b*H + h.  Mamba's q and k are one
//   (B, T, N) tensor broadcast over the heads (sh = 0) and its v and y live
//   in (B, T, H, P) order, so the mixer calls the kernel on views: no
//   broadcast copy of q and k, no transposes of v and y.  A contiguous
//   (BH, T, D) operand is the case B = 1, H = BH.
// * Per chunk, in shared memory as f32: q (Q x Dk), k transposed (Dk x Q),
//   v (Q x Dv), the weighted scores w (Q x Q) and the decays.  The 256
//   threads take 4 x 4 tiles: of the scores (16 x 16 tiles over a 64 x 64
//   chunk; tiles wholly above the diagonal skip their dot products and
//   write zeros, so exp(-1e30) is never taken), of y (Dv / 4 column groups,
//   rows of a thread contiguous so that a warp's PV loop stops at its last
//   row), and of the state update (Dk x Dv / 4 items).  One thread takes
//   the inclusive prefix sum of the Q log decays in index order while the
//   others take the raw scores.
// * The state is zero at the start of every slice (the Pallas kernel's
//   pl.when(ci == 0)) and is not returned, as in the reference.
//
// The plain version (kernels/ssd_scan.py:ssd_scan_plain) follows the Pallas
// kernel's arithmetic with batched matmuls; the two agree within 5e-4 (the
// reference's bound for its kernel, tests/test_kernels.py:96) in f32, not
// to the bit: the products sum in another order.
//
// The launcher returns cudaGetLastError(); the kernel allocates nothing.

#include "common.cuh"

namespace {

constexpr int kSsdThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxDk = 32;
constexpr int kMaxDv = 64;
constexpr int kLd = kMaxChunk + 4;  // row stride of k^T and w (floats), float4-aligned

// element (b, h, t, i) of an operand at b*sb + h*sh + t*st + i
struct View {
  int64_t sb, sh, st;
};

__device__ __forceinline__ void store_elt(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// floats of dynamic shared memory: q, k^T, v, w, S and three (Q,) vectors
__host__ __device__ __forceinline__ int smem_floats(int chunk, int dk, int dv) {
  return round4(chunk * dk) + dk * kLd + chunk * dv + round4(chunk) * kLd + dk * dv +
         3 * kMaxChunk;
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_kernel(const T* __restrict__ q, View vq, const T* __restrict__ k, View vk,
                const T* __restrict__ v, View vv, const float* __restrict__ ld, View vl,
                T* __restrict__ out, View vo, int heads, int t_len, int dk, int dv, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [chunk][dk]
  float* kT = qs + round4(chunk * dk);           // [dk][kLd]
  float* vs = kT + dk * kLd;                     // [chunk][dv]
  float* ws = vs + chunk * dv;                   // [round4(chunk)][kLd]
  float* Ss = ws + round4(chunk) * kLd;          // [dk][dv]
  float* cs = Ss + dk * dv;                      // [chunk] cumulative log decay
  float* ec = cs + kMaxChunk;                    // [chunk] exp(c_t)
  float* dl = ec + kMaxChunk;                    // [chunk] exp(min(c_last - c_s, 0))

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / heads, h = blockIdx.x % heads;
  const T* qb = q + b * vq.sb + h * vq.sh;
  const T* kb = k + b * vk.sb + h * vk.sh;
  const T* vb = v + b * vv.sb + h * vv.sh;
  const float* lb = ld + b * vl.sb + h * vl.sh;
  T* ob = out + b * vo.sb + h * vo.sh;

  // this thread's 4 x 4 tile of the scores: rows sr0.., columns (keys) sc0..
  const int sr0 = 4 * (tid / 16), sc0 = 4 * (tid % 16);
  // its 4 x 4 tile of y: rows yr0.., value columns yc0..; the warp's last row
  const int ycg = dv / 4;
  const int yr0 = 4 * (tid / ycg), yc0 = 4 * (tid % ycg);
  const int s_end = min(chunk, 4 * (((tid | 31) / ycg) + 1));

  for (int e = tid; e < dk * dv; e += kSsdThreads) Ss[e] = 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    __syncthreads();  // the previous chunk's state update has read k^T and v
    for (int e = tid; e < chunk * dk; e += kSsdThreads) {
      const int t = e / dk, i = e % dk;
      const int64_t row = t0 + t;
      qs[e] = to_f32(qb[row * vq.st + i]);
      kT[i * kLd + t] = to_f32(kb[row * vk.st + i]);
    }
    for (int e = tid; e < chunk * dv; e += kSsdThreads) {
      const int t = e / dv, j = e % dv;
      vs[e] = to_f32(vb[static_cast<int64_t>(t0 + t) * vv.st + j]);
    }
    if (tid < chunk) cs[tid] = lb[static_cast<int64_t>(t0 + tid) * vl.st];
    __syncthreads();

    // the chunk-local inclusive cumsum, in index order, beside the raw scores
    if (tid == 0) {
      float acc = 0.0f;
#pragma unroll 8
      for (int t = 0; t < chunk; ++t) {
        acc += cs[t];
        cs[t] = acc;
      }
    }
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) sc[r][m] = 0.0f;
    const bool tile_live = sr0 < chunk && sc0 < chunk && sc0 <= sr0 + 3;
    if (tile_live) {
      for (int i = 0; i < dk; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(kT + i * kLd + sc0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float qv = sr0 + r < chunk ? qs[(sr0 + r) * dk + i] : 0.0f;
          sc[r][0] = fmaf(qv, kv.x, sc[r][0]);
          sc[r][1] = fmaf(qv, kv.y, sc[r][1]);
          sc[r][2] = fmaf(qv, kv.z, sc[r][2]);
          sc[r][3] = fmaf(qv, kv.w, sc[r][3]);
        }
      }
    }
    __syncthreads();  // cs holds the cumsum

    if (tid < chunk) {
      ec[tid] = expf(cs[tid]);
      dl[tid] = expf(fminf(cs[chunk - 1] - cs[tid], 0.0f));
    }
    if (sr0 < chunk && sc0 < chunk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = sr0 + r;
        if (t >= chunk) break;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int s = sc0 + m;
          float w = 0.0f;
          if (s <= t) w = sc[r][m] * expf(fminf(cs[t] - cs[s], 0.0f));
          if (s < chunk) ws[t * kLd + s] = w;
        }
      }
    }
    __syncthreads();  // w, exp(c_t) and the state decays are in place

    if (yr0 < chunk) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[r][m] = 0.0f;
      // intra-chunk: sum_s w[t, s] v_s; w is 0 above the diagonal
      for (int s = 0; s < s_end; ++s) {
        const float4 vv4 = *reinterpret_cast<const float4*>(vs + s * dv + yc0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w = ws[(yr0 + r) * kLd + s];
          acc[r][0] = fmaf(w, vv4.x, acc[r][0]);
          acc[r][1] = fmaf(w, vv4.y, acc[r][1]);
          acc[r][2] = fmaf(w, vv4.z, acc[r][2]);
          acc[r][3] = fmaf(w, vv4.w, acc[r][3]);
        }
      }
      // inter-chunk: exp(c_t) q_t S, then y in the output's dtype
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = yr0 + r;
        if (t >= chunk) break;
        float qS[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < dk; ++i) {
          const float qv = qs[t * dk + i];
          const float4 s4 = *reinterpret_cast<const float4*>(Ss + i * dv + yc0);
          qS[0] = fmaf(qv, s4.x, qS[0]);
          qS[1] = fmaf(qv, s4.y, qS[1]);
          qS[2] = fmaf(qv, s4.z, qS[2]);
          qS[3] = fmaf(qv, s4.w, qS[3]);
        }
        T* o = ob + static_cast<int64_t>(t0 + t) * vo.st + yc0;
#pragma unroll
        for (int m = 0; m < 4; ++m) store_elt(o + m, acc[r][m] + ec[t] * qS[m]);
      }
    }
    __syncthreads();  // every y has read S

    // S = exp(c_last) S + sum_s (k_s exp(min(c_last - c_s, 0))) v_s^T
    const float keep = expf(cs[chunk - 1]);
    for (int e = tid; e < dk * ycg; e += kSsdThreads) {
      const int i = e / ycg, j = 4 * (e % ycg);
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int s = 0; s < chunk; ++s) {
        const float kd = kT[i * kLd + s] * dl[s];
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * dv + j);
        a[0] = fmaf(kd, v4.x, a[0]);
        a[1] = fmaf(kd, v4.y, a[1]);
        a[2] = fmaf(kd, v4.z, a[2]);
        a[3] = fmaf(kd, v4.w, a[3]);
      }
      float4* sp = reinterpret_cast<float4*>(Ss + i * dv + j);
      const float4 old = *sp;
      *sp = make_float4(keep * old.x + a[0], keep * old.y + a[1], keep * old.z + a[2],
                        keep * old.w + a[3]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ld, void* out,
                   const int64_t* strides, int batch_heads, int heads, int t_len, int dk,
                   int dv, int chunk, cudaStream_t stream) {
  const View vq{strides[0], strides[1], strides[2]}, vk{strides[3], strides[4], strides[5]},
      vv{strides[6], strides[7], strides[8]}, vl{strides[9], strides[10], strides[11]},
      vo{strides[12], strides[13], strides[14]};
  const size_t bytes = sizeof(float) * static_cast<size_t>(smem_floats(chunk, dk, dv));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  ssd_scan_kernel<T><<<batch_heads, kSsdThreads, bytes, stream>>>(
      static_cast<const T*>(q), vq, static_cast<const T*>(k), vk, static_cast<const T*>(v), vv,
      ld, vl, static_cast<T*>(out), vo, heads, t_len, dk, dv, chunk);
  return cudaGetLastError();
}

}  // namespace

// Element type codes shared with kernels/ssd_scan.py.
enum : int { kSsdF32 = 0, kSsdBF16 = 1 };

// strides: (sb, sh, st) of q, k, v, log_decay and out, in elements.
extern "C" int repro_ssd_scan(const void* q, const void* k, const void* v, const void* log_decay,
                              void* out, const int64_t* strides, int batch_heads, int heads,
                              int t_len, int dk, int dv, int chunk, int dtype, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || t_len % chunk || dk < 1 || dk > kMaxDk || dv < 4 ||
      dv > kMaxDv || kSsdThreads % (dv / 4) || dv % 4 || batch_heads < 1 || heads < 1 ||
      batch_heads % heads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ld = static_cast<const float*>(log_decay);
  switch (dtype) {
    case kSsdF32:
      return launch<float>(q, k, v, ld, out, strides, batch_heads, heads, t_len, dk, dv, chunk, s);
    case kSsdBF16:
      return launch<__nv_bfloat16>(q, k, v, ld, out, strides, batch_heads, heads, t_len, dk, dv,
                                   chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
