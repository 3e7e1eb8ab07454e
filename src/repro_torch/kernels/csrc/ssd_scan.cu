// Chunked SSD (Mamba2) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/ssd_scan.py:
//   ssd_scan_pallas (pallas_call at line 88) -> ssd_scan_tc_kernel (bf16),
//                                              ssd_scan_f32_kernel (f32)
// For every (b, h) slice, from a zero state S (Dk x Dv, f32), chunk by chunk
// of Q tokens with c the chunk-local inclusive cumsum of the log decays:
//   y_t = sum_{s<=t} (q_t . k_s) exp(min(c_t - c_s, 0)) v_s + exp(c_t) q_t S
//   S   = exp(c_last) S + sum_s k_s exp(min(c_last - c_s, 0)) v_s^T
// q, k are (..., T, Dk), v and out (..., T, Dv), f32 or bf16; log_decay
// (..., T) is f32 and <= 0; out is in q's dtype.  Every exponent is <= 0,
// and the min(., 0) clamps stay so that rounding cannot make one positive.
//
// What bounds it: bytes.  At the jamba prefill shape (BH = 4 x 256, T =
// 4096, Dk = 16, Dv = 64, Q = 64, bf16) the (BH, T, .) interface moves 1.359
// GB (q, k, v, out and the f32 log decays), 0.41 ms at 3.35 TB/s, against
// 39 GFLOP of live products, 0.04 ms at the bf16 tensor-core rate.  The
// first kernel (kept here as ssd_scan_f32_kernel) did every product as f32
// FMAs on the CUDA cores (~0.6 ms at the FMA pipe's peak alone), read each
// chunk as 2-byte scalars between barriers with nothing in flight during
// compute, took the log-decay cumsum on one thread and stored 2-byte
// scalars: 3.96 ms, 0.34 TB/s.
//
// What the bf16 design does:
// * No sequential grid.  The Pallas kernel carries S in VMEM scratch across
//   an innermost chunk grid axis that the TPU runs in order.  Here one block
//   owns one (b, h) slice and loops over its chunks itself; no cross-block
//   state exists and nothing but q, k, v, the decays and y touches device
//   memory.  A block is 4 warps, and at most 128 registers a thread and
//   ~51 KB of shared memory (Q = 64, Dk = 16, Dv = 64) let 4 blocks share
//   an SM, so that one block's barrier or chunk latency hides behind the
//   others.
// * Loads overlap compute.  Chunk n+1's q, k, v (16-byte cp.async when the
//   rows are 16-byte aligned, else element copies) and log decays (4-byte
//   cp.async) go into the second of two shared-memory stages while chunk n
//   computes; one barrier a chunk.
// * Products on the tensor cores, mma.sync.m16n8k16 bf16 -> f32, warp w
//   owning chunk rows [16w, 16w + 16): the scores q k^T (bf16 operands, so
//   each product is exact), y = exp(c_t) (q S) + W V with W the decayed,
//   causally masked scores, and the state update (k * decay)^T V.  The f32
//   operands W, S and k * decay are split into bf16 hi + lo parts (two MMAs
//   a product, ~16 bits kept), as kernel 10 splits P.  W never leaves
//   registers: the scores' accumulator layout is the A layout of W V.  S
//   lives in the registers of the warps that own its 16 x 16 tiles and is
//   written to shared memory as hi/lo each chunk for the q S product (two
//   buffers, so the next chunk's write needs no second barrier).  Tiles
//   above the diagonal are skipped; tails of Q, Dk and Dv that are not
//   multiples of 16 are zero padding in shared memory, never on the host.
// * The cumsum is a warp-shuffle scan, each warp its own copy (no barrier).
// * y is staged through a per-warp shared tile and written as 16-byte
//   streaming stores (element stores when the output rows are not 16-byte
//   aligned).
// * Strided operands.  Each operand is addressed as b*sb + h*sh + t*st + i,
//   with the block's slice split as bh = b*H + h.  Mamba's q and k are one
//   (B, T, N) tensor broadcast over the heads (sh = 0) and its v and y live
//   in (B, T, H, P) order, so the mixer calls the kernel on views: no
//   broadcast copy of q and k, no transposes of v and y.  A contiguous
//   (BH, T, D) operand is the case B = 1, H = BH.
// * The state is zero at the start of every slice (the Pallas kernel's
//   pl.when(ci == 0)) and is not returned, as in the reference.
//
// * The tile counts (Dk and Dv in 16-wide steps, and whether a chunk fills
//   all four row tiles) are template parameters, so the chunk's body has no
//   run-time branches on them for ptxas to schedule around.
//
// f32 inputs keep the first kernel's CUDA-core arithmetic (the dtype picks
// the kernel): bf16 parts of f32 q, k and v would need three parts of every
// operand, and f32 is on no bf16 serving path; that split was not tried.
// It takes per chunk, in shared memory as f32, q, k transposed, v, the
// weighted scores and the decays; 256 threads take 4 x 4 tiles of the
// scores, of y and of the state update.
//
// The plain version (kernels/ssd_scan.py:ssd_scan_plain) follows the Pallas
// kernel's arithmetic with batched matmuls; the kernels agree with it within
// 5e-4 in f32 (the reference's bound for its kernel, tests/test_kernels.py:96)
// and 2e-2 in bf16, not to the bit: the products sum in another order, and
// the bf16 kernel's f32 operands keep ~16 bits.
//
// The launcher returns cudaGetLastError(); the kernels allocate nothing.

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

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// -- f32: the CUDA-core kernel -------------------------------------------------

// floats of dynamic shared memory: q, k^T, v, w, S and three (Q,) vectors
__host__ __device__ __forceinline__ int smem_floats(int chunk, int dk, int dv) {
  return round4(chunk * dk) + dk * kLd + chunk * dv + round4(chunk) * kLd + dk * dv +
         3 * kMaxChunk;
}

__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_f32_kernel(const float* __restrict__ q, View vq, const float* __restrict__ k, View vk,
                    const float* __restrict__ v, View vv, const float* __restrict__ ld, View vl,
                    float* __restrict__ out, View vo, int heads, int t_len, int dk, int dv,
                    int chunk) {
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
  const float* qb = q + b * vq.sb + h * vq.sh;
  const float* kb = k + b * vk.sb + h * vk.sh;
  const float* vb = v + b * vv.sb + h * vv.sh;
  const float* lb = ld + b * vl.sb + h * vl.sh;
  float* ob = out + b * vo.sb + h * vo.sh;

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
      qs[e] = qb[row * vq.st + i];
      kT[i * kLd + t] = kb[row * vk.st + i];
    }
    for (int e = tid; e < chunk * dv; e += kSsdThreads) {
      const int t = e / dv, j = e % dv;
      vs[e] = vb[static_cast<int64_t>(t0 + t) * vv.st + j];
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
        float* o = ob + static_cast<int64_t>(t0 + t) * vo.st + yc0;
#pragma unroll
        for (int m = 0; m < 4; ++m) o[m] = acc[r][m] + ec[t] * qS[m];
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

// -- bf16: the tensor-core kernel -----------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMinBlocks = 4;  // blocks an SM: caps registers at 128 a thread

// operands copied with 16-byte cp.async, and an output written with 16-byte stores
enum : int { kVecQ = 1, kVecK = 2, kVecV = 4, kVecOut = 8 };

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// The bf16 kernel's shared memory, in bytes, every offset a multiple of 16:
// two stages of q, k ([qp][ldq]), v ([qp][ldv]) and the log decays (64
// floats); two buffers of S as bf16 hi and lo ([kp][ldv] each); per warp the
// cumsum and the state decays (2 x 64 floats) and a [16][ldv] tile of y.
// Row strides are 16 bytes past a multiple of 32, so the 8 rows that one
// ldmatrix reads fall in 8 different 16-byte bank groups.
struct TcLayout {
  int qp, kp, np;  // the chunk, Dk and Dv padded to the 16-wide MMA tiles
  int ldq, ldv;    // row strides in elements: q, k; v, S, y
  int q_off, k_off, v_off, l_off, stage_bytes;
  int s_off, s_bytes, c_off, o_off, total;
  __host__ __device__ TcLayout(int chunk, int dk, int dv) {
    qp = round16(chunk);
    kp = round16(dk);
    np = round16(dv);
    ldq = kp + 8;
    ldv = np + 8;
    q_off = 0;
    k_off = q_off + qp * ldq * 2;
    v_off = k_off + qp * ldq * 2;
    l_off = v_off + qp * ldv * 2;
    stage_bytes = l_off + kMaxChunk * 4;
    s_off = 2 * stage_bytes;
    s_bytes = kp * ldv * 2;
    c_off = s_off + 4 * s_bytes;
    o_off = c_off + kTcWarps * 2 * kMaxChunk * 4;
    total = o_off + kTcWarps * 16 * ldv * 2;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // x0 in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as bf16 hi + lo parts, each pair packed as pack2 packs it
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ void store_stream16(bf16* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// rows [t0, t0 + rows) x cols of an operand into a [.][ldd] tile: 16-byte
// cp.async, or element copies that complete before the next barrier
__device__ __forceinline__ void copy_rows(bf16* dst, int ldd, const bf16* __restrict__ src,
                                          int64_t st, int64_t t0, int rows, int cols, bool vec) {
  if (vec) {
    const int units = cols / 8;
    for (int u = threadIdx.x; u < rows * units; u += kTcThreads) {
      const int t = u / units, c = (u - t * units) * 8;
      cp_async16(dst + t * ldd + c, src + (t0 + t) * st + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kTcThreads) {
      const int t = e / cols, c = e - t * cols;
      dst[t * ldd + c] = src[(t0 + t) * st + c];
    }
  }
}

// KS k-steps of 16 key dims, NP pairs of 8-column value tiles, MT row tiles
// of 16 (0: from the chunk).
template <int KS, int NP, int MT>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
ssd_scan_tc_kernel(const bf16* __restrict__ q, View vq, const bf16* __restrict__ k, View vk,
                   const bf16* __restrict__ v, View vv, const float* __restrict__ ld, View vl,
                   bf16* __restrict__ out, View vo, int heads, int t_len, int dk, int dv,
                   int chunk, int flags) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const TcLayout L(chunk, dk, dv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int64_t b = blockIdx.x / heads, h = blockIdx.x % heads;
  const bf16* qb = q + b * vq.sb + h * vq.sh;
  const bf16* kb = k + b * vk.sb + h * vk.sh;
  const bf16* vb = v + b * vv.sb + h * vv.sh;
  const float* lb = ld + b * vl.sb + h * vl.sh;
  bf16* ob = out + b * vo.sb + h * vo.sh;
  constexpr int ksteps = KS;                 // k-steps of q k^T and q S; m-tiles of S
  constexpr int pairs = NP;                  // pairs of 8-column n-tiles of y and S
  const int mtiles = MT ? MT : L.qp / 16;    // m-tiles of y; k-steps of W V and (k d)^T V
  const int n_chunks = t_len / chunk;

  // zero everything once: the padding of every tile stays zero, S starts at 0
  for (int e = tid; e < L.total / 16; e += kTcThreads)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_chunk = [&](int ci) {
    unsigned char* st = smem + (ci & 1) * L.stage_bytes;
    const int64_t t0 = static_cast<int64_t>(ci) * chunk;
    copy_rows(reinterpret_cast<bf16*>(st + L.q_off), L.ldq, qb, vq.st, t0, chunk, dk,
              flags & kVecQ);
    copy_rows(reinterpret_cast<bf16*>(st + L.k_off), L.ldq, kb, vk.st, t0, chunk, dk,
              flags & kVecK);
    copy_rows(reinterpret_cast<bf16*>(st + L.v_off), L.ldv, vb, vv.st, t0, chunk, dv,
              flags & kVecV);
    float* ls = reinterpret_cast<float*>(st + L.l_off);
    for (int t = tid; t < chunk; t += kTcThreads) cp_async4(ls + t, lb + (t0 + t) * vl.st);
    cp_async_commit();
  };

  float* cw = reinterpret_cast<float*>(smem + L.c_off) + warp * 2 * kMaxChunk;  // cumsum
  float* dw = cw + kMaxChunk;                          // exp(min(c_last - c_s, 0))
  bf16* ow = reinterpret_cast<bf16*>(smem + L.o_off) + warp * 16 * L.ldv;  // y staging
  const int r0 = 16 * warp;  // this warp's rows of each chunk

  // the S tiles this warp owns, items warp and warp + 4 of (m-tile, n-tile pair)
  float sacc[2][2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[r][hh][e] = 0.0f;

  load_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait_all();
    __syncthreads();  // chunk ci has landed and every warp is done with chunk ci - 1
    if (ci + 1 < n_chunks) load_chunk(ci + 1);
    const unsigned char* st = smem + (ci & 1) * L.stage_bytes;
    const bf16* qs = reinterpret_cast<const bf16*>(st + L.q_off);
    const bf16* ks = reinterpret_cast<const bf16*>(st + L.k_off);
    const bf16* vs = reinterpret_cast<const bf16*>(st + L.v_off);
    const float* ls = reinterpret_cast<const float*>(st + L.l_off);
    const bf16* s_hi = reinterpret_cast<const bf16*>(smem + L.s_off + (ci & 1) * 2 * L.s_bytes);
    const bf16* s_lo = s_hi + L.s_bytes / 2;

    // the chunk-local inclusive cumsum of the log decays: a shuffle scan of
    // two 32-element halves; padding rows take c_last
    float x0 = lane < chunk ? ls[lane] : 0.0f;
    float x1 = lane + 32 < chunk ? ls[lane + 32] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y0 = __shfl_up_sync(0xffffffffu, x0, o);
      const float y1 = __shfl_up_sync(0xffffffffu, x1, o);
      if (lane >= o) {
        x0 += y0;
        x1 += y1;
      }
    }
    x1 += __shfl_sync(0xffffffffu, x0, 31);
    const float c_last = __shfl_sync(0xffffffffu, chunk > 32 ? x1 : x0, (chunk - 1) & 31);
    x0 = lane < chunk ? x0 : c_last;
    x1 = lane + 32 < chunk ? x1 : c_last;
    cw[lane] = x0;
    cw[lane + 32] = x1;
    dw[lane] = expf(fminf(c_last - x0, 0.0f));
    dw[lane + 32] = expf(fminf(c_last - x1, 0.0f));
    __syncwarp();

    if (MT == 4 || r0 < L.qp) {
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        if (kk < ksteps) ldsm_x4(qa[kk], qs + (r0 + (lane & 15)) * L.ldq + kk * 16 + (lane >> 4) * 8);
      const int t0 = r0 + g, t1 = t0 + 8;
      const float ct0 = cw[t0], ct1 = cw[t1];

      // W = (q k^T) * exp(min(c_t - c_s, 0)) for s <= t, else 0, as hi/lo A
      // fragments of W V, k-tile j (keys [16j, 16j + 16)) up to the diagonal
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j <= warp) {
          float sc[2][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[hh][e] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            if (kk < ksteps) {
              uint32_t bk[4];
              ldsm_x4(bk, ks + (16 * j + (lane >> 4) * 8 + (lane & 7)) * L.ldq + kk * 16 +
                              ((lane >> 3) & 1) * 8);
              mma16816(sc[0], qa[kk], bk[0], bk[1]);
              mma16816(sc[1], qa[kk], bk[2], bk[3]);
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int s0 = 16 * j + 8 * hh + 2 * tq, s1 = s0 + 1;
            const float cs0 = cw[s0], cs1 = cw[s1];
            const float w00 = s0 <= t0 ? sc[hh][0] * expf(fminf(ct0 - cs0, 0.0f)) : 0.0f;
            const float w01 = s1 <= t0 ? sc[hh][1] * expf(fminf(ct0 - cs1, 0.0f)) : 0.0f;
            const float w10 = s0 <= t1 ? sc[hh][2] * expf(fminf(ct1 - cs0, 0.0f)) : 0.0f;
            const float w11 = s1 <= t1 ? sc[hh][3] * expf(fminf(ct1 - cs1, 0.0f)) : 0.0f;
            split2(w00, w01, wh[j][2 * hh], wl[j][2 * hh]);
            split2(w10, w11, wh[j][2 * hh + 1], wl[j][2 * hh + 1]);
          }
        }
      }

      // y = exp(c_t) (q S) + W V, S as hi + lo
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk < ksteps) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p < pairs) {
              const int off = (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.ldv + 16 * p +
                              (lane >> 4) * 8;
              uint32_t bh[4], bl[4];
              ldsm_x4_t(bh, s_hi + off);
              ldsm_x4_t(bl, s_lo + off);
              mma16816(acc[2 * p], qa[kk], bh[0], bh[1]);
              mma16816(acc[2 * p], qa[kk], bl[0], bl[1]);
              mma16816(acc[2 * p + 1], qa[kk], bh[2], bh[3]);
              mma16816(acc[2 * p + 1], qa[kk], bl[2], bl[3]);
            }
          }
        }
      }
      const float e0 = expf(ct0), e1 = expf(ct1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j <= warp) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p < pairs) {
              uint32_t bv[4];
              ldsm_x4_t(bv, vs + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.ldv +
                                16 * p + (lane >> 4) * 8);
              mma16816(acc[2 * p], wh[j], bv[0], bv[1]);
              mma16816(acc[2 * p], wl[j], bv[0], bv[1]);
              mma16816(acc[2 * p + 1], wh[j], bv[2], bv[3]);
              mma16816(acc[2 * p + 1], wl[j], bv[2], bv[3]);
            }
          }
        }
      }

      // y through this warp's tile, then out in 16-byte stores
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < 2 * pairs) {
          const int col = 8 * nt + 2 * tq;
          *reinterpret_cast<uint32_t*>(ow + g * L.ldv + col) = pack2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<uint32_t*>(ow + (g + 8) * L.ldv + col) =
              pack2(acc[nt][2], acc[nt][3]);
        }
      }
      __syncwarp();
      const int64_t tg = static_cast<int64_t>(ci) * chunk + r0;
      const int rows = min(16, chunk - r0);
      if (flags & kVecOut) {
        const int units = dv / 8;
        for (int u = lane; u < rows * units; u += 32) {
          const int r = u / units, c = (u - r * units) * 8;
          store_stream16(ob + (tg + r) * vo.st + c,
                         *reinterpret_cast<const uint4*>(ow + r * L.ldv + c));
        }
      } else {
        for (int e = lane; e < rows * dv; e += 32) {
          const int r = e / dv, c = e - r * dv;
          ob[(tg + r) * vo.st + c] = ow[r * L.ldv + c];
        }
      }
    }

    // S = exp(c_last) S + (k * exp(min(c_last - c_s, 0)))^T V on the owned
    // tiles, then S as hi/lo into the other buffer for the next chunk's q S
    const float keep = expf(c_last);
    bf16* n_hi = reinterpret_cast<bf16*>(smem + L.s_off + ((ci + 1) & 1) * 2 * L.s_bytes);
    bf16* n_lo = n_hi + L.s_bytes / 2;
    constexpr int kItems = KS * NP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int item = warp + kTcWarps * r;
      if (kItems % kTcWarps == 0 ? r < kItems / kTcWarps : item < kItems) {
        const int mt = item / pairs, p = item - mt * pairs;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[r][hh][e] *= keep;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < mtiles) {
            uint32_t ka[4], kh[4], kl[4];
            ldsm_x4_t(ka, ks + (16 * j + (lane >> 4) * 8 + (lane & 7)) * L.ldq + 16 * mt +
                              ((lane >> 3) & 1) * 8);
            const int s0 = 16 * j + 2 * tq;
            const float d0 = dw[s0], d1 = dw[s0 + 1], d8 = dw[s0 + 8], d9 = dw[s0 + 9];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack2(ka[e]);
              split2(f.x * (e < 2 ? d0 : d8), f.y * (e < 2 ? d1 : d9), kh[e], kl[e]);
            }
            uint32_t bv[4];
            ldsm_x4_t(bv, vs + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * L.ldv + 16 * p +
                              (lane >> 4) * 8);
            mma16816(sacc[r][0], kh, bv[0], bv[1]);
            mma16816(sacc[r][0], kl, bv[0], bv[1]);
            mma16816(sacc[r][1], kh, bv[2], bv[3]);
            mma16816(sacc[r][1], kl, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * p + 8 * hh + 2 * tq, row = 16 * mt + g;
          uint32_t hi, lo;
          split2(sacc[r][hh][0], sacc[r][hh][1], hi, lo);
          *reinterpret_cast<uint32_t*>(n_hi + row * L.ldv + col) = hi;
          *reinterpret_cast<uint32_t*>(n_lo + row * L.ldv + col) = lo;
          split2(sacc[r][hh][2], sacc[r][hh][3], hi, lo);
          *reinterpret_cast<uint32_t*>(n_hi + (row + 8) * L.ldv + col) = hi;
          *reinterpret_cast<uint32_t*>(n_lo + (row + 8) * L.ldv + col) = lo;
        }
      }
    }
  }
}

// 16-byte copies need the base, every stride and the row to be whole
// 16-byte words
bool rows16(const void* p, const View& s, int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.sb * 2) % 16 == 0 &&
         (s.sh * 2) % 16 == 0 && (s.st * 2) % 16 == 0 && (cols * 2) % 16 == 0;
}

using TcKernel = void (*)(const bf16*, View, const bf16*, View, const bf16*, View, const float*,
                         View, bf16*, View, int, int, int, int, int, int);

template <int KS, int NP>
TcKernel tc_kernel(const TcLayout& L) {
  return L.qp == 64 ? ssd_scan_tc_kernel<KS, NP, 4> : ssd_scan_tc_kernel<KS, NP, 0>;
}

// the instance for this shape, its shared memory opted in
cudaError_t tc_kernel_for(const TcLayout& L, TcKernel* kernel) {
  const int ks = L.kp / 16, np = L.np / 16;
  *kernel = ks == 1 ? (np == 1 ? tc_kernel<1, 1>(L) : np == 2 ? tc_kernel<1, 2>(L) : tc_kernel<1, 4>(L))
                    : (np == 1 ? tc_kernel<2, 1>(L) : np == 2 ? tc_kernel<2, 2>(L) : tc_kernel<2, 4>(L));
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(*kernel), cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  return err != cudaSuccess ? err
                            : cudaFuncSetAttribute(reinterpret_cast<const void*>(*kernel),
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch_tc(const void* q, View vq, const void* k, View vk, const void* v, View vv,
                      const float* ld, View vl, void* out, View vo, int batch_heads, int heads,
                      int t_len, int dk, int dv, int chunk, cudaStream_t stream) {
  const TcLayout L(chunk, dk, dv);
  TcKernel kernel = nullptr;
  const cudaError_t err = tc_kernel_for(L, &kernel);
  if (err != cudaSuccess) return err;
  const int flags = (rows16(q, vq, dk) ? kVecQ : 0) | (rows16(k, vk, dk) ? kVecK : 0) |
                    (rows16(v, vv, dv) ? kVecV : 0) | (rows16(out, vo, dv) ? kVecOut : 0);
  kernel<<<batch_heads, kTcThreads, L.total, stream>>>(
      static_cast<const bf16*>(q), vq, static_cast<const bf16*>(k), vk,
      static_cast<const bf16*>(v), vv, ld, vl, static_cast<bf16*>(out), vo, heads, t_len, dk, dv,
      chunk, flags);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, View vq, const void* k, View vk, const void* v, View vv,
                       const float* ld, View vl, void* out, View vo, int batch_heads, int heads,
                       int t_len, int dk, int dv, int chunk, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(smem_floats(chunk, dk, dv));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  ssd_scan_f32_kernel<<<batch_heads, kSsdThreads, bytes, stream>>>(
      static_cast<const float*>(q), vq, static_cast<const float*>(k), vk,
      static_cast<const float*>(v), vv, ld, vl, static_cast<float*>(out), vo, heads, t_len, dk,
      dv, chunk);
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
  const View vq{strides[0], strides[1], strides[2]}, vk{strides[3], strides[4], strides[5]},
      vv{strides[6], strides[7], strides[8]}, vl{strides[9], strides[10], strides[11]},
      vo{strides[12], strides[13], strides[14]};
  const float* ld = static_cast<const float*>(log_decay);
  switch (dtype) {
    case kSsdF32:
      return launch_f32(q, vq, k, vk, v, vv, ld, vl, out, vo, batch_heads, heads, t_len, dk, dv,
                        chunk, s);
    case kSsdBF16:
      return launch_tc(q, vq, k, vk, v, vv, ld, vl, out, vo, batch_heads, heads, t_len, dk, dv,
                       chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the bf16 kernel one SM holds at (chunk, Dk, Dv), from the
// kernel's registers and shared memory; -1 if the query fails.
extern "C" int repro_ssd_scan_blocks_per_sm(int chunk, int dk, int dv) {
  const TcLayout L(chunk, dk, dv);
  TcKernel kernel = nullptr;
  int per_sm = 0;
  if (tc_kernel_for(L, &kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, L.total) !=
          cudaSuccess)
    return -1;
  return per_sm;
}
