// Causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (pallas_call at line 81)
//     out[b, t, h] = softmax(q[b, t, h] k[b, :, g(h)]^T / sqrt(D), causal) v[b, :, g(h)]
// with g(h) = h / (H / KV): q and out are (B, T, H, D), k and v (B, T, KV,
// D), each a strided view whose last dim is contiguous (rows 16-byte
// aligned), so grouped kv heads are read in place (no broadcast copy) and
// the output lands in (B, T, H, D) order (no transpose).  A (BH, T, D)
// tensor is the case B = BH, H = KV = 1.  D is 32, 64 or 128.
//
// What bounds it: operations.  A causal pass does 4*D flops per live
// (query, key) pair, 4*B*H*D*T(T+1)/2 in all, against (2*H + 2*KV)*B*T*D
// elements of q, k, v and out.  At the seamless prefill shape (B*H = 64,
// T = 4096, D = 64, bf16) that is 137.5 GFLOP and 134 MB: 0.139 ms at the
// card's 989 TFLOP/s dense bf16 tensor-core rate, 0.040 ms at 3.35 TB/s.
// At jamba's (B = 4, T = 4096, H = 64 over KV = 8, D = 128) 1.10 TFLOP:
// 1.11 ms.
//
// bf16: flash_tc_kernel, the scores on the CUDA cores, P V on the tensor
// cores.
// * A block owns 128 query rows of one (b, h) and has three warpgroups: a
//   producer and two consumers of 64 rows each (four warps of 16 rows).
//   The heaviest (last) query tiles launch first.
// * The producer's one thread loads the block's Q tile once and then K and
//   V tiles of 64 keys with TMA (4-d tensor maps over the strided views,
//   128- or 64-byte swizzle) into a ring of kStages stages in shared
//   memory, bf16 as they are.  Each stage has a "full" mbarrier (the copy's
//   bytes) and an "empty" one (one arrival per consumer warp), so the next
//   tile's copy runs while this one is used.  Rows past T are zero-filled
//   by the copy.  The consumers widen Q to f32 in shared memory once.
// * S = Q K^T as f32 FMAs on the CUDA cores, each score summed over the
//   head dims in order 0, 1, ..., D-1 with one rounding a step, as the
//   plain path's f32 product sums it.  Why not wgmma: seamless's model is
//   chaotic in depth (chip_smoke.py, PREFILL_TOL), so bf16 outputs that
//   round differently from the plain path's grow ~10x a layer, and
//   chip_smoke.py holds the bf16 prefill at two layers against the plain
//   path at 2e-2.  Scores summed in another order fail it: wgmma scores
//   read 1.5e-1 there, PyTorch's SDPA 1.6e-1; these read 6.9e-3 (PERF.md,
//   section 6).  A warp computes its 16 rows x 64 keys in a block layout,
//   a lane 4 rows x 8 keys, q from the f32 copy and K straight from the TMA
//   tile, widened in registers.
// * The online softmax runs in that layout: the scale applied after the
//   dot product, as the reference does; keys past a row masked to -1e30;
//   the row max over the row's eight lanes by shuffles; expf.
// * P goes through a per-warp slot of shared memory into the accumulator
//   fragment layout (which is the wgmma A fragment layout), is split into
//   three bf16 parts, p = hi + mid + lo within 2^-27 p, and O += P V runs
//   as three register-A wgmmas per 16 keys, V the MN-major B operand from
//   shared memory, into a fresh f32 tile that is added to O with one
//   rounding.  So the weights keep their f32 value, as in the Pallas
//   kernel's f32 p v product (src/repro/kernels/flash_attention.py:40,54).
// * No product sits in a branch: ptxas serializes wgmma on divergent paths.
//   A tile past a warp's last row skips its scores only; its masked weights
//   are 0, which leaves m, l and O as they were.
// * out = O / max(l, 1e-30), written from registers into the strided
//   output rows below T.
// What limits it: the scores' FMAs, 34.4 G at the seamless shape, 1.16 ms
// at the FMA pipe's peak; a lane's 256 FMAs per 8 head dims come with 64
// bf16 widenings and 16 loads, and P V does not overlap them.  P V started
// before the next tile's scores (P in shared memory) measured no faster.
//
// f32: flash_f32_kernel, on the CUDA cores, as the f32 bound (2e-5, the
// reference's own) is beyond TF32 or bf16 tensor cores.  One block owns one
// (b, h, 128-row query tile), each thread one query row (half of one at D =
// 128), with m, l and acc in registers; K and V tiles are staged in shared
// memory with 16-byte loads; scores are taken 16 keys at a time; f32 FMAs
// and expf; the same causal tile skipping.
//
// The plain version (kernels/flash_attention.py) is the dense softmax of
// src/repro/kernels/ref.py; the kernels agree with it within 2e-5 in f32
// and 2e-2 in bf16, not to the bit.  No atomics, no cross-block reduction:
// the result is deterministic.  The launcher returns a CUDA error code; the
// kernels allocate nothing.

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself is looked up at run time

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 128;  // query rows a block owns

// Element strides of the batch, time and head dims of one operand.
struct Strides {
  int64_t b, t, h;
};

// -- f32: CUDA-core kernel ---------------------------------------------------

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

// Rows [k0, k0 + BKV) of one (T, D) matrix with row stride st into dst;
// rows past T are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int64_t st,
                                           float* __restrict__ dst, int k0, int t_len) {
  using Tl = Tile<D>;
  for (int e = threadIdx.x * 4; e < Tl::BKV * D; e += Tl::NT * 4) {
    const int r = e / D, col = e - r * D;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k0 + r < t_len) load_cols<float, 4>(src + static_cast<int64_t>(k0 + r) * st + col, x);
    *reinterpret_cast<float4*>(dst + e) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, Strides qs, Strides ks,
                 Strides vs, Strides os, int H, int group, int t_len, float scale) {
  using Tl = Tile<D>;
  constexpr int R = Tl::R, G = Tl::G, BKV = Tl::BKV;
  __shared__ __align__(16) float ksm[BKV * D];
  __shared__ __align__(16) float vsm[BKV * D];

  const int b = blockIdx.x / H, h = blockIdx.x - b * H, g = h / group;
  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;              // heaviest tiles first
  const int row = threadIdx.x / R, part = threadIdx.x % R;
  const int qi = q0 + row;
  const bool live = qi < t_len;
  // the last query row of this warp and of this block: no key beyond it is seen
  const int warp_last = q0 + ((threadIdx.x / 32) * 32 + 31) / R;
  const int block_last = min(q0 + kBlockQ, t_len) - 1;

  float qr[4 * G], acc[4 * G];
  const float* qrow = q + b * qs.b + h * qs.h + static_cast<int64_t>(qi) * qs.t;
#pragma unroll
  for (int c = 0; c < G; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[4 * c + i] = live ? qrow[group_dim<D>(c, part) + i] : 0.0f;
      acc[4 * c + i] = 0.0f;
    }
  }
  float m = kNegInf, l = 0.0f;

  const int n_tiles = block_last / BKV + 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile is consumed
    stage_tile<D>(kb, ks.t, ksm, k0, t_len);
    stage_tile<D>(vb, vs.t, vsm, k0, t_len);
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
          const float4 kv = *reinterpret_cast<const float4*>(ksm + (j0 + j) * D + d0);
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
          const float4 vv = *reinterpret_cast<const float4*>(vsm + (j0 + j) * D +
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
  float* o = out + b * os.b + h * os.h + static_cast<int64_t>(qi) * os.t;
#pragma unroll
  for (int c = 0; c < G; ++c)
    *reinterpret_cast<float4*>(o + group_dim<D>(c, part)) =
        make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv, acc[4 * c + 2] * inv,
                    acc[4 * c + 3] * inv);
}

// -- bf16: CUDA-core scores, tensor-core PV ----------------------------------

constexpr int kStages = 2;       // K/V ring depth
constexpr int kTcThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups

template <int D>
struct TcTile {
  static constexpr int BKV = 64;                   // keys a tile
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzle span, bytes (one smem row)
  static constexpr int COLS = SW / 2;              // head dims a panel (one TMA box wide)
  static constexpr int PANELS = D / COLS;
  static constexpr int FROW = D + 4;               // floats a row of Q's f32 copy
  static constexpr int XROW = BKV + 8;             // floats a row of a warp's P exchange
  static constexpr int Q_PANEL = kBlockQ * SW;     // bytes
  static constexpr int KV_PANEL = BKV * SW;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int QF_BYTES = kBlockQ * FROW * 4;
  static constexpr int X_BYTES = 8 * 16 * XROW * 4;  // the 8 consumer warps' 16 rows
  static constexpr int SMEM = Q_BYTES + kStages * STAGE_BYTES + QF_BYTES + X_BYTES +
                              1024;  // + alignment slack
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;  // wgmma descriptor swizzle code
  static_assert(D % COLS == 0 && Q_PANEL % 1024 == 0 && KV_PANEL % 1024 == 0, "tile shape");
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode.  V is the MN-major B operand:
// 8-key groups SBO = 8*SW apart, LBO from one COLS-wide panel of the head
// dims to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete.  The waits of this
// kernel last microseconds; one that is still waiting after kWaitLimitNs of
// the card's clock (a copy that never lands) traps, so that the launch
// fails with an error instead of hanging the card.  The limit is ten
// seconds, far beyond what time-slicing with other work or a profiler's
// replay of the launch can add to a wait that will end.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023u) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > kWaitLimitNs) __trap();
    }
  }
}

// One TMA box of a 4-d tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is counted in bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The two consumer warpgroups meet (named barrier 1; the producer never
// takes part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// O (64 x 32) += A (64 x 16, registers) B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b) {
  static_assert(N == 32 || N == 64, "panel width");
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 halves of a packed word, widened exactly.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Rows [0, rows) of a bf16 tile that TMA wrote at src (PANELS panels of
// rows x SW bytes, SW-byte swizzle: the 16-byte chunk c of row r sits at
// chunk c ^ (address bits 7 and up)) into dst as f32, FROW floats a row;
// thread `tid` of the kConsumers.
template <int D>
__device__ __forceinline__ void widen_tile(uint32_t src, int rows, float* __restrict__ dst,
                                           int tid) {
  using Tl = TcTile<D>;
  constexpr int CPR = D / 8, CPP = Tl::COLS / 8;  // 16-byte chunks a row, a panel's row
  for (int e = tid; e < rows * CPR; e += kConsumers) {
    const int r = e / CPR, cc = e - r * CPR, p = cc / CPP;
    uint32_t off = r * Tl::SW + (cc - p * CPP) * 16;
    off ^= ((off >> 7) & (Tl::SW / 16 - 1)) << 4;
    uint32_t w[4];
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(src + p * rows * Tl::SW + off)
                 : "memory");
    float* o = dst + r * Tl::FROW + cc * 8;
    *reinterpret_cast<float4*>(o) = make_float4(bf16_lo(w[0]), bf16_hi(w[0]), bf16_lo(w[1]),
                                                bf16_hi(w[1]));
    *reinterpret_cast<float4*>(o + 4) = make_float4(bf16_lo(w[2]), bf16_hi(w[2]),
                                                    bf16_lo(w[3]), bf16_hi(w[3]));
  }
}

// The scores of one warp's 16 query rows against one K tile, as f32 FMAs
// over the head dims in order 0, 1, ..., D-1 (the plain path's order), in
// the warp's block layout: lane (rg, kg) = (lane / 8, lane % 8) holds
// warp-local rows rg + 4r (r < 4) against keys kg + 8i (i < 8) in acc[r][i].
// The rows are f32 in shared memory (qw: the warp's first row).  K (k: the
// tile's first panel) is read as TMA wrote it, bf16 and swizzled (see
// widen_tile), and widened in registers.  Key kg + 8i's swizzle term is
// kg's for every i, so one XOR a step places all eight loads, and a load's
// eight lanes (one rg) read eight keys whose chunks fall in distinct banks.
template <int D>
__device__ __forceinline__ void warp_scores(float (&acc)[4][8], const float* __restrict__ qw,
                                            const uint8_t* __restrict__ k, int rg, int kg) {
  using Tl = TcTile<D>;
  constexpr int CPP = Tl::COLS / 8;
  const uint32_t sw = ((kg * Tl::SW) >> 7) & (Tl::SW / 16 - 1);
  const uint8_t* kr = k + kg * Tl::SW;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
#pragma unroll 1
  for (int cc = 0; cc < D / 8; ++cc) {  // head dims 8 cc .. 8 cc + 7
    float qv[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* qr = qw + (rg + 4 * r) * Tl::FROW + 8 * cc;
      const float4 a = *reinterpret_cast<const float4*>(qr);
      const float4 b = *reinterpret_cast<const float4*>(qr + 4);
      qv[r][0] = a.x, qv[r][1] = a.y, qv[r][2] = a.z, qv[r][3] = a.w;
      qv[r][4] = b.x, qv[r][5] = b.y, qv[r][6] = b.z, qv[r][7] = b.w;
    }
    const int p = cc / CPP;
    const uint8_t* kc = kr + p * Tl::KV_PANEL + (((cc - p * CPP) ^ sw) << 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 w = *reinterpret_cast<const uint4*>(kc + 8 * i * Tl::SW);
      const float kv[8] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y),
                           bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w)};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][i] = fmaf(qv[r][e], kv[e], acc[r][i]);
    }
  }
}

// The values v[r] of the block layout's rows (see warp_scores) for the two
// rows lane / 4 and lane / 4 + 8 of the accumulator fragment layout.
__device__ __forceinline__ void fragment_rows(const float (&v)[4], int lane, float& a,
                                              float& b) {
  const int fr = lane / 4, src = 8 * (fr % 4);  // warp-local row fr = rg + 4r
  float t[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) t[r] = __shfl_sync(0xffffffffu, v[r], src);
  a = fr < 4 ? t[0] : t[1];
  b = fr < 4 ? t[2] : t[3];
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                Strides os, int H, int group, int t_len, float scale) {
  using Tl = TcTile<D>;
  constexpr int BKV = Tl::BKV, NS = BKV / 2, NP = Tl::COLS / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];

  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;                 // Q, bf16: PANELS panels of 128 rows
  const uint32_t skv = base + Tl::Q_BYTES;  // stage s: K panels, then V panels
  float* qf = reinterpret_cast<float*>(smem_raw + (base - raw) + Tl::Q_BYTES +
                                       kStages * Tl::STAGE_BYTES);  // Q widened to f32
  float* xbuf = qf + kBlockQ * Tl::FROW;  // per warp: its P from block to fragment layout
  const uint32_t full = static_cast<uint32_t>(__cvta_generic_to_shared(bars));  // + 8 s
  const uint32_t empty = full + 8 * kStages;                                    // + 8 s
  const uint32_t qbar = full + 16 * kStages;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H, g = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest tiles first
  const int n_tiles = (min(q0 + kBlockQ, t_len) + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread starts every copy
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, Tl::Q_BYTES);
      for (int p = 0; p < Tl::PANELS; ++p)
        tma_load(sq + p * Tl::Q_PANEL, &tm_q, p * Tl::COLS, q0, h, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t stage = skv + s * Tl::STAGE_BYTES;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, Tl::STAGE_BYTES);
        for (int p = 0; p < Tl::PANELS; ++p) {
          tma_load(stage + p * Tl::KV_PANEL, &tm_k, p * Tl::COLS, j * BKV, g, b, full + 8 * s);
          tma_load(stage + Tl::KV_BYTES + p * Tl::KV_PANEL, &tm_v, p * Tl::COLS, j * BKV, g, b,
                   full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows [q0 + 64 cw, q0 + 64 cw + 64),
  // its warp w the 16 rows from q0 + 64 cw + 16 w
  const int ct = threadIdx.x - 128;  // 0 .. kConsumers-1
  const int cw = wg - 1, warp = (ct % 128) / 32, lane = ct % 32;
  const int wrow = 64 * cw + 16 * warp;  // the warp's first row in the block
  const int rg = lane / 8, kg = lane % 8;  // block layout (warp_scores)
  const int ra = q0 + wrow + lane / 4, rb = ra + 8;  // fragment layout: this thread's rows
  const int cq = 2 * (lane % 4);  // and its first column in each 8-column chunk
  float* xw = xbuf + (4 * cw + warp) * 16 * Tl::XROW;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[4], l[4];  // block layout, rows rg + 4r
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = kNegInf, l[r] = 0.0f;

  mbar_wait(qbar, 0);
  widen_tile<D>(sq, kBlockQ, qf, ct);
  consumers_sync();

  // Per tile: the scores on the CUDA cores in the block layout, the online
  // softmax there (the row max over the row's eight lanes by shuffles), P
  // through the warp's shared-memory slot into the fragment layout, then
  // O = O c + (P_lo + P_mid + P_hi) V with P split into three bf16 parts
  // (P V on the tensor cores into a fresh f32 tile, added to O with one
  // rounding); each warp then releases the stage.  No product sits in a
  // branch (ptxas serializes wgmma on divergent paths): a tile past a
  // warp's last row skips its scores only, and its masked weights are 0,
  // which leaves m, l and O as they were.
  float acc[4][8], sc[NS];
  uint32_t pa[3][NS / 2];
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages, k0 = j * BKV;
    const uint32_t stage = skv + s * Tl::STAGE_BYTES;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    if (k0 <= q0 + wrow + 15)
      warp_scores<D>(acc, qf + wrow * Tl::FROW, smem_raw + (stage - raw), rg, kg);
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + wrow + rg + 4 * r;
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[r][i] = k0 + kg + 8 * i <= row ? acc[r][i] * scale : kNegInf;
        mx = fmaxf(mx, acc[r][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      corr[r] = expf(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[r][i] = expf(acc[r][i] - mx);
        sum += acc[r][i];
      }
      l[r] = l[r] * corr[r] + sum;
    }
    __syncwarp();  // the previous tile's P is read
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) xw[(rg + 4 * r) * Tl::XROW + kg + 8 * i] = acc[r][i];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < BKV / 8; ++c) {
      const float2 pa_ = *reinterpret_cast<const float2*>(xw + (lane / 4) * Tl::XROW + 8 * c + cq);
      const float2 pb_ =
          *reinterpret_cast<const float2*>(xw + (lane / 4 + 8) * Tl::XROW + 8 * c + cq);
      sc[4 * c] = pa_.x, sc[4 * c + 1] = pa_.y, sc[4 * c + 2] = pb_.x, sc[4 * c + 3] = pb_.y;
    }
    float c0, c1;
    fragment_rows(corr, lane, c0, c1);
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const uint32_t hi = pack_bf16(sc[i], sc[i + 1]);
      const float r0 = sc[i] - bf16_lo(hi), r1 = sc[i + 1] - bf16_hi(hi);  // exact
      const uint32_t mid = pack_bf16(r0, r1);
      pa[0][i / 2] = pack_bf16(r0 - bf16_lo(mid), r1 - bf16_hi(mid));
      pa[1][i / 2] = mid;
      pa[2][i / 2] = hi;
    }
#pragma unroll
    for (int p = 0; p < Tl::PANELS; ++p) {
      float ot[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) ot[i] = 0.0f;
      fence_regs(ot);
      fence_regs(pa[0]);
      fence_regs(pa[1]);
      fence_regs(pa[2]);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part) {
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t dv = smem_desc(stage + Tl::KV_BYTES + p * Tl::KV_PANEL + kk * 16 * Tl::SW,
                                        Tl::KV_PANEL, 8 * Tl::SW, Tl::LAYOUT);
          wgmma_rs<Tl::COLS>(ot, &pa[part][4 * kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(ot);
      fence_regs(pa[0]);
      fence_regs(pa[1]);
      fence_regs(pa[2]);
#pragma unroll
      for (int i = 0; i < NP; ++i) o[p * NP + i] = fmaf(o[p * NP + i], (i & 2) ? c1 : c0, ot[i]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
  }
  float l0, l1;
  fragment_rows(l, lane, l0, l1);
  const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
  if (ra < t_len) {
    __nv_bfloat16* orow = ob + static_cast<int64_t>(ra) * os.t + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) = pack_bf16(o[4 * c] * i0, o[4 * c + 1] * i0);
  }
  if (rb < t_len) {
    __nv_bfloat16* orow = ob + static_cast<int64_t>(rb) * os.t + cq;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack_bf16(o[4 * c + 2] * i1, o[4 * c + 3] * i1);
  }
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, T, heads, D) bf16 view as a 4-d tensor map (D innermost), boxes of
// `cols` head dims by `rows` time steps of one head and one batch entry.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, Strides st, int B, int t_len,
            int heads, int D, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, const Strides* st,
                      int B, int H, int KV, int t_len, cudaStream_t stream) {
  using Tl = TcTile<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle sw =
      Tl::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  if (!encode(enc, &mq, q, st[0], B, t_len, H, D, Tl::COLS, kBlockQ, sw) ||
      !encode(enc, &mk, k, st[1], B, t_len, KV, D, Tl::COLS, Tl::BKV, sw) ||
      !encode(enc, &mv, v, st[2], B, t_len, KV, D, Tl::COLS, Tl::BKV, sw))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((t_len + kBlockQ - 1) / kBlockQ));
  flash_tc_kernel<D><<<grid, kTcThreads, Tl::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), st[3], H, H / KV, t_len,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, const Strides* st,
                       int B, int H, int KV, int t_len, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((t_len + kBlockQ - 1) / kBlockQ));
  flash_f32_kernel<D><<<grid, Tile<D>::NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), st[0], st[1], st[2], st[3], H, H / KV, t_len,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// Element type codes shared with kernels/flash_attention.py.
enum : int { kFlashF32 = 0, kFlashBF16 = 1 };

// strides: 12 element strides, (batch, time, head) of q, k, v and out.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     const int64_t* strides, int B, int H, int KV, int t_len,
                                     int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (B < 1 || KV < 1 || H % KV != 0 || t_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kFlashF32) {
    switch (d) {
      case 32: err = launch_f32<32>(q, k, v, out, st, B, H, KV, t_len, s); break;
      case 64: err = launch_f32<64>(q, k, v, out, st, B, H, KV, t_len, s); break;
      case 128: err = launch_f32<128>(q, k, v, out, st, B, H, KV, t_len, s); break;
    }
  } else if (dtype == kFlashBF16) {
    switch (d) {
      case 32: err = launch_tc<32>(q, k, v, out, st, B, H, KV, t_len, s); break;
      case 64: err = launch_tc<64>(q, k, v, out, st, B, H, KV, t_len, s); break;
      case 128: err = launch_tc<128>(q, k, v, out, st, B, H, KV, t_len, s); break;
    }
  }
  return static_cast<int>(err);
}

// Dynamic shared memory a block of the bf16 tensor-core kernel takes at head
// dim d (Q tile, the K/V ring, alignment slack), or -1 for a dim not
// compiled.
extern "C" int repro_flash_tc_smem_bytes(int d) {
  switch (d) {
    case 32: return TcTile<32>::SMEM;
    case 64: return TcTile<64>::SMEM;
    case 128: return TcTile<128>::SMEM;
    default: return -1;
  }
}
