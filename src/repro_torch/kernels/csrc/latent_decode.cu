// Latent decode for multi-head latent attention (MLA): one new token per slot
// attending in latent space with the key up-projection absorbed into the
// query (DeepSeek-V2's absorbed decode).
//
// Replaces no TPU kernel: the reference computes MLA in einsum
// (src/repro/models/mla.py), and so did the port's mla_decode until this
// kernel.  It was added because that plain decode widened the whole bf16
// latent cache [B, C, r] to f32 in every layer and ran its two batched
// products as f32 CUDA-core GEMMs over every row of every slot: on
// Moonlight's 256 slots of 2048 rows the copies and the products were over
// half of the card's busy time in a decode step.
//
// q_lat [B, H, R] (w_uk absorbed), q_rope [B, H, E], the cache c_kv [B, C, R]
// and k_rope [B, C, E] (read in place through their row strides), kv_pos
// [B, C] int32 (the absolute position each row holds, -1 = empty) and cur [B]
// int32 (the query's position) -> out [B, H, R] f32:
//
//     out[b, h] = softmax_s(scale * (q_lat[b, h] . c_kv[b, s] + q_rope[b, h]
//                 . k_rope[b, s])) . c_kv[b, s]
//
// over the rows s with 0 <= kv_pos[b, s] <= cur[b], what the plain version
// computes (kernels/latent_decode.py).  Rows lie at pos % C, so only rows
// [0, min(cur + 1, C)) can hold a valid position: a block scans those and
// masks by kv_pos inside them, the plain version's set of rows.  A masked
// row is never read (its copy zero-fills shared memory).  A slot with no
// valid row gives 0 (the plain version: the mean of its rows); nothing reads
// it.
//
// Bound on the H100: bytes.  A step reads each live latent and rotary row
// once for all H heads (MLA is one kv head with G = H): 2 (r + rope) bytes a
// row against 2 H (r + rope) + 2 H r operations, 30 operations a byte at
// Moonlight's widths and 76 at MiniCPM3's (59 and 146 as the tensor cores
// run them, the weighted sum three times), below the card's ~295.  Moonlight's cell: ~952 live rows of 576
// features a slot, 256 slots, 27 layers, ~7.6 GB a step, 2.3 ms at
// 3.35 TB/s.  What the design does about it:
//
//   - one block per (slot, span of kSpan = 512 rows) takes every head of the
//     slot, so a row crosses HBM once; spans past the slot's live end exit at
//     once, so the grid (fixed by C, as a captured CUDA graph needs) costs
//     only what is live;
//   - the rows stream through a ring of two tiles in shared memory by
//     cp.async (16 bytes a copy), the next tile in flight while one is
//     worked; q_lat | q_rope for the slot's heads are staged once per block;
//   - bf16 q and cache (the served path): 16 warps, and the products on the
//     tensor cores as mma.sync m16n8k16 with f32 accumulators, heads as the
//     M dimension in tiles of 16.  Scores: warp w takes 16 rows of a 64-row
//     tile over a quarter of the r + rope features (the quarters summed
//     through shared memory); each product of two bf16 values is exact in
//     f32, so the scores equal the plain version's f32 products up to
//     summation order.  Weighted sum: warp w owns r / 16 latent features of
//     every head; P is split into three bf16 parts whose sum is P to f32
//     precision (8 + 8 + 8 significant bits, as the SSD scan's 3xTF32), and
//     the three products accumulate into one f32 accumulator, so the weights
//     keep f32 precision as the plain version's f32 softmax does;
//   - f32 q or cache (the f32 parity path of the tests, not a cell's): the
//     same schedule on CUDA cores in f32, 8 warps and 32-row tiles;
//   - an online (flash-decoding) softmax in f32 per head, one max and one
//     rescale a tile, in the log2 domain;
//   - spans: a slot whose live rows fit one span writes out directly; a
//     longer one writes each span's (acc, max, sum) in f32 and
//     latent_merge_kernel combines them in span order.  A span's partial is
//     H r f32 (32 KB at Moonlight's widths) against up to 512 rows of
//     1,152 bytes (590 KB), so at 512-row spans the partials stay a few
//     percent of the latent bytes; shorter spans would spread a slot over
//     more SMs but multiply that traffic, and a cluster merging the spans
//     through distributed shared memory would keep the dead spans' blocks
//     resident until the live ones finish.
//
// Instances: (r, rope) = (512, 64) up to 16 heads (Moonlight, DeepSeek-V2
// Lite) and (256, 32) up to 48 heads (MiniCPM3: 40), each with bf16 q and
// cache (tensor cores), f32 q and f32 cache, f32 q and bf16 cache.  Every sum
// is taken in an order fixed by the row index alone.
//
// Plain C interface, bound from Python with ctypes: the entry point launches
// on the given stream and returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 512;                 // rows a block
constexpr int kMergeThreads = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct LatentArgs {
  const void* q_lat;       // [B, H, R] contiguous
  const void* q_rope;      // [B, H, E] contiguous
  const void* c_kv;        // rows of c_ss elements, slots of c_sb
  const void* k_rope;      // rows of k_ss elements, slots of k_sb
  const int32_t* kv_pos;   // [B, C] by p_sb, p_ss
  const int32_t* cur;      // [B]
  float* out;              // [B, H, R] contiguous
  float* part_o;           // [B, spans, H, R] (spans > 1)
  float* part_ml;          // [B, spans, H, 2]: max (log2 domain), sum
  int H, C, spans;
  int64_t c_sb, c_ss, k_sb, k_ss, p_sb, p_ss;
  float scale_log2;        // scale * log2(e)
};

// The schedule and shared-memory plan of an instance.  Tensor cores: 16
// warps; a 64-row tile's scores by warp (row group w % 4, k-group w / 4), each
// k-group a quarter of the r + rope features, summed through shared memory;
// the weighted sum by warp w's r / 16 features of every head.  CUDA cores: 8
// warps, 32-row tiles, lane = row for the scores, thread t's features
// t + 256 i for the sum.  Both: a ring of two tiles, the next in flight
// while one is worked.  (Measured on the H100 at Moonlight's cell shape and
// lengths: 8 warps took 1.33x as long, 32-row tiles 1.2x, and three to five
// stages of those no less than two.)
// Shared memory: q [kHeads][kLdq], the tiles [kStages][kRows][kLd], scores
// [kSplit][kHeads][kLds] f32, weights (tensor cores: [3][kHeads][kLdp] bf16;
// CUDA cores: [kHeads][kRows] f32), the span's valid-row flags, and each
// head's running max, sum and rescale.  Row strides are 16 bytes past a
// multiple of 128 (an odd number of 16-byte chunks), so that the 8 rows of an
// ldmatrix and the lanes' 16-byte loads down a column fall on distinct banks.
template <typename TQ, typename TC, int R, int E, int HT>
struct Plan {
  static constexpr bool kTC = sizeof(TQ) == 2;
  static constexpr int kWarps = kTC ? 16 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kTC ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kHeads = 16 * HT;
  static constexpr int kK = R + E;
  static constexpr int kLd = kK + 16 / static_cast<int>(sizeof(TC));
  static constexpr int kLdq = kK + 16 / static_cast<int>(sizeof(TQ));
  static constexpr int kGroups = kRows / 16;        // row groups (TC)
  static constexpr int kSplit = kTC ? kWarps / kGroups : 1;
  static constexpr int kLds = kRows + (kTC ? 8 : 0);
  static constexpr int kLdp = kRows + 8;
  static constexpr size_t kQ = 0;
  static constexpr size_t kTile =
      kQ + static_cast<size_t>(kHeads) * kLdq * sizeof(TQ);
  static constexpr size_t kTileBytes =
      static_cast<size_t>(kRows) * kLd * sizeof(TC);
  static constexpr size_t kS = kTile + kStages * kTileBytes;
  static constexpr size_t kP =
      kS + static_cast<size_t>(kSplit) * kHeads * kLds * sizeof(float);
  static constexpr size_t kValid =
      kP + (kTC ? 3 * static_cast<size_t>(kHeads) * kLdp * 2
                : static_cast<size_t>(kHeads) * kRows * sizeof(float));
  static constexpr size_t kState = kValid + kSpan;
  static constexpr size_t kBytes = kState + 3 * kHeads * sizeof(float);
  static_assert(kTile % 16 == 0 && kS % 16 == 0 && kP % 16 == 0 &&
                    kValid % 16 == 0 && kState % 16 == 0,
                "16-byte aligned regions");
  static_assert(kBytes <= 232448, "fits a block's shared memory");
  static_assert(kSpan % kRows == 0 && kRows % 32 == 0 && E % 16 == 0 &&
                    (kTC || R % kThreads == 0) && R % (16 * kWarps) == 0,
                "tiles, warps and fragments divide the shapes");
  static_assert(!kTC || kK / 16 >= kSplit, "a k-step for every k-group");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 8 consecutive elements of shared memory (16- or 32-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy local rows [t * kRows, (t + 1) * kRows) of the span into a tile: each
// row's r latent features then its rope features, a masked or absent row
// zero-filled without a read.
template <typename P, typename TC, int R, int E>
__device__ __forceinline__ void load_tile(const LatentArgs& a, TC* tile,
                                          const uint8_t* valid, int b, int row0,
                                          int t, int tid) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(TC));
  constexpr int CR = R / VEC, CE = E / VEC, CW = CR + CE;
  const TC* cb = static_cast<const TC*>(a.c_kv) + b * a.c_sb;
  const TC* kb = static_cast<const TC*>(a.k_rope) + b * a.k_sb;
  for (int idx = tid; idx < P::kRows * CW; idx += P::kThreads) {
    const int i = idx / CW, c = idx - i * CW;
    const int lr = t * P::kRows + i;
    const bool ok = valid[lr] != 0;
    const int64_t row = row0 + lr;
    const TC* src = c < CR ? cb + row * a.c_ss + c * VEC
                           : kb + row * a.k_ss + (c - CR) * VEC;
    cp_async16(tile + i * P::kLd + c * VEC, ok ? src : cb, ok);
  }
}

// One block per (span, slot): the span's rows of the slot's latent against
// every head of the slot; writes out (a slot of one live span) or the span's
// partial (acc, max, sum).
template <typename TQ, typename TC, int R, int E, int HT>
__global__ void __launch_bounds__((Plan<TQ, TC, R, E, HT>::kThreads), 1)
    latent_attn_kernel(const LatentArgs a) {
  using P = Plan<TQ, TC, R, E, HT>;
  constexpr int NH = P::kHeads;
  constexpr int TR = P::kRows;
  constexpr int NS = P::kStages;
  constexpr int kWarps = P::kWarps;
  constexpr int kThreads = P::kThreads;
  constexpr size_t kTileElems = P::kTileBytes / sizeof(TC);
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem + P::kQ);
  TC* tiles = reinterpret_cast<TC*>(smem + P::kTile);
  float* ss = reinterpret_cast<float*>(smem + P::kS);
  uint8_t* valid = smem + P::kValid;
  float* m_run = reinterpret_cast<float*>(smem + P::kState);
  float* l_run = m_run + NH;
  float* alpha = l_run + NH;

  const int span = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cur = a.cur[b];
  const int live = max(0, min(cur + 1, a.C));
  const int row0 = span * kSpan;
  // span 0 always runs, so that a slot with no row still writes its 0
  if (span > 0 && row0 >= live) return;
  const int n = max(0, min(kSpan, live - row0));
  const int tiles_n = (n + TR - 1) / TR;
  const bool single = live <= kSpan;
  const int H = a.H;
  const int nht = (H + 15) / 16;

  // the span's valid rows, q of every head (zero past H), the state
  const int32_t* pb = a.kv_pos + b * a.p_sb;
  for (int i = tid; i < kSpan; i += kThreads) {
    bool ok = false;
    if (i < n) {
      const int p = pb[static_cast<int64_t>(row0 + i) * a.p_ss];
      ok = p >= 0 && p <= cur;
    }
    valid[i] = ok;
  }
  {
    constexpr int VEC = 16 / static_cast<int>(sizeof(TQ));
    constexpr int CR = R / VEC, CW = CR + E / VEC;
    const TQ* ql = static_cast<const TQ*>(a.q_lat) +
                   static_cast<int64_t>(b) * H * R;
    const TQ* qr = static_cast<const TQ*>(a.q_rope) +
                   static_cast<int64_t>(b) * H * E;
    for (int idx = tid; idx < NH * CW; idx += kThreads) {
      const int h = idx / CW, c = idx - h * CW;
      const bool ok = h < H;
      const TQ* src = c < CR ? ql + h * R + c * VEC : qr + h * E + (c - CR) * VEC;
      cp_async16(qs + h * P::kLdq + c * VEC, ok ? src : ql, ok);
    }
  }
  if (tid < NH) {
    m_run[tid] = kNeg;
    l_run[tid] = 0.0f;
  }
  __syncthreads();                                  // the flags are in
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {                // tiles 0 .. NS - 2
    if (s < tiles_n)
      load_tile<P, TC, R, E>(a, tiles + s * kTileElems, valid, b, row0, s, tid);
    cp_async_commit();
  }

  // the accumulators: tensor cores, warp w's r / 16 features of every head
  // as C fragments; CUDA cores, features tid + 256 i of every head
  constexpr int FW = R / kWarps;                    // features a warp (TC)
  constexpr int NT = FW / 8;                        // their n-tiles
  constexpr int FPT = R / kThreads;                 // features a thread (CC)
  float acc[P::kTC ? HT : 1][P::kTC ? NT : 1][4];
  float accc[P::kTC ? 1 : NH * FPT];
#pragma unroll
  for (int h = 0; h < (P::kTC ? HT : 1); ++h)
#pragma unroll
    for (int nt = 0; nt < (P::kTC ? NT : 1); ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][nt][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (P::kTC ? 1 : NH * FPT); ++i) accc[i] = 0.0f;

  const int g = lane >> 2, c2 = (lane & 3) * 2;     // fragment coordinates

  for (int t = 0; t < tiles_n; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();                                // tile t in, t - 1 done
    // tile t + NS - 1 into the stage tile t - 1 left
    if (t + NS - 1 < tiles_n)
      load_tile<P, TC, R, E>(a, tiles + ((t + NS - 1) % NS) * kTileElems,
                             valid, b, row0, t + NS - 1, tid);
    cp_async_commit();
    const TC* tile = tiles + (t % NS) * kTileElems;

    // --- scores into ss ---------------------------------------------------
    if constexpr (P::kTC) {
      constexpr int KS = P::kK / 16;                // k-steps
      const int rg = warp % P::kGroups, kh = warp / P::kGroups;
      float sc[HT][2][4];
#pragma unroll
      for (int h = 0; h < HT; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[h][j][i] = 0.0f;
      const TC* brow = tile + (rg * 16 + (lane >> 4) * 8 + (lane & 7)) * P::kLd +
                       ((lane >> 3) & 1) * 8;
      const TQ* arow = qs + (lane & 15) * P::kLdq + (lane >> 4) * 8;
#pragma unroll 2
      for (int ks = kh * KS / P::kSplit; ks < (kh + 1) * KS / P::kSplit;
           ++ks) {
        uint32_t bf[4];
        ldsm_x4(bf, brow + ks * 16);
#pragma unroll
        for (int h = 0; h < HT; ++h) {
          if (h < nht) {
            uint32_t af[4];
            ldsm_x4(af, arow + h * 16 * P::kLdq + ks * 16);
            mma_bf16(sc[h][0], af, bf[0], bf[1]);
            mma_bf16(sc[h][1], af, bf[2], bf[3]);
          }
        }
      }
      float* sp = ss + kh * NH * P::kLds;
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        if (h < nht) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = rg * 16 + j * 8 + c2;
            *reinterpret_cast<float2*>(sp + (h * 16 + g) * P::kLds + col) =
                make_float2(sc[h][j][0], sc[h][j][1]);
            *reinterpret_cast<float2*>(sp + (h * 16 + g + 8) * P::kLds + col) =
                make_float2(sc[h][j][2], sc[h][j][3]);
          }
        }
      }
    } else {
      // lane = row; warp w's heads w, w + 8, ...
      constexpr int HPW = NH / kWarps;
      float sc[HPW];
#pragma unroll
      for (int i = 0; i < HPW; ++i) sc[i] = 0.0f;
      const TC* row = tile + lane * P::kLd;
      for (int k = 0; k < P::kK; k += 8) {
        float x[8];
        load8(row + k, x);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          float qv[8];
          load8(qs + (warp + i * kWarps) * P::kLdq + k, qv);
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[i] = fmaf(qv[e], x[e], sc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < HPW; ++i)
        ss[(warp + i * kWarps) * P::kLds + lane] = sc[i];
    }
    __syncthreads();                                // scores in

    // --- online softmax: warp w takes heads w, w + kWarps, ... --------------
    for (int h = warp; h < NH; h += kWarps) {
      constexpr int RPL = TR / 32;                  // rows a lane
      float s[RPL];
      bool ok[RPL];
      float mx = kNeg;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int j = lane + 32 * q;
        const int lr = t * TR + j;
        ok[q] = h < H && lr < n && valid[lr];
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < P::kSplit; ++k) v += ss[(k * NH + h) * P::kLds + j];
        s[q] = v * a.scale_log2;
        if (ok[q]) mx = fmaxf(mx, s[q]);
      }
      mx = warp_max(mx);
      const float m_old = m_run[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < RPL; ++q) {
        const int j = lane + 32 * q;
        const float p = ok[q] ? exp2f(s[q] - m_new) : 0.0f;
        sum += p;
        if constexpr (P::kTC) {
          // P as three bf16 parts whose sum is P to f32 precision
          __nv_bfloat16* pp = reinterpret_cast<__nv_bfloat16*>(smem + P::kP);
          const __nv_bfloat16 p1 = __float2bfloat16(p);
          const float r1 = p - __bfloat162float(p1);
          const __nv_bfloat16 p2 = __float2bfloat16(r1);
          const __nv_bfloat16 p3 = __float2bfloat16(r1 - __bfloat162float(p2));
          pp[h * P::kLdp + j] = p1;
          pp[(NH + h) * P::kLdp + j] = p2;
          pp[(2 * NH + h) * P::kLdp + j] = p3;
        } else {
          reinterpret_cast<float*>(smem + P::kP)[h * TR + j] = p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = exp2f(m_old - m_new);
        alpha[h] = al;
        m_run[h] = m_new;
        l_run[h] = l_run[h] * al + sum;
      }
    }
    __syncthreads();                                // weights in

    // --- weighted sum of the latent rows -----------------------------------
    if constexpr (P::kTC) {
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        const float a0 = alpha[h * 16 + g], a1 = alpha[h * 16 + g + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[h][nt][0] *= a0;
          acc[h][nt][1] *= a0;
          acc[h][nt][2] *= a1;
          acc[h][nt][3] *= a1;
        }
      }
      const __nv_bfloat16* pw = reinterpret_cast<const __nv_bfloat16*>(smem + P::kP);
      const TC* vrow = tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * P::kLd +
                       warp * FW + (lane >> 4) * 8;
      const __nv_bfloat16* prow = pw + (lane & 15) * P::kLdp + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < TR / 16; ++kk) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, vrow + kk * 16 * P::kLd + np * 16);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int part = 0; part < 3; ++part) {
#pragma unroll
          for (int h = 0; h < HT; ++h) {
            if (h < nht) {
              uint32_t af[4];
              ldsm_x4(af, prow + (part * NH + h * 16) * P::kLdp + kk * 16);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[h][nt], af, bf[nt][0], bf[nt][1]);
            }
          }
        }
      }
    } else {
      const float* pw = reinterpret_cast<const float*>(smem + P::kP);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float al = alpha[h];
#pragma unroll
        for (int f = 0; f < FPT; ++f) accc[h * FPT + f] *= al;
      }
      for (int j = 0; j < TR; ++j) {
        float c[FPT];
#pragma unroll
        for (int f = 0; f < FPT; ++f)
          c[f] = to_float(tile[j * P::kLd + tid + f * kThreads]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float p = pw[h * TR + j];
#pragma unroll
          for (int f = 0; f < FPT; ++f)
            accc[h * FPT + f] = fmaf(p, c[f], accc[h * FPT + f]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // --- out, or the span's partial -------------------------------------------
  // (m_run and l_run are final: a barrier followed their last update, or
  // their initialisation when no tile ran)
  float* ob;
  if (single) {
    ob = a.out + static_cast<int64_t>(b) * H * R;
  } else {
    ob = a.part_o + (static_cast<int64_t>(b) * a.spans + span) * H * R;
    if (tid < H) {
      float* ml = a.part_ml + ((static_cast<int64_t>(b) * a.spans + span) * H +
                               tid) * 2;
      ml[0] = m_run[tid];
      ml[1] = l_run[tid];
    }
  }
  auto norm = [&](int h) {
    const float l = l_run[h];
    return !single ? 1.0f : (l > 0.0f ? 1.0f / l : 0.0f);
  };
  if constexpr (P::kTC) {
#pragma unroll
    for (int h = 0; h < HT; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int head = h * 16 + g + half * 8;
        if (head < H) {
          const float z = norm(head);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            *reinterpret_cast<float2*>(ob + head * R + warp * FW + nt * 8 + c2) =
                make_float2(acc[h][nt][half * 2] * z,
                            acc[h][nt][half * 2 + 1] * z);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (h < H) {
        const float z = norm(h);
#pragma unroll
        for (int f = 0; f < FPT; ++f)
          ob[h * R + tid + f * kThreads] = accc[h * FPT + f] * z;
      }
    }
  }
}

// One block per (head, slot) of a slot whose live rows span more than one
// span: the spans' partials merged in span order; a span with no valid row
// (max -1e30, sum 0, acc 0) adds exactly 0.
__global__ void __launch_bounds__(kMergeThreads)
    latent_merge_kernel(const LatentArgs a, int R) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int live = max(0, min(a.cur[b] + 1, a.C));
  const int ns = (live + kSpan - 1) / kSpan;
  if (ns <= 1) return;
  const int64_t base = static_cast<int64_t>(b) * a.spans;
  float mx = kNeg;
  for (int s = 0; s < ns; ++s)
    mx = fmaxf(mx, a.part_ml[((base + s) * a.H + h) * 2]);
  float sum = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const float* ml = a.part_ml + ((base + s) * a.H + h) * 2;
    sum += ml[1] * exp2f(ml[0] - mx);
  }
  const float z = sum > 0.0f ? 1.0f / sum : 0.0f;
  float* ob = a.out + (static_cast<int64_t>(b) * a.H + h) * R;
  for (int f = threadIdx.x * 4; f < R; f += kMergeThreads * 4) {
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < ns; ++s) {
      const float c = exp2f(a.part_ml[((base + s) * a.H + h) * 2] - mx);
      const float4 v = *reinterpret_cast<const float4*>(
          a.part_o + ((base + s) * a.H + h) * R + f);
      o.x = fmaf(v.x, c, o.x);
      o.y = fmaf(v.y, c, o.y);
      o.z = fmaf(v.z, c, o.z);
      o.w = fmaf(v.w, c, o.w);
    }
    *reinterpret_cast<float4*>(ob + f) =
        make_float4(o.x * z, o.y * z, o.z * z, o.w * z);
  }
}

template <typename TQ, typename TC, int R, int E, int HT>
int launch_instance(const LatentArgs& a, int B, cudaStream_t stream) {
  using P = Plan<TQ, TC, R, E, HT>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        latent_attn_kernel<TQ, TC, R, E, HT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(P::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(static_cast<unsigned>(a.spans), static_cast<unsigned>(B));
  latent_attn_kernel<TQ, TC, R, E, HT>
      <<<grid, P::kThreads, P::kBytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.spans == 1) return static_cast<int>(err);
  const dim3 mgrid(static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  latent_merge_kernel<<<mgrid, kMergeThreads, 0, stream>>>(a, R);
  return static_cast<int>(cudaGetLastError());
}

// the instance by (r, rope) and heads; anything else is refused
template <typename TQ, typename TC>
int launch(const LatentArgs& a, int B, int R, int E, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (R == 512 && E == 64 && a.H <= 16)
    return launch_instance<TQ, TC, 512, 64, 1>(a, B, stream);
  if (R == 256 && E == 32 && a.H <= 48)
    return launch_instance<TQ, TC, 256, 32, 3>(a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int latent_decode_span_rows() { return kSpan; }

#define LATENT_ENTRY(NAME, TQ, TC)                                             \
  extern "C" int NAME(const void* q_lat, const void* q_rope, const void* c_kv, \
                      const void* k_rope, const void* kv_pos, const void* cur, \
                      void* out, void* part_o, void* part_ml, int B, int H,    \
                      int C, int R, int E, int spans, int64_t c_sb,            \
                      int64_t c_ss, int64_t k_sb, int64_t k_ss, int64_t p_sb,  \
                      int64_t p_ss, float scale, void* stream) {               \
    LatentArgs a{q_lat,                                                        \
                 q_rope,                                                       \
                 c_kv,                                                         \
                 k_rope,                                                       \
                 static_cast<const int32_t*>(kv_pos),                          \
                 static_cast<const int32_t*>(cur),                             \
                 static_cast<float*>(out),                                     \
                 static_cast<float*>(part_o),                                  \
                 static_cast<float*>(part_ml),                                 \
                 H,                                                            \
                 C,                                                            \
                 spans,                                                        \
                 c_sb,                                                         \
                 c_ss,                                                         \
                 k_sb,                                                         \
                 k_ss,                                                         \
                 p_sb,                                                         \
                 p_ss,                                                         \
                 scale * kLog2e};                                              \
    return launch<TQ, TC>(a, B, R, E, stream);                                 \
  }

LATENT_ENTRY(latent_decode_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
LATENT_ENTRY(latent_decode_f32_f32, float, float)
LATENT_ENTRY(latent_decode_f32_bf16, float, __nv_bfloat16)

extern "C" const char* latent_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
