// Flash-decode: one new token per slot against a contiguous or ring KV cache,
// or against a shared paged block pool read in place through a block table;
// and n new tokens per slot against a contiguous cache (the speculative
// verify chunk).
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:_decode_kernel
// (entry decode_attention) and :_paged_kernel (entry paged_decode_attention).
// The chunk entry (decode_attention_chunk) is the port's own: the reference
// attends the verify chunk in einsum (src/repro/models/attention.py:446); the
// port runs it on this body so that row j of a chunk attends with the single
// query's numerics.
// q [B, H, hd], k/v [B, K, S, hd] (GQA: query head h reads kv head h / G,
// G = H / K), kv_pos [B, S] int32 (absolute position held in each cache row,
// -1 = empty), cur [B] int32 (the query's position) -> out [B, H, hd] in q's
// type.  Key s is valid for slot b when
//
//     kv_pos >= 0  &&  kv_pos <= cur  &&  (window == 0 || cur - kv_pos < window)
//
// and out = softmax(q.k / sqrt(hd)) . v over the valid keys, all in f32, with
// the TPU kernel's constants: the running max starts at -1e30 and the sum is
// floored at 1e-30 before the division.  Every tensor is read through its
// strides (the last dimension contiguous), so the model's BSHD cache
// [B, C, K, hd] is read in place through a transposed view.
//
// The paged layout: k/v are one pool [NB, bs, K, hd] shared by every slot,
// its blocks back to back (block stride = bs * row stride), tbl [B, MB]
// int32 maps slot b's logical block j to a pool block, and S is the logical
// extent MB' * bs (MB' <= MB).  Logical row s of slot b is pool row
// tbl[b, s / bs] * bs + s % bs.  Unmapped entries point at the trash block 0,
// whose rows are never valid by kv_pos; the table entry of a row is read
// only when the row is valid.
//
// Design: split-span flash-decode, one schedule for both layouts and three
// bodies, chosen by what a call's shape is (launch() below): the narrow body
// at G = 1 and hd <= 128, the GQA body at G > 1 and hd <= 128, the wide body
// above hd 128.  The logical rows are cut into spans whose length is a
// function of the head dim alone: kSpan = 1024 rows at hd <= 128, kSpanWide
// = 128 rows above.
//
// The narrow body (G = 1, hd <= 128: stablelm's 32 heads of 80, whisper's 16
// of 64): one block of 256 threads (8 warps) runs per (slot, query head,
// span), so a long cache spreads over many SMs even for one slot.  Inside a
// span the rows are interleaved finely over the warps: of every 32 rows,
// warp w takes rows 4w .. 4w + 3, its four 8-lane subgroups one row each, so
// the 17 to 31 valid rows of a served slot land on all 8 warps.  A warp works
// a tile of two such groups at once (8 rows):
// each lane reads its rows' kv_pos (and on the paged layout works out the
// pool row from the table, once per row), skips the tile when no row is
// valid, loads
// every valid row's K and V chunks before using any (16-byte loads: a hd-80
// bf16 row is 10 chunks over 8 lanes), reduces each row's score over its
// subgroup, and folds the tile into its online (max, sum, acc) with ONE max
// and ONE rescale per tile, not per key.  Each subgroup keeps a partial acc
// over its own rows (the tile's max and sum are shared by the warp); the
// partials are summed at the end, then the 8 warps' states are merged through
// shared memory in warp order.  A span whose cache is one span long writes
// out directly: one launch, no scratch.  Longer caches write each span's
// (max, sum, acc) in f32 to scratch [B, H, spans, hd + 2] that the wrapper
// allocates, and combine_kernel merges the spans in span order.
//
// The GQA body (G > 1, hd <= 128: granite's 24 over 8 heads of 64, G = 6 and
// 16 at 128, the smoke configurations' G = 2 and 4): the narrow body took
// groups of 4 query heads with 4 x 16 accumulators a thread whatever G and
// hd were, and each warp's tile was a serial chain (kv_pos, then the rows'
// loads, then the arithmetic), so that few bytes were in flight per SM:
// granite's decode attention ran at 17.6 % of its roofline.  Here one block
// takes every query head of its kv head (up to 16), so a K/V row crosses HBM
// once per kv head; each warp reads its rows' kv_pos (and table entries) for
// the whole span up front, then streams its valid rows' K and V through its
// own ring of shared-memory tiles by cp.async, the next tile in flight while
// one is worked, with no barrier across warps until the end; and the
// registers are sized at compile time by head-dim bucket (64, 128) and G
// bucket (4, 8, 16) (kernel decode_kernel_gqa below sets out its schedule).
//
// The wide body (hd > 128: recurrentgemma's and paligemma's 256, G = 10 and 8
// over one kv head): the narrow body's accumulators, 4 heads x 32 dims a
// thread, took 227 registers there, its groups of 4 heads read each row
// three times at G = 10, and its 1024-row spans gave a 2048-row ring of 8
// slots 48 blocks for 132 SMs.  So one block takes every query head of its
// kv head (up to 16), the accumulators are spread over the threads by head
// dim (16 a thread), and the span is 128 rows: the ring makes 128 blocks,
// each reading its 128 rows' K and V once, through shared memory (kernel
// decode_wide_kernel below sets out its schedule).
//
// The chunk: q [B, n, H, hd] and out [B, n, H, hd], cur = start [B], query
// row j of slot b at position start[b] + j.  The grid runs over the B * n
// query rows; a query row reads q, writes out (and its spans' scratch rows)
// by its own index and k, v, kv_pos by its slot, and goes through the same
// code as a single query at that position: row j of a chunk equals, byte for
// byte, the single-query kernel at cur = start + j over the same cache.  Its
// K/V rows are read once per query row, not shared across the n rows.
//
// Invariance: the span boundaries, the tiles and every sum's order are
// functions of the logical row index alone, and a masked or absent row, a
// skipped tile and an empty warp or span merge as exact no-ops
// (expf(-1e30 - m) = 0, x * 1.0 and x + 0 are exact).  So the result's bytes
// depend only on the valid rows and their values: not on S, on how many
// trailing spans are empty, on the layout or on the block size.  The paged
// kernel equals the contiguous kernel run over the gathered rows (the gather
// shim) for any block size, and a cache of one span equals the same rows in
// a mostly empty cache of many.  Masked keys are skipped, not loaded: a row
// that no query may see is never read, and a slot with no valid key (an
// empty slot, whose output nothing reads) gives 0, where the TPU kernel
// gives the mean of its masked rows; both are finite.
//
// Bound on the H100: bytes.  One token's attention does 4 FLOPs per cached
// element it reads, far below the card's ratio of ~295 operations per byte,
// so its least time is the valid K/V rows (plus q, kv_pos, the table and out)
// over HBM bandwidth (3.35 TB/s on the SXM part).  What the design does about
// it: masked rows are skipped; each row is read once for all the query
// heads of its kv head (the narrow body has one); 16-byte loads with 8 rows
// per warp in flight (the GQA body: each warp's next tile copied to shared
// memory by cp.async while one is worked; the wide body: the span's valid
// rows in flight before the first tile is worked); and spans put
// B * K * groups * spans blocks on the card, so that one user's
// 8192-row context fills 132 SMs where a block per (slot, head) gave 32.  At the
// serving shape (17-31 valid rows of 128) the launch, not the bytes, is the
// cost; the CUDA-graph-captured decode step is the later work there.
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns cudaGetLastError() right after the launch
// (after the combine's launch, when there is one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 256;
constexpr int kSpan = 1024;                // logical rows per span, hd <= 128
constexpr int kSpanWide = 128;             // and at hd > 128 (the wide body)
constexpr int kTileWide = 32;              // rows per tile of the wide body
constexpr int kHeadsWide = 16;             // its query heads per block, at most
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_pos;
  const int32_t* cur;
  void* out;
  int H, K, S, hd;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t p_sb, p_ss;
  int64_t o_sb, o_sh;
  float scale;
  int window;
  // the paged pool only (tbl == nullptr on the contiguous layout): k/v point
  // at the pool, k_sb = v_sb = 0 and k_ss / v_ss step a pool row; slot b's
  // table row is tbl + b * t_sb, entry j at j * t_sj
  const int32_t* tbl;
  int bs;
  int bs_shift;      // log2(bs) when bs is a power of two, else -1
  int64_t t_sb, t_sj;
  // spans: 1 writes out directly; more write part [rows, H, spans, hd + 2]
  int spans;
  float* part;
  // query rows per slot: 1 (one token), or the chunk's n, with q and out
  // stepping a slot's rows by q_sn / o_sn
  int nq;
  int64_t q_sn, o_sn;
  // the GQA body: q and out are f32 (else bf16), so that its instances are
  // by the cache's type alone
  bool q_f32;
};

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements per chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte chunk as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  constexpr int NH = 1;                       // query heads per block
  constexpr int VEC = kVec<TKV>;
  constexpr int DPL = 16;                     // head dims per lane (hd <= 128)
  constexpr int CH = DPL / VEC;               // chunks per lane and row
  constexpr int RJ = 2;                       // rows per lane and tile
  __shared__ float qs[NH][kMaxHd];
  __shared__ float sm_m[kWarps][NH];
  __shared__ float sm_l[kWarps][NH];
  __shared__ float sm_acc[kWarps][NH][kMaxHd];

  const int r = blockIdx.x;                   // query row: slot b, query j
  const int b = r / a.nq;
  const int jq = r - b * a.nq;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int grp = blockIdx.z / a.spans;
  const int sp = blockIdx.z - grp * a.spans;
  const int g0 = grp * NH;
  const int ng = min(NH, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane >> 3;                  // the subgroup's row of 4
  const int sl = lane & 7;                    // lane within the subgroup
  const int hd = a.hd;
  const int nchunk = hd / VEC;
  const int cur = a.cur[b] + jq;

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + jq * a.q_sn;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int32_t* pb = a.kv_pos + b * a.p_sb;
  const int32_t* tb = kPaged ? a.tbl + b * a.t_sb : nullptr;

  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    qs[g][d] = to_float(qb[(kh * G + g0 + g) * a.q_sh + d]) * a.scale;
  }
  __syncthreads();

  float m[NH], l[NH], acc[NH][DPL];
#pragma unroll
  for (int g = 0; g < NH; ++g) {
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;
  }

  const int s_begin = sp * kSpan;
  const int s_end = min(a.S, s_begin + kSpan);
  for (int base = s_begin; base < s_end; base += 32 * RJ) {
    bool ok[RJ];
    int64_t row[RJ];  // the row to read: the cache row or the pool row
    bool any = false;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int s = base + 32 * j + 4 * warp + sub;
      ok[j] = false;
      row[j] = s;
      if (s < s_end) {
        const int kp = pb[s * a.p_ss];
        ok[j] = kp >= 0 && kp <= cur && (a.window == 0 || cur - kp < a.window);
        if constexpr (kPaged) {
          if (ok[j]) {
            const int blk = a.bs_shift >= 0 ? s >> a.bs_shift : s / a.bs;
            row[j] = static_cast<int64_t>(tb[blk * a.t_sj]) * a.bs + s -
                     blk * a.bs;
          }
        }
      }
      any |= ok[j];
    }
    if (!__any_sync(kFull, any)) continue;

    // every valid row's chunks in flight before any is used
    uint4 kr[RJ][CH], vr[RJ][CH];
#pragma unroll
    for (int j = 0; j < RJ; ++j)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int chunk = sl + 8 * c;
        if (ok[j] && chunk < nchunk) {
          kr[j][c] = *reinterpret_cast<const uint4*>(kb + row[j] * a.k_ss +
                                                     chunk * VEC);
          vr[j][c] = *reinterpret_cast<const uint4*>(vb + row[j] * a.v_ss +
                                                     chunk * VEC);
        } else {
          kr[j][c] = make_uint4(0u, 0u, 0u, 0u);
          vr[j][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }

#pragma unroll
    for (int g = 0; g < NH; ++g) {
      if (g >= ng) break;
      // each row's score over its subgroup, the same bits in all 8 lanes
      float s[RJ];
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[j] = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int chunk = sl + 8 * c;
        if (chunk < nchunk) {
          float qv[VEC];
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(&qs[g][chunk * VEC + e]);
            qv[e] = f.x;
            qv[e + 1] = f.y;
            qv[e + 2] = f.z;
            qv[e + 3] = f.w;
          }
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            float kx[VEC];
            unpack(kr[j][c], kx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[j] = fmaf(qv[e], kx[e], s[j]);
          }
        }
      }
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) s[j] += __shfl_xor_sync(kFull, s[j], o);
        s[j] = ok[j] ? s[j] : kNeg;
        mt = fmaxf(mt, s[j]);
      }
      // ONE max and ONE rescale for the warp's tile
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 16));
      const float m_new = fmaxf(m[g], mt);
      const float corr = expf(m[g] - m_new);
      float p[RJ];
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        p[j] = expf(s[j] - m_new);
        psum += p[j];
      }
      psum += __shfl_xor_sync(kFull, psum, 8);
      psum += __shfl_xor_sync(kFull, psum, 16);
      l[g] = l[g] * corr + psum;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][c * VEC + e] *= corr;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          float vx[VEC];
          unpack(vr[j][c], vx);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][c * VEC + e] = fmaf(p[j], vx[e], acc[g][c * VEC + e]);
        }
      }
    }
  }

  // the subgroups' partial accs, then the warps' states through shared memory
#pragma unroll
  for (int g = 0; g < NH; ++g) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], 8);
      acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], 16);
    }
    if (g < ng) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
      if (sub == 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int chunk = sl + 8 * c;
          if (chunk < nchunk) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              sm_acc[warp][g][chunk * VEC + e] = acc[g][c * VEC + e];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      sum += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    const int h = kh * G + g0 + g;
    if (a.spans == 1) {
      TQ* ob = static_cast<TQ*>(a.out) + b * a.o_sb + jq * a.o_sn;
      store(ob + h * a.o_sh + d, num / fmaxf(sum, 1e-30f));
    } else {
      float* pp =
          a.part + ((static_cast<int64_t>(r) * a.H + h) * a.spans + sp) *
                       (hd + 2);
      pp[d] = num;
      if (d == 0) {
        pp[hd] = mx;
        pp[hd + 1] = sum;
      }
    }
  }
}

// merges the spans of one (query row, query head) in span order; a span with
// no valid row (max -1e30, sum 0, acc 0) adds exactly 0
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const DecodeArgs a) {
  const int r = blockIdx.x;
  const int b = r / a.nq;
  const int jq = r - b * a.nq;
  const int h = blockIdx.y;
  const int hd = a.hd;
  const float* pp =
      a.part + (static_cast<int64_t>(r) * a.H + h) * a.spans * (hd + 2);
  float mx = kNeg;
  for (int sp = 0; sp < a.spans; ++sp) mx = fmaxf(mx, pp[sp * (hd + 2) + hd]);
  TQ* ob =
      static_cast<TQ*>(a.out) + b * a.o_sb + jq * a.o_sn + h * a.o_sh;
  for (int d = threadIdx.x; d < hd; d += kCombineThreads) {
    float sum = 0.0f, num = 0.0f;
    for (int sp = 0; sp < a.spans; ++sp) {
      const float* s = pp + sp * (hd + 2);
      const float c = expf(s[hd] - mx);
      sum += s[hd + 1] * c;
      num += s[d] * c;
    }
    store(ob + d, num / fmaxf(sum, 1e-30f));
  }
}

// The wide body (hd > 128): one block per (query row, kv head, group of up
// to 16 query heads, span of kSpanWide rows), every query head of a kv head
// in one block, so each K/V row is read once for all of them.  The last
// warp first reads the span's kv_pos (and on the paged layout its table
// entries) and leaves each 32-row tile's valid-row mask and row addresses
// in shared memory, while every warp stages q (all of a thread's reads
// issued before any is used); every valid row's K and V are then copied
// into a ring of two tile stages by cp.async (16 bytes a copy), the next
// tile's copies in flight while a tile is worked (four bf16 stages, the
// whole span in flight, measured no faster on recurrentgemma's ring).  A
// tile is worked in three steps, each thread's registers holding what it
// reuses, so that shared memory is read far less often than the products
// are taken:
//   A. warp w takes tile rows 4w .. 4w + 3 and lane i head dims 4i .. 4i + 3
//      and 128 + 4i .. 128 + 4i + 3 of every head: the four rows' K values
//      stay in registers while each head's q values are read once for the
//      four rows (both reads free of bank conflicts); the 4 x 16 partial
//      scores are then summed over the 32 lanes by a butterfly that leaves
//      lane i with rows and heads (i / 8, 2 (i % 8)) and (i / 8,
//      2 (i % 8) + 1);
//   B. warp w runs the online softmax of heads w and w + 8 over the tile's
//      32 scores (lane = row): one max and one rescale per head and tile,
//      the weights back into shared memory;
//   C. thread t owns head dims 4 (t % 64) .. + 3 of heads t / 64 + 4i: it
//      rescales its 16 accumulators and adds the tile's valid rows in row
//      order, each V chunk read once for its four heads.
// A tile no row of which is valid is neither copied nor worked, and the
// tiles past the last one with a valid row are not visited.  Every
// sum's order is a function of the logical row index alone, as in the
// narrow body, and a span writes the same (max, sum, acc) triple to the
// same scratch for the same combine.
constexpr int kStagesWide = 2;             // K/V tiles in flight

template <typename TKV>
__host__ __device__ constexpr size_t smem_wide() {
  return static_cast<size_t>(kStagesWide) * 2 * kTileWide * kMaxHd *
         sizeof(TKV);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one level of a butterfly over the first N of a lane's values: a lane
// keeps the upper half where its bit `o` is set, else the lower, and adds
// the lane across's half to it
template <int N, int M>
__device__ __forceinline__ void fold(float (&v)[M], bool upper, int o) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float give = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, give, o);
  }
}

// 4 consecutive elements of shared memory as floats (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = c.x;
  x[3] = c.y;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_wide_kernel(const DecodeArgs a) {
  constexpr int VEC = kVec<TKV>;
  constexpr int HW = kHeadsWide;
  constexpr int HPW = HW / kWarps;            // heads per warp in step B
  constexpr int HPT = HW / 4;                 // heads per thread in step C
  constexpr int NT = kSpanWide / kTileWide;   // tiles per span
  constexpr int NS = kStagesWide;
  static_assert(kThreads == 256 && kTileWide == 32 && HW == 16,
                "the step A butterfly and the step C split assume these");
  extern __shared__ uint4 kv_raw[];           // NS x (K tile, V tile)
  __shared__ __align__(16) float qs[HW][kMaxHd];
  __shared__ __align__(16) float ps[HW][kTileWide];
  __shared__ float corr_s[HW], m_s[HW], l_s[HW];
  __shared__ int64_t row_s[NT][kTileWide];    // the row each tile row reads
  __shared__ unsigned mask_s[NT];             // each tile's valid rows

  const int r = blockIdx.x;                   // query row: slot b, query j
  const int b = r / a.nq;
  const int jq = r - b * a.nq;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int grp = blockIdx.z / a.spans;
  const int sp = blockIdx.z - grp * a.spans;
  const int g0 = grp * HW;
  const int ng = min(HW, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hd = a.hd;
  const int cur = a.cur[b] + jq;
  const int s_begin = sp * kSpanWide;
  const int s_end = min(a.S, s_begin + kSpanWide);
  const int tile_elems = kTileWide * hd;      // a K or V tile, elements
  TKV* kv_s = reinterpret_cast<TKV*>(kv_raw);

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + jq * a.q_sn;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // every read of the prologue is issued before any is used: the last
  // warp's kv_pos (lane t: row t of every tile), then everyone's q
  int kp[NT];
  if (warp == kWarps - 1) {
    const int32_t* pb = a.kv_pos + b * a.p_sb;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int s = s_begin + kTileWide * j + lane;
      kp[j] = s < s_end ? pb[s * a.p_ss] : -1;
    }
  }
  // thread d stages head dim d of every head (hd <= kThreads)
  float qv[HW];
#pragma unroll
  for (int g = 0; g < HW; ++g)
    qv[g] = g < ng && threadIdx.x < hd
                ? to_float(qb[(kh * G + g0 + g) * a.q_sh + threadIdx.x])
                : 0.0f;
  if (warp == kWarps - 1) {
    // each tile row's validity and the row to read; on the paged layout
    // every valid row's table entry read before any is used
    bool ok[NT];
    int blk[NT], ent[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int s = s_begin + kTileWide * j + lane;
      ok[j] = kp[j] >= 0 && kp[j] <= cur &&
              (a.window == 0 || cur - kp[j] < a.window);
      if constexpr (kPaged) {
        blk[j] = a.bs_shift >= 0 ? s >> a.bs_shift : s / a.bs;
        ent[j] = ok[j] ? a.tbl[b * a.t_sb + blk[j] * a.t_sj] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int s = s_begin + kTileWide * j + lane;
      int64_t row = s;
      if constexpr (kPaged) {
        if (ok[j])
          row = static_cast<int64_t>(ent[j]) * a.bs + s - blk[j] * a.bs;
      }
      row_s[j][lane] = row;
      const unsigned m = __ballot_sync(kFull, ok[j]);
      if (lane == 0) mask_s[j] = m;
    }
  }
#pragma unroll
  for (int g = 0; g < HW; ++g)
    if (g < ng && threadIdx.x < hd) qs[g][threadIdx.x] = qv[g] * a.scale;
  __syncthreads();

  // the tiles up to the last one with a valid row
  int nt = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (mask_s[j]) nt = j + 1;

  // tile j's valid rows into stage j % NS, one commit group per tile
  const int nchunk = hd / VEC;
  auto issue = [&](int j) {
    if (j < nt) {
      const unsigned mask = mask_s[j];
      TKV* kd = kv_s + (j % NS) * 2 * tile_elems;
      TKV* vd = kd + tile_elems;
      for (int i = threadIdx.x; i < kTileWide * nchunk; i += kThreads) {
        const int t = i / nchunk;
        const int c = i - t * nchunk;
        if ((mask >> t) & 1u) {
          const int64_t row = row_s[j][t];
          cp_async16(kd + t * hd + c * VEC, kb + row * a.k_ss + c * VEC);
          cp_async16(vd + t * hd + c * VEC, vb + row * a.v_ss + c * VEC);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);

  // step A's head dims (da and 128 + da; hd > 128), step C's dims and heads
  const int da = 4 * lane;
  const bool a_hi = 128 + da < hd;
  const int dc = 4 * (threadIdx.x & 63);
  const int hc = threadIdx.x >> 6;
  const bool c_live = dc < hd;
  float m[HPW], l[HPW], acc[HPT][4];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < HPT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int j = 0; j < nt; ++j) {
    if (j > 0) __syncthreads();   // tile j - 1's stage and ps are free
    issue(j + NS - 1);
    cp_async_wait<NS - 1>();      // this thread's copies of tile j are in
    __syncthreads();              // and every thread's
    const unsigned mask = mask_s[j];
    if (mask == 0) continue;      // the same in every thread
    const TKV* kt = kv_s + (j % NS) * 2 * tile_elems;
    const TKV* vt = kt + tile_elems;

    // A: rows 4 warp .. + 3, head dims da .. da + 7, every head
    float v[4 * HW];              // index row * 16 + head
#pragma unroll
    for (int i = 0; i < 4 * HW; ++i) v[i] = 0.0f;
    {
      float kx[4][8];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const TKV* kr = kt + (4 * warp + rr) * hd + da;
        float lo[4], hi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        load4(kr, lo);
        if (a_hi) load4(kr + 128, hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kx[rr][e] = lo[e];
          kx[rr][4 + e] = hi[e];
        }
      }
#pragma unroll
      for (int g = 0; g < HW; ++g) {
        if (g >= ng) break;
        float qx[8];
        const float4 f = *reinterpret_cast<const float4*>(&qs[g][da]);
        const float4 h = a_hi ? *reinterpret_cast<const float4*>(
                                    &qs[g][128 + da])
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        qx[0] = f.x, qx[1] = f.y, qx[2] = f.z, qx[3] = f.w;
        qx[4] = h.x, qx[5] = h.y, qx[6] = h.z, qx[7] = h.w;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float sc = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) sc = fmaf(qx[e], kx[rr][e], sc);
          v[rr * HW + g] = sc;
        }
      }
    }
    // the butterfly: each level keeps half of the values, summed with the
    // lane across; lane i ends with indices 2i and 2i + 1
    fold<64>(v, lane & 16, 16);
    fold<32>(v, lane & 8, 8);
    fold<16>(v, lane & 4, 4);
    fold<8>(v, lane & 2, 2);
    fold<4>(v, lane & 1, 1);
    {
      const int rr = lane >> 3;
      const int g = 2 * (lane & 7);
      const bool tok = (mask >> (4 * warp + rr)) & 1u;
      if (g < ng) ps[g][4 * warp + rr] = tok ? v[0] : kNeg;
      if (g + 1 < ng) ps[g + 1][4 * warp + rr] = tok ? v[1] : kNeg;
    }
    __syncthreads();

    // B: the online softmax of this warp's heads over the tile
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + kWarps * i;
      if (g < ng) {
        const float sv = ps[g][lane];
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float c = expf(m[i] - m_new);
        const float p = expf(sv - m_new);
        l[i] = l[i] * c + warp_sum(p);
        m[i] = m_new;
        ps[g][lane] = p;
        if (lane == 0) corr_s[g] = c;
      }
    }
    __syncthreads();

    // C: head dims dc .. dc + 3 of heads hc + 4i, the valid rows in order
    if (c_live) {
#pragma unroll
      for (int i = 0; i < HPT; ++i) {
        const int g = hc + 4 * i;
        if (g < ng) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= corr_s[g];
        }
      }
#pragma unroll
      for (int t4 = 0; t4 < kTileWide; t4 += 4) {
        const unsigned m4 = (mask >> t4) & 0xfu;
        if (m4 == 0) continue;
        float vx[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((m4 >> u) & 1u) load4(vt + (t4 + u) * hd + dc, vx[u]);
        }
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          const int g = hc + 4 * i;
          if (g >= ng) break;
          const float4 p4 = *reinterpret_cast<const float4*>(&ps[g][t4]);
          const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if ((m4 >> u) & 1u) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][e] = fmaf(pu[u], vx[u][e], acc[i][e]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + kWarps * i;
    if (g < ng && lane == 0) {
      m_s[g] = m[i];
      l_s[g] = l[i];
    }
  }
  __syncthreads();
  if (!c_live) return;
#pragma unroll
  for (int i = 0; i < HPT; ++i) {
    const int g = hc + 4 * i;
    if (g >= ng) break;
    const int h = kh * G + g0 + g;
    if (a.spans == 1) {
      TQ* ob = static_cast<TQ*>(a.out) + b * a.o_sb + jq * a.o_sn +
               h * a.o_sh + dc;
      const float den = fmaxf(l_s[g], 1e-30f);
#pragma unroll
      for (int e = 0; e < 4; ++e) store(ob + e, acc[i][e] / den);
    } else {
      float* pp =
          a.part + ((static_cast<int64_t>(r) * a.H + h) * a.spans + sp) *
                       (hd + 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) pp[dc + e] = acc[i][e];
      if (dc == 0) {
        pp[hd] = m_s[g];
        pp[hd + 1] = l_s[g];
      }
    }
  }
}

// The GQA body (G > 1, hd <= 128): one block per (query row, kv head,
// group of up to 16 query heads, span of kSpan rows), every query head of a
// kv head in one block, so each K/V row is read once for all of them.  The
// rows are dealt to the warps as in the narrow body: of every 64 rows, warp
// w takes rows 4w .. 4w + 3 and 32 + 4w .. 32 + 4w + 3, its tile of
// kTileGqa = 8 rows (tile row rho = 4j + r is row 32j + 4w + r).  Each warp
// runs on its own, with no barrier across warps until the merge:
//   prologue: lane l reads the kv_pos of tile l / 2's rows 4 (l % 2) .. + 3
//      (every read of the span issued before any is used; on the paged
//      layout then the valid rows' table entries, the pool rows left in
//      shared memory), and the warp keeps each tile's 8-bit valid-row mask
//      in its lanes and the set of tiles with a valid row in one word;
//   ring: the valid rows' K and V of the next tile are copied by cp.async
//      (16 bytes a copy) into the warp's ring of kStagesGqa stages while
//      one is worked; a tile no row of which is valid is neither copied
//      nor worked;
//   scores: lane (rho = l / 4, part = l % 4) takes a quarter of tile row
//      rho's 16-byte chunks (chunks part + 4i, the order rotated by rho so
//      that the 8 rows' reads fall on distinct banks) against every head's
//      q from shared memory; a two-level butterfly over the row's 4 lanes
//      leaves lane (rho, part) with the scores of heads part * NG / 4 + k;
//   softmax: per head, ONE max and ONE rescale per tile over the 8 rows
//      (a butterfly over rho), the weights and the rescale to shared memory;
//   values: lane l owns head dims HD / 32 * l .. + HD / 32 - 1 of every head
//      (the accumulators: NG x HD / 32 a thread, 8 for granite): it rescales
//      them, then adds the tile's valid rows in row order.
// At the end the 8 warps' (max, sum, acc) are merged through shared memory
// (the rings' space) in warp order, as in the narrow body.  Every sum's
// order is a function of the logical row index alone, and a masked row, a
// skipped tile and an empty warp or span merge as exact no-ops, so the
// invariances of the narrow body hold here too.
constexpr int kTileGqa = 8;                // rows of a warp's tile
constexpr int kGroupRows = kTileGqa * kWarps;   // rows of one tile of each warp
constexpr int kTilesGqa = kSpan / kGroupRows;   // a warp's tiles per span

// the stages of a warp's ring: the next tile in flight while one is worked,
// so 8 tiles a block and, at 4 blocks an SM, 64 KB an SM at bf16 hd 64.
// Deeper rings cost blocks an SM: on an H100 at granite's decode-backlog
// shape 4 stages (3 blocks an SM) ran 7.9 % slower and 3 stages 4.0 %
// slower than 2.
constexpr int kStagesGqa = 2;

// dynamic shared memory: the warps' rings, reused by the merge
template <typename TKV, int NG>
__host__ __device__ constexpr size_t smem_gqa(int hd) {
  const size_t ring = static_cast<size_t>(kWarps) * kStagesGqa * 2 *
                      kTileGqa * hd * sizeof(TKV);
  const size_t merge = static_cast<size_t>(kWarps) * NG * hd * sizeof(float);
  return ring > merge ? ring : merge;
}

// DPL consecutive elements of shared memory as floats (aligned to their size)
template <int DPL, typename T>
__device__ __forceinline__ void load_dims(const T* p, float (&x)[DPL]) {
  if constexpr (DPL == 4) {
    load4(p, x);
  } else if constexpr (sizeof(T) == 4) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  }
}

template <typename TKV, bool kPaged, int NG, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_kernel_gqa(const DecodeArgs a) {
  constexpr int VEC = kVec<TKV>;
  constexpr int NS = kStagesGqa;
  constexpr int CK = HD / VEC / 4;            // scores: chunks a lane and row
  constexpr int HPL = NG / 4;                 // scores: heads a lane, folded
  constexpr int DPL = HD / 32;                // values: head dims a lane
  constexpr int CPR = HD / VEC;               // copies: chunks a row, at most
  constexpr int RPP = 32 / CPR;               // copies: rows a pass
  static_assert(kThreads == 256 && kTileGqa == 8 && kTilesGqa == 16,
                "the lane maps and the tile word assume these");
  static_assert((NG == 4 || NG == 8 || NG == 16) && (HD == 64 || HD == 128),
                "the buckets");
  extern __shared__ uint4 gqa_raw[];          // the warps' rings; the merge
  __shared__ __align__(16) float qs[NG][HD];
  __shared__ __align__(16) float ps[kWarps][kTileGqa][NG];  // a tile's weights
  __shared__ __align__(16) float cs[kWarps][NG];            // and rescales
  __shared__ float m_s[kWarps][NG], l_s[kWarps][NG];
  __shared__ int32_t prow_s[kPaged ? kWarps : 1]
                           [kPaged ? kTilesGqa * kTileGqa : 1];

  const int r = blockIdx.x;                   // query row: slot b, query j
  const int b = r / a.nq;
  const int jq = r - b * a.nq;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int grp = blockIdx.z / a.spans;
  const int sp = blockIdx.z - grp * a.spans;
  const int g0 = grp * NG;
  const int ng = min(NG, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hd = a.hd;
  const int nchunk = hd / VEC;
  const int cur = a.cur[b] + jq;
  const int s_begin = sp * kSpan;
  const int s_end = min(a.S, s_begin + kSpan);

  const int64_t q0 = b * a.q_sb + jq * a.q_sn;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;

  // prologue: lane l reads tile l / 2's rows 4 (l % 2) .. + 3, every read
  // issued before any is used (then everyone's q)
  const int lt = lane >> 1;
  const int ls = s_begin + kGroupRows * lt + 32 * (lane & 1) + 4 * warp;
  int kp[4];
  {
    const int32_t* pb = a.kv_pos + b * a.p_sb;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      kp[i] = ls + i < s_end ? pb[(ls + i) * a.p_ss] : -1;
  }
  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    const int64_t qi = q0 + (kh * G + g0 + g) * a.q_sh + d;
    qs[g][d] = (a.q_f32 ? static_cast<const float*>(a.q)[qi]
                        : to_float(static_cast<const __nv_bfloat16*>(a.q)[qi])) *
               a.scale;
  }
  unsigned nib = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok =
        kp[i] >= 0 && kp[i] <= cur && (a.window == 0 || cur - kp[i] < a.window);
    nib |= static_cast<unsigned>(ok) << i;
  }
  if constexpr (kPaged) {
    int ent[4], blk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      blk[i] = a.bs_shift >= 0 ? (ls + i) >> a.bs_shift : (ls + i) / a.bs;
      ent[i] = (nib >> i) & 1u ? a.tbl[b * a.t_sb + blk[i] * a.t_sj] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      prow_s[warp][kTileGqa * lt + 4 * (lane & 1) + i] =
          ent[i] * a.bs + (ls + i) - blk[i] * a.bs;
  }
  // tile t's mask (bit rho = 4j + r) in lanes 2t and 2t + 1; bit 2t of
  // `todo` set where tile t has a valid row
  const unsigned across = __shfl_xor_sync(kFull, nib, 1);
  const unsigned m8 = lane & 1 ? across | nib << 4 : nib | across << 4;
  const unsigned todo = __ballot_sync(kFull, m8 != 0) & 0x55555555u;
  __syncthreads();                            // q, and the pool rows

  // the ring: the k-th valid tile goes to stage k % NS, one commit group a
  // call (empty once every tile is issued)
  const int tile_elems = kTileGqa * hd;
  TKV* ring = reinterpret_cast<TKV*>(gqa_raw) + warp * NS * 2 * tile_elems;
  unsigned to_issue = todo;
  int issued = 0;
  auto issue = [&]() {
    if (to_issue) {
      const int bit = __ffs(to_issue) - 1;
      to_issue &= to_issue - 1;
      const unsigned mask = __shfl_sync(kFull, m8, bit);
      const int t = bit >> 1;
      TKV* kd = ring + (issued % NS) * 2 * tile_elems;
      TKV* vd = kd + tile_elems;
      const int c = lane % CPR;
#pragma unroll
      for (int pass = 0; pass < kTileGqa / RPP; ++pass) {
        const int rho = pass * RPP + lane / CPR;
        if ((mask >> rho) & 1u && c < nchunk) {
          int64_t row;
          if constexpr (kPaged) {
            row = prow_s[warp][kTileGqa * t + rho];
          } else {
            row = s_begin + kGroupRows * t + 32 * (rho >> 2) + 4 * warp +
                  (rho & 3);
          }
          cp_async16(kd + rho * hd + c * VEC, kb + row * a.k_ss + c * VEC);
          cp_async16(vd + rho * hd + c * VEC, vb + row * a.v_ss + c * VEC);
        }
      }
    }
    ++issued;
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue();

  const int rho = lane >> 2;                  // scores: the tile row
  const int part = lane & 3;                  // and the quarter of it
  const int d0 = DPL * lane;                  // values: the head dims
  const bool d_live = d0 < hd;
  float m[HPL], l[HPL], acc[NG][DPL];
#pragma unroll
  for (int k = 0; k < HPL; ++k) {
    m[k] = kNeg;
    l[k] = 0.0f;
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;

  unsigned to_work = todo;
  for (int k = 0; to_work; ++k) {
    const int bit = __ffs(to_work) - 1;
    to_work &= to_work - 1;
    const unsigned mask = __shfl_sync(kFull, m8, bit);
    __syncwarp();                 // every lane is done with tile k - 1's stage
    issue();                      // tile k + NS - 1 into it
    cp_async_wait<NS - 1>();      // this lane's copies of tile k are in
    __syncwarp();                 // and every lane's
    const TKV* kt = ring + (k % NS) * 2 * tile_elems;
    const TKV* vt = kt + tile_elems;

    // scores: a quarter of row rho against every head, then the row's sum
    float v[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) v[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < CK; ++i) {
      const int c = part + 4 * ((i + rho) & (CK - 1));
      if (c < nchunk) {
        float kx[VEC];
        unpack(*reinterpret_cast<const uint4*>(kt + rho * hd + c * VEC), kx);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g < ng) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 f =
                  *reinterpret_cast<const float4*>(&qs[g][c * VEC + e]);
              v[g] = fmaf(f.x, kx[e], v[g]);
              v[g] = fmaf(f.y, kx[e + 1], v[g]);
              v[g] = fmaf(f.z, kx[e + 2], v[g]);
              v[g] = fmaf(f.w, kx[e + 3], v[g]);
            }
          }
        }
      }
    }
    fold<NG>(v, part & 2, 2);
    fold<NG / 2>(v, part & 1, 1);

    // softmax: heads part * HPL + k over the tile's 8 rows
    const bool row_ok = (mask >> rho) & 1u;
#pragma unroll
    for (int k2 = 0; k2 < HPL; ++k2) {
      const int g = part * HPL + k2;
      const float sv = row_ok ? v[k2] : kNeg;
      float mt = sv;
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 4));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 8));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 16));
      const float m_new = fmaxf(m[k2], mt);
      const float corr = expf(m[k2] - m_new);
      const float p = expf(sv - m_new);
      float psum = p;
      psum += __shfl_xor_sync(kFull, psum, 4);
      psum += __shfl_xor_sync(kFull, psum, 8);
      psum += __shfl_xor_sync(kFull, psum, 16);
      l[k2] = l[k2] * corr + psum;
      m[k2] = m_new;
      ps[warp][rho][g] = p;
      if (rho == 0) cs[warp][g] = corr;
    }
    __syncwarp();

    // values: rescale, then the valid rows in row order
    if (d_live) {
#pragma unroll
      for (int g4 = 0; g4 < NG; g4 += 4) {
        if (g4 >= ng) break;
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[warp][g4]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g4 + u][e] *= cv[u];
      }
#pragma unroll
      for (int t = 0; t < kTileGqa; ++t) {
        if (!((mask >> t) & 1u)) continue;
        float vx[DPL];
        load_dims<DPL>(vt + t * hd + d0, vx);
#pragma unroll
        for (int g4 = 0; g4 < NG; g4 += 4) {
          if (g4 >= ng) break;
          const float4 p4 = *reinterpret_cast<const float4*>(&ps[warp][t][g4]);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[g4 + u][e] = fmaf(pv[u], vx[e], acc[g4 + u][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warps' states through shared memory (the rings' space), merged in
  // warp order
  __syncthreads();                            // every ring is drained
  float* sacc = reinterpret_cast<float*>(gqa_raw);   // [kWarps][NG][hd]
  if (rho == 0) {
#pragma unroll
    for (int k2 = 0; k2 < HPL; ++k2) {
      m_s[warp][part * HPL + k2] = m[k2];
      l_s[warp][part * HPL + k2] = l[k2];
    }
  }
  if (d_live) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g >= ng) break;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        sacc[(warp * NG + g) * hd + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float sum = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][g] - mx);
      sum += l_s[w][g] * c;
      num += sacc[(w * NG + g) * hd + d] * c;
    }
    const int h = kh * G + g0 + g;
    if (a.spans == 1) {
      const int64_t oi = b * a.o_sb + jq * a.o_sn + h * a.o_sh + d;
      const float o = num / fmaxf(sum, 1e-30f);
      if (a.q_f32)
        store(static_cast<float*>(a.out) + oi, o);
      else
        store(static_cast<__nv_bfloat16*>(a.out) + oi, o);
    } else {
      float* pp =
          a.part + ((static_cast<int64_t>(r) * a.H + h) * a.spans + sp) *
                       (hd + 2);
      pp[d] = num;
      if (d == 0) {
        pp[hd] = mx;
        pp[hd + 1] = sum;
      }
    }
  }
}

template <typename TQ, typename TKV, bool kPaged>
int launch_body(const DecodeArgs& a, int B, cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(B) * static_cast<unsigned>(a.nq);
  const dim3 grid(rows, static_cast<unsigned>(a.K),
                  static_cast<unsigned>(a.spans));
  decode_kernel<TQ, TKV, kPaged><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.spans == 1) return static_cast<int>(err);
  const dim3 cgrid(rows, static_cast<unsigned>(a.H));
  combine_kernel<TQ><<<cgrid, kCombineThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kPaged>
int launch_wide(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_wide<TKV>();
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_wide_kernel<TQ, TKV, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int G = a.H / a.K;
  const unsigned rows = static_cast<unsigned>(B) * static_cast<unsigned>(a.nq);
  const dim3 grid(rows, static_cast<unsigned>(a.K),
                  static_cast<unsigned>((G + kHeadsWide - 1) / kHeadsWide *
                                        a.spans));
  decode_wide_kernel<TQ, TKV, kPaged><<<grid, kThreads, bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.spans == 1) return static_cast<int>(err);
  const dim3 cgrid(rows, static_cast<unsigned>(a.H));
  combine_kernel<TQ><<<cgrid, kCombineThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool kPaged, int NG, int HD>
int launch_gqa_instance(const DecodeArgs& a, int B, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel_gqa<TKV, kPaged, NG, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_gqa<TKV, NG>(HD)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int G = a.H / a.K;
  const unsigned rows = static_cast<unsigned>(B) * static_cast<unsigned>(a.nq);
  const dim3 grid(rows, static_cast<unsigned>(a.K),
                  static_cast<unsigned>((G + NG - 1) / NG * a.spans));
  DecodeArgs g = a;
  g.q_f32 = sizeof(TQ) == sizeof(float);
  decode_kernel_gqa<TKV, kPaged, NG, HD>
      <<<grid, kThreads, smem_gqa<TKV, NG>(a.hd), stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.spans == 1) return static_cast<int>(err);
  const dim3 cgrid(rows, static_cast<unsigned>(a.H));
  combine_kernel<TQ><<<cgrid, kCombineThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the GQA body's instance: query heads a block by G (4, 8, 16: groups of 16
// above), head dims by hd (64, 128)
template <typename TQ, typename TKV, bool kPaged, int HD>
int launch_gqa(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.K;
  if (G <= 4) return launch_gqa_instance<TQ, TKV, kPaged, 4, HD>(a, B, stream);
  if (G <= 8) return launch_gqa_instance<TQ, TKV, kPaged, 8, HD>(a, B, stream);
  return launch_gqa_instance<TQ, TKV, kPaged, 16, HD>(a, B, stream);
}

template <typename TQ, typename TKV, bool kPaged>
int launch(const DecodeArgs& a, int B, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (a.hd > 128) return launch_wide<TQ, TKV, kPaged>(a, B, stream);
  if (a.H == a.K) return launch_body<TQ, TKV, kPaged>(a, B, stream);
  if (a.hd <= 64) return launch_gqa<TQ, TKV, kPaged, 64>(a, B, stream);
  return launch_gqa<TQ, TKV, kPaged, 128>(a, B, stream);
}

}  // namespace

// the logical rows of a span: a function of the head dim alone
extern "C" int decode_attention_span_rows(int hd) {
  return hd <= 128 ? kSpan : kSpanWide;
}

#define DECODE_ENTRY(NAME, TQ, TKV)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* kv_pos, const void* cur, void* out, int B,   \
                      int H, int K, int S, int hd, int64_t q_sb, int64_t q_sh, \
                      int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,  \
                      int64_t v_sh, int64_t v_ss, int64_t p_sb, int64_t p_ss,  \
                      int64_t o_sb, int64_t o_sh, float scale, int window,     \
                      int spans, void* part, void* stream) {                   \
    DecodeArgs a{q,    k,    v,    static_cast<const int32_t*>(kv_pos),        \
                 static_cast<const int32_t*>(cur),                             \
                 out,  H,    K,    S,    hd,   q_sb, q_sh, k_sb, k_sh, k_ss,   \
                 v_sb, v_sh, v_ss, p_sb, p_ss, o_sb, o_sh, scale, window};     \
    a.spans = spans;                                                           \
    a.part = static_cast<float*>(part);                                        \
    a.nq = 1;                                                                  \
    return launch<TQ, TKV, false>(a, B, stream);                               \
  }

DECODE_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

// the verify chunk: q / out [B, n, H, hd] with strides (q_sb, q_sn, q_sh, 1)
// and (o_sb, o_sn, o_sh, 1), start [B]: query row j of slot b at position
// start[b] + j; part [B * n, H, spans, hd + 2] when spans > 1
#define CHUNK_ENTRY(NAME, TQ, TKV)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* kv_pos, const void* start, void* out, int B, \
                      int n, int H, int K, int S, int hd, int64_t q_sb,        \
                      int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sh,  \
                      int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,  \
                      int64_t p_sb, int64_t p_ss, int64_t o_sb, int64_t o_sn,  \
                      int64_t o_sh, float scale, int window, int spans,        \
                      void* part, void* stream) {                              \
    DecodeArgs a{q,    k,    v,    static_cast<const int32_t*>(kv_pos),        \
                 static_cast<const int32_t*>(start),                           \
                 out,  H,    K,    S,    hd,   q_sb, q_sh, k_sb, k_sh, k_ss,   \
                 v_sb, v_sh, v_ss, p_sb, p_ss, o_sb, o_sh, scale, window};     \
    a.spans = spans;                                                           \
    a.part = static_cast<float*>(part);                                        \
    a.nq = n;                                                                  \
    a.q_sn = q_sn;                                                             \
    a.o_sn = o_sn;                                                             \
    return launch<TQ, TKV, false>(a, B, stream);                               \
  }

CHUNK_ENTRY(decode_attention_chunk_f32_f32, float, float)
CHUNK_ENTRY(decode_attention_chunk_f32_bf16, float, __nv_bfloat16)
CHUNK_ENTRY(decode_attention_chunk_bf16_f32, __nv_bfloat16, float)
CHUNK_ENTRY(decode_attention_chunk_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

// k/v: the pool [NB, bs, K, hd] with strides (bs * k_srow, k_srow, k_sh, 1)
// (blocks back to back) and NB * bs < 2^31; tbl [B, MB] with strides
// (t_sb, t_sj); S = the logical extent (a multiple of bs, at most MB * bs):
// the wrapper checks all of these
#define PAGED_ENTRY(NAME, TQ, TKV)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* tbl, const void* kv_pos, const void* cur,    \
                      void* out, int B, int H, int K, int S, int hd, int bs,   \
                      int64_t q_sb, int64_t q_sh, int64_t k_srow,              \
                      int64_t k_sh, int64_t v_srow, int64_t v_sh,              \
                      int64_t t_sb, int64_t t_sj, int64_t p_sb, int64_t p_ss,  \
                      int64_t o_sb, int64_t o_sh, float scale, int window,     \
                      int spans, void* part, void* stream) {                   \
    DecodeArgs a{};                                                            \
    a.q = q;                                                                   \
    a.k = k;                                                                   \
    a.v = v;                                                                   \
    a.kv_pos = static_cast<const int32_t*>(kv_pos);                            \
    a.cur = static_cast<const int32_t*>(cur);                                  \
    a.out = out;                                                               \
    a.H = H;                                                                   \
    a.K = K;                                                                   \
    a.S = S;                                                                   \
    a.hd = hd;                                                                 \
    a.q_sb = q_sb;                                                             \
    a.q_sh = q_sh;                                                             \
    a.k_sb = 0;                                                                \
    a.k_sh = k_sh;                                                             \
    a.k_ss = k_srow;                                                           \
    a.v_sb = 0;                                                                \
    a.v_sh = v_sh;                                                             \
    a.v_ss = v_srow;                                                           \
    a.p_sb = p_sb;                                                             \
    a.p_ss = p_ss;                                                             \
    a.o_sb = o_sb;                                                             \
    a.o_sh = o_sh;                                                             \
    a.scale = scale;                                                           \
    a.window = window;                                                         \
    a.tbl = static_cast<const int32_t*>(tbl);                                  \
    a.bs = bs;                                                                 \
    a.bs_shift = (bs & (bs - 1)) == 0 ? __builtin_ctz(bs) : -1;               \
    a.t_sb = t_sb;                                                             \
    a.t_sj = t_sj;                                                             \
    a.spans = spans;                                                           \
    a.part = static_cast<float*>(part);                                        \
    a.nq = 1;                                                                  \
    return launch<TQ, TKV, true>(a, B, stream);                                \
  }

PAGED_ENTRY(paged_decode_attention_f32_f32, float, float)
PAGED_ENTRY(paged_decode_attention_f32_bf16, float, __nv_bfloat16)
PAGED_ENTRY(paged_decode_attention_bf16_f32, __nv_bfloat16, float)
PAGED_ENTRY(paged_decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
