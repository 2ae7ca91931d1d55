// Flash-decode: one new token per slot against a contiguous or ring KV cache,
// or against a shared paged block pool read in place through a block table.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention.py:_decode_kernel
// (entry decode_attention) and :_paged_kernel (entry paged_decode_attention).
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
// Design: one block of 256 threads (8 warps) per (slot, kv head, group of up
// to 4 query heads of that kv head), so a K/V row read from memory serves
// every query head of its group.  The TPU kernel's sequential grid axis over
// S becomes a loop inside the block: warp w takes the 32-key groups
// w, w + 8, ...; each lane reads one kv_pos of the group (coalesced), and on
// the paged layout that row's table entry beside it; a ballot gives the valid
// keys, and the warp walks them two at a time (both rows loaded before either
// is used, so two loads are in flight); on the paged layout each lane works
// out its row's pool row once, and the walk takes it from that lane with
// one shuffle.  For a key the lanes split hd into
// 4-element chunks (16-byte f32 or 8-byte bf16 loads), a shuffle reduction
// gives the score, and each lane keeps an online (max, sum, acc) for its
// chunks.  The 8 warps' states are merged through shared memory at the end.
// The layout enters only through the row a key is read from (the template
// flag kPaged): the schedule depends on logical row indices and values
// alone, so the paged kernel and the contiguous kernel run over the gathered
// rows (the gather shim) give the same bytes for any block size.  Masked keys
// are skipped, not loaded: a row of the cache that no query may see is never
// read, and a slot with no valid key (an empty slot, whose output nothing
// reads) gives 0, where the TPU kernel gives the mean of its masked rows;
// both are finite.
//
// Bound on the H100: bytes.  One token's attention does 4 FLOPs per cached
// element it reads, far below the card's ratio of ~295 operations per byte,
// so its least time is the valid K/V rows (plus q, kv_pos, the table and out)
// over HBM bandwidth (3.35 TB/s on the SXM part).  Skipping masked rows is
// what the design does about that on the serving path, where a slot's cache
// is mostly empty; streaming each row once for all the heads of its group is
// the other half; the paged layout reads the pool in place, with no gathered
// copy.  What is left for later work: split-S across blocks when B * K is
// small, cp.async/TMA staging of the rows, and a CUDA-graph-captured decode
// step around it (at the serving shapes the launch, not the bytes, is the
// cost).
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 4;                  // query heads per block
constexpr int kMaxHd = 256;
constexpr int kChunks = kMaxHd / 4 / 32;   // 4-element chunks per lane
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
  int64_t t_sb, t_sj;
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// one key's K and V chunks for this lane (zeros past hd)
template <typename TKV>
__device__ __forceinline__ void load_row(const TKV* krow, const TKV* vrow,
                                         int lane, int nchunk,
                                         float (&kx)[kChunks][4],
                                         float (&vx)[kChunks][4]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < nchunk) {
      load4(krow + 4 * chunk, kx[c]);
      load4(vrow + 4 * chunk, vx[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kx[c][e] = vx[c][e] = 0.0f;
    }
  }
}

// fold one valid key into the online state of every head of the block
__device__ __forceinline__ void update(const float (&q)[kHeads][kChunks][4],
                                       const float (&kx)[kChunks][4],
                                       const float (&vx)[kChunks][4], int ng,
                                       float (&m)[kHeads], float (&l)[kHeads],
                                       float (&acc)[kHeads][kChunks][4]) {
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g >= ng) break;
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part = fmaf(q[g][c][e], kx[c][e], part);
    const float s = warp_sum(part);
    const float m_new = fmaxf(m[g], s);
    const float corr = expf(m[g] - m_new);
    const float p = expf(s - m_new);
    l[g] = l[g] * corr + p;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[g][c][e] = fmaf(p, vx[c][e], acc[g][c][e] * corr);
    m[g] = m_new;
  }
}

template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(const DecodeArgs a) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = a.H / a.K;
  const int g0 = blockIdx.z * kHeads;
  const int ng = min(kHeads, G - g0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = a.hd / 4;
  const int cur = a.cur[b];

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const int32_t* pb = a.kv_pos + b * a.p_sb;
  const int32_t* tb = kPaged ? a.tbl + b * a.t_sb : nullptr;

  float q[kHeads][kChunks][4];
  float m[kHeads], l[kHeads], acc[kHeads][kChunks][4];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    const int h = kh * G + g0 + g;
    m[g] = kNeg;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int chunk = lane + 32 * c;
      if (g < ng && chunk < nchunk) {
        float x[4];
        load4(qb + h * a.q_sh + 4 * chunk, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][c][e] = x[e] * a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][c][e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][c][e] = 0.0f;
    }
  }

  for (int s0 = warp * 32; s0 < a.S; s0 += kWarps * 32) {
    const int s = s0 + lane;
    bool ok = false;
    int prow = 0;  // this lane's pool row (paged), for a valid row only
    if (s < a.S) {
      const int kp = pb[s * a.p_ss];
      ok = kp >= 0 && kp <= cur && (a.window == 0 || cur - kp < a.window);
      if constexpr (kPaged) {
        if (ok) prow = tb[(s / a.bs) * a.t_sj] * a.bs + s % a.bs;
      }
    }
    unsigned valid = __ballot_sync(kFull, ok);
    while (valid) {
      const int i0 = __ffs(valid) - 1;
      valid &= valid - 1;
      const int i1 = valid ? __ffs(valid) - 1 : -1;
      if (i1 >= 0) valid &= valid - 1;
      // the rows to read: the cache rows themselves, or the pool rows
      int r0 = s0 + i0, r1 = s0 + i1;
      if constexpr (kPaged) {
        r0 = __shfl_sync(kFull, prow, i0);
        r1 = __shfl_sync(kFull, prow, i1 >= 0 ? i1 : i0);
      }
      float k0[kChunks][4], v0[kChunks][4], k1[kChunks][4], v1[kChunks][4];
      load_row(kb + r0 * a.k_ss, vb + r0 * a.v_ss, lane, nchunk, k0, v0);
      if (i1 >= 0)
        load_row(kb + r1 * a.k_ss, vb + r1 * a.v_ss, lane, nchunk, k1, v1);
      update(q, k0, v0, ng, m, l, acc);
      if (i1 >= 0) update(q, k1, v1, ng, m, l, acc);
    }
  }

  // merge the warps' online states
  __shared__ float sm_m[kWarps][kHeads];
  __shared__ float sm_l[kWarps][kHeads];
  __shared__ float sm_acc[kWarps][kHeads][kMaxHd];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int chunk = lane + 32 * c;
      if (chunk < nchunk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sm_acc[warp][g][4 * chunk + e] = acc[g][c][e];
      }
    }
  }
  __syncthreads();
  TQ* ob = static_cast<TQ*>(a.out) + b * a.o_sb;
  for (int i = threadIdx.x; i < ng * a.hd; i += kThreads) {
    const int g = i / a.hd;
    const int d = i - g * a.hd;
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
    store(ob + h * a.o_sh + d, num / fmaxf(sum, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool kPaged>
int launch(const DecodeArgs& a, int B, void* stream) {
  const int G = a.H / a.K;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(a.K),
                  static_cast<unsigned>((G + kHeads - 1) / kHeads));
  decode_kernel<TQ, TKV, kPaged>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DECODE_ENTRY(NAME, TQ, TKV)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v,             \
                      const void* kv_pos, const void* cur, void* out, int B,   \
                      int H, int K, int S, int hd, int64_t q_sb, int64_t q_sh, \
                      int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,  \
                      int64_t v_sh, int64_t v_ss, int64_t p_sb, int64_t p_ss,  \
                      int64_t o_sb, int64_t o_sh, float scale, int window,     \
                      void* stream) {                                          \
    DecodeArgs a{q,    k,    v,    static_cast<const int32_t*>(kv_pos),        \
                 static_cast<const int32_t*>(cur),                             \
                 out,  H,    K,    S,    hd,   q_sb, q_sh, k_sb, k_sh, k_ss,   \
                 v_sb, v_sh, v_ss, p_sb, p_ss, o_sb, o_sh, scale, window};     \
    return launch<TQ, TKV, false>(a, B, stream);                               \
  }

DECODE_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

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
                      void* stream) {                                          \
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
    a.t_sb = t_sb;                                                             \
    a.t_sj = t_sj;                                                             \
    return launch<TQ, TKV, true>(a, B, stream);                                \
  }

PAGED_ENTRY(paged_decode_attention_f32_f32, float, float)
PAGED_ENTRY(paged_decode_attention_f32_bf16, float, __nv_bfloat16)
PAGED_ENTRY(paged_decode_attention_bf16_f32, __nv_bfloat16, float)
PAGED_ENTRY(paged_decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
