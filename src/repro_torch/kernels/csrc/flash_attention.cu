// Flash attention for prefill: causal GQA attention over a whole prompt.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (entry flash_attention).  q [B, H, Sq, hd], k/v [B, K, Skv, hd] (query head
// h reads kv head h / G, G = H / K) -> out [B, H, Sq, hd] in q's type.  Query
// row i sits at position i + q_offset, key j at position j; key j is visible
// to row i when
//
//     j < Skv  &&  (!causal || j <= i + q_offset)
//              &&  (window == 0 || i + q_offset - j < window)
//
// and out = softmax(q.k / sqrt(hd)) . v over the visible keys, all in f32,
// masked scores set to -1e30 and the sum floored at 1e-30, as the TPU kernel
// does.  Every tensor is read and written through its strides (last dimension
// contiguous), so the model's BSHD activations [B, S, H, hd] go in and come
// out without a transpose.
//
// Design: one block of 256 threads (8 warps) per (query tile of 32 rows,
// head, batch row); warp w owns rows 4w .. 4w + 3.  The TPU kernel's
// sequential grid axis over key blocks becomes a loop inside the block over
// key tiles of 32, staged in shared memory as f32: K transposed, [hd][33]
// (padded, so that both the coalesced fill and the per-lane reads are free
// of bank conflicts), V as [32][hd].  In a tile each lane owns one key: it
// computes that key's score for the warp's 4 rows (q read from shared
// memory as 16-byte broadcasts), the warp reduces max and sum with shuffles
// into each row's online (max, sum), and the lanes then switch to owning
// head dimensions (lane, lane + 32, ...) to accumulate P.V, the key's
// probability broadcast by shuffle.  Ragged edges of Sq and Skv are masked,
// not padded.  Key tiles that no row of the block can see (past the last
// row's position under causality, or before the first row's window) are not
// visited at all.
//
// Bound on the H100: at long prompts, operations: 4 * Sq * Skv * hd * H FLOPs
// for a full square (about half of that causal) against the tensor cores'
// 989 TFLOP/s in bf16; at the serving path's 16-token prompts, bytes (q, k,
// v read once, out written once, over 3.35 TB/s), and in practice the
// launch.  This first kernel does its products on the CUDA cores in f32 (67
// TFLOP/s), so at long prompts it cannot come near the bf16 bound; what the
// design does is keep each K/V tile in shared memory for 32 query rows, keep
// the scores and the running (max, sum, acc) in registers so that nothing of
// the S x S score matrix reaches device memory, and skip the tiles that the
// causal and window masks empty.  wgmma on bf16 tiles fed by TMA, with warp
// specialisation, is the later work that moves it toward the tensor-core
// bound.
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                   // query rows per warp
constexpr int kBQ = kWarps * kRows;        // query rows per block
constexpr int kBK = 32;                    // keys per tile (one per lane)
constexpr int kMaxHd = 256;
constexpr int kSlots = kMaxHd / 32;        // head dims per lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, K, Sq, Skv, hd;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale;
  int causal, window, q_offset;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

size_t smem_bytes(int hd) {
  return sizeof(float) * static_cast<size_t>(hd) * (kBQ + (kBK + 1) + kBK);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) flash_kernel(const FlashArgs a) {
  extern __shared__ float4 smem4[];
  const int hd = a.hd;
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][hd], q * scale
  float* ks = qs + kBQ * hd;                      // [hd][kBK + 1]
  float* vs = ks + hd * (kBK + 1);                // [kBK][hd]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * kRows;

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + h * a.q_sh;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;

  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int row = q0 + r;
    qs[i] = row < a.Sq ? to_float(qb[row * a.q_ss + d]) * a.scale : 0.0f;
  }

  // the key tiles some row of this block can see
  const int last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Skv, last + a.q_offset + 1) : a.Skv;
  int k_begin = a.window ? max(0, q0 + a.q_offset - a.window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][kSlots];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[r][j] = 0.0f;
  }
  const bool rows_live = q0 + r0 < a.Sq;   // warp-uniform

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and q is staged)
    for (int i = threadIdx.x; i < kBK * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const int key = k0 + t;
      float kx = 0.0f, vx = 0.0f;
      if (key < a.Skv) {
        kx = to_float(kb[key * a.k_ss + d]);
        vx = to_float(vb[key * a.v_ss + d]);
      }
      ks[d * (kBK + 1) + t] = kx;
      vs[t * hd + d] = vx;
    }
    __syncthreads();
    if (!rows_live) continue;

    // scores: lane = key, for the warp's 4 rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    for (int d = 0; d < hd; d += 4) {
      const float k0v = ks[(d + 0) * (kBK + 1) + lane];
      const float k1v = ks[(d + 1) * (kBK + 1) + lane];
      const float k2v = ks[(d + 2) * (kBK + 1) + lane];
      const float k3v = ks[(d + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + r) * hd + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    // online softmax per row
    const int key = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r + a.q_offset;
      const bool ok = key < a.Skv && (!a.causal || key <= qp) &&
                      (a.window == 0 || qp - key < a.window);
      const float sr = ok ? s[r] : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      p[r] = expf(sr - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) acc[r][j] *= corr;
    }

    // P.V: lane = head dimension
    for (int t = 0; t < kBK; ++t) {
      float vv[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < hd ? vs[t * hd + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pt = __shfl_sync(kFull, p[r], t);
#pragma unroll
        for (int j = 0; j < kSlots; ++j) acc[r][j] = fmaf(pt, vv[j], acc[r][j]);
      }
    }
  }

  TQ* ob = static_cast<TQ*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= a.Sq) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store(ob + row * a.o_ss + d, acc[r][j] / denom);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const FlashArgs& a, int B, void* stream) {
  const size_t bytes = smem_bytes(a.hd);
  static size_t opted_in = 48 * 1024;
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = bytes;
  }
  const dim3 grid(static_cast<unsigned>((a.Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  flash_kernel<TQ, TKV><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_ENTRY(NAME, TQ, TKV)                                            \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* out, \
                      int B, int H, int K, int Sq, int Skv, int hd,           \
                      int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, \
                      int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, \
                      int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, \
                      float scale, int causal, int window, int q_offset,      \
                      void* stream) {                                         \
    FlashArgs a{q,    k,    v,    out,  H,    K,    Sq,     Skv,    hd,       \
                q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,     \
                o_sb, o_sh, o_ss, scale, causal, window, q_offset};           \
    return launch<TQ, TKV>(a, B, stream);                                     \
  }

FLASH_ENTRY(flash_attention_f32_f32, float, float)
FLASH_ENTRY(flash_attention_f32_bf16, float, __nv_bfloat16)
FLASH_ENTRY(flash_attention_bf16_f32, __nv_bfloat16, float)
FLASH_ENTRY(flash_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
