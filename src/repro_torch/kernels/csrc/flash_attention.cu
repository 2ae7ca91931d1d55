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
// and out = softmax(q.k / sqrt(hd)) . v over the visible keys, the softmax in
// f32, masked scores set to -1e30, the running max starting at -1e30 and the
// sum floored at 1e-30, as the TPU kernel does.  Every tensor is read and
// written through its strides (last dimension contiguous), so the model's
// BSHD activations [B, S, H, hd] go in and come out without a transpose.
//
// Two bodies.
//
// The tensor-core body (entry flash_attention_bf16_bf16, the serving
// prefill's: bf16 q, k and v, at hd 64, 80, 96, 128 or 256).  One warpgroup
// (128 threads) per (64 query rows, head, batch row).  The Q tile and a ring
// of 3 K/V stages of 64 keys (2 at hd 128, so that two blocks fit an SM, and
// 2 at hd 256, where Q and the stages take 160 KB: one block an SM) sit in
// shared memory, brought in by TMA (cp.async.bulk.tensor) with mbarrier
// completion; thread 0 issues the copies, refilling a stage as soon as it
// is released.  The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled (taken through cudaGetDriverEntryPointByVersion,
// so no -lcuda link) straight over the caller's strided BHSD views and
// passed as __grid_constant__ parameters; out-of-bounds rows of a ragged
// Sq or Skv are filled with zeros by TMA and the scores of keys past Skv
// are masked too.
// Head dims: a 64 + 16 pair of boxes for hd 80 (64 + 32 for hd 96; hd 64,
// 128 and 256 are one, two and four 64-column boxes with no tail): the
// first 64 columns of a row in 128-byte-swizzled boxes, the rest in one box
// with the 32-byte (64-byte) swizzle, so no head dim is padded and the
// copies move 128-byte rows (32-byte rows, 16-column boxes throughout, make
// the copies take about as long as the products).  S =
// Q.K^T runs as wgmma m64n64k16 with both operands from shared memory
// (K-major, the k-steps walking each box's rows) and an f32 accumulator;
// the online softmax works on the accumulator fragment in registers, one
// max and one rescale per row and key tile, each weight exp((s - m) /
// sqrt(hd)) as one fma and one ex2.approx; P is rounded to bf16 in
// registers, where the accumulator's fragment is already the A operand's
// layout, and O += P.V runs as wgmma m64n64k16 (n128 at hd 128, two n128
// halves at hd 256) over the wide boxes plus m64n16k16 (n32) over the tail
// box, A from registers and V from shared memory through the transpose
// (MN-major) mode.  The products
// are asynchronous: tile t's S = Q.K^T and tile t - 1's O += P.V are
// issued together, and the warps work tile t's softmax (in f32, in S's
// registers) while P.V still runs on the tensor cores; P is packed into the
// A operand only after P.V has retired.
// Causal and window masks are applied only in the tiles that straddle them;
// tiles that no row of the block can see are not visited, and the query
// tiles with the most key tiles start first.  Each (tile, head,
// batch row) is independent of every other: no split over keys, no atomics,
// so a prompt's result does not depend on how prompts are batched.  The
// products, copies, barriers and wgmma descriptors are inline PTX and
// bit fields: the source needs no header outside the CUDA toolkit.
//
// Expected error against the f32 plain version: P is rounded to bf16 before
// P.V (the tensor cores' operand type), at most 2^-8 (bf16's unit
// roundoff) of each weight, while the sum of the weights is taken in f32;
// so an output moves by at most 2^-8 of sum_j p_j |v_j| (the rounding
// errors of the weights have random signs, so in practice far less), plus
// its own bf16 rounding, 2^-8 of itself.  Relative to the largest output
// of its row that stays under 2^-6, the card's limit
// (tests/test_torch_attention_hopper.py holds an emulation of this
// arithmetic to that budget, and shows that a dropped key tile breaks it).
//
// At hd 256 a thread holds O's 128 f32 accumulators, S's 32 and P's 16
// packed registers at once (the products overlap the softmax), within the
// 255 a thread may have at 128 threads a block; chip_smoke.py's build phase
// prints what ptxas gives the instance.
//
// The CUDA-core body (the entries with an f32 operand, the f32 parity
// path; and the bf16 entry at the head dims the tensor-core body does not
// take: a multiple of 8 up to 256 other than 64, 80, 96, 128 and 256, such
// as the smoke configurations' hd 32).  One block of 256 threads (8 warps) per
// (query tile of 32 rows, head, batch row); warp w owns rows 4w .. 4w + 3.
// Key tiles of 32 are staged in shared memory as f32: K transposed,
// [hd][33] (padded, so that both the coalesced fill and the per-lane reads
// are free of bank conflicts), V as [32][hd].  In a tile each lane owns one key: it computes
// that key's score for the warp's 4 rows, the warp reduces max and sum with
// shuffles into each row's online (max, sum), and the lanes then switch to
// owning head dimensions to accumulate P.V, the key's probability broadcast
// by shuffle.  Ragged edges of Sq and Skv are masked, not padded, and key
// tiles that no row of the block can see are not visited.
//
// Bound on the H100: at long prompts, operations: 4 * Sq * Skv * hd * H FLOPs
// for a full square (about half of that causal) against the tensor cores'
// 989 TFLOP/s in bf16; at the serving path's 16-token prompts, bytes (q, k,
// v read once, out written once, over 3.35 TB/s), and in practice the
// launch.  The tensor-core body keeps each K/V tile in shared memory for 64
// query rows, never lets the S x S scores reach device memory, and runs
// both products on the tensor cores, overlapped with the softmax; what it
// leaves for later work is a producer warp with setmaxnreg and two
// consumer warpgroups taking turns on the tensor cores (so that S = Q.K^T
// overlaps a softmax too), 128-key tiles and, at 16-token prompts, the 48 of
// 64 rows of a query tile that hold no row.  The CUDA-core body runs on
// the CUDA cores (67 TFLOP/s in f32) and serves parity and the other head
// dims, not speed.
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns cudaGetLastError() right after the launch.

#include <cuda.h>           // CUtensorMap and its enums: types only, no -lcuda
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

// ---------------------------------------------------------------------------
// the tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 64;        // query rows per block: one warpgroup
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kWide = 64;      // columns of a 128-byte-swizzled box
constexpr int kWideBox = kBN * kWide * 2;   // its bytes: 64 rows x 128 B
constexpr float kLog2e = 1.4426950408889634f;

// a tile's head dims: wide(hd) columns in 64-column boxes with the 128-byte
// swizzle, then tail(hd) (16 or 32) in one box with the 32- or 64-byte one
__host__ __device__ constexpr int wide(int hd) { return hd / kWide * kWide; }
__host__ __device__ constexpr int tail(int hd) { return hd % kWide; }
// K/V tiles in flight: 3, or 2 at hd 128 (so that two blocks fit an SM)
// and at hd 256 (Q and two stages of K and V: 160 KB, one block an SM)
__host__ __device__ constexpr int stages(int hd) { return hd <= 96 ? 3 : 2; }

struct Args {
  void* out;
  int H, K, Sq, Skv;
  int64_t o_sb, o_sh, o_ss;
  float scale_log2;            // 1 / sqrt(hd) * log2(e)
  int causal, window, q_offset;
};

// the wide and tail tensor maps of one [B, X, S, hd] operand
struct Maps {
  CUtensorMap wide, tail;
};

constexpr size_t smem_bytes(int hd) {
  // Q, stages x (K, V), the barriers, and slack to align the tiles to the
  // 128-byte swizzle's 1024-byte period
  return static_cast<size_t>(kBM) * hd * 2 * (1 + 2 * stages(hd)) + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box (64 rows from `row`, the map's columns from `col`) of a
// [B, X, S, hd] view into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row, int x,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(x), "r"(b)
      : "memory");
}

// a whole 64-row tile: the wide boxes, then the tail box
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const Maps& m,
                                         uint32_t bar, int row, int x, int b) {
#pragma unroll
  for (int w = 0; w < wide(HD) / kWide; ++w)
    tma_box(dst + w * kWideBox, &m.wide, bar, w * kWide, row, x, b);
  if constexpr (tail(HD) > 0)
    tma_box(dst + wide(HD) / kWide * kWideBox, &m.tail, bar, wide(HD), row,
            x, b);
}

// the swizzle of a wgmma operand in shared memory: the descriptor's
// layout-type field (bits 62-63)
enum class Swizzle : uint64_t { B128 = 1, B64 = 2, B32 = 3 };

// a swizzled operand's wgmma descriptor: the start address (bits 0-13),
// lbo (bits 16-29; MN-major only: bytes between swizzle atoms along N),
// sbo (bits 32-45: bytes between 8-row core groups), each in 16-byte
// units, base offset 0 (the tiles are aligned to the swizzle's period)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, Swizzle sw) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(sw) << 62;
}

// the tail box's swizzle: 16 columns (32-byte rows) or 32 (64-byte rows)
template <int HD>
__host__ __device__ constexpr Swizzle tail_swizzle() {
  return tail(HD) == 16 ? Swizzle::B32 : Swizzle::B64;
}

// k-step j (head dims 16j .. 16j + 15) of a K-major Q or K tile at `base`:
// inside a 128-byte row of a wide box, or of the tail box
template <int HD>
__device__ __forceinline__ uint64_t qk_desc(uint32_t base, int j) {
  if (16 * j < wide(HD))
    return gmma_desc(base + (16 * j / kWide) * kWideBox + (j % 4) * 32, 16,
                     1024, Swizzle::B128);
  const int jt = j - wide(HD) / 16;
  return gmma_desc(base + wide(HD) / kWide * kWideBox + jt * 32, 16,
                   8 * tail(HD) * 2, tail_swizzle<HD>());
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (k-step KK
// of P: p[4 KK .. 4 KK + 3]), B (MN-major) from shared memory
template <int KK>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&p)[16],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(p[4 * KK]), "r"(p[4 * KK + 1]), "r"(p[4 * KK + 2]),
        "r"(p[4 * KK + 3]), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (k-step KK
// of P: p[4 KK .. 4 KK + 3]), B (MN-major) from shared memory
template <int KK>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&p)[16],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(p[4 * KK]), "r"(p[4 * KK + 1]), "r"(p[4 * KK + 2]),
        "r"(p[4 * KK + 3]), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (k-step KK
// of P: p[4 KK .. 4 KK + 3]), B (MN-major) from shared memory
template <int KK>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&p)[16],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(p[4 * KK]), "r"(p[4 * KK + 1]), "r"(p[4 * KK + 2]),
        "r"(p[4 * KK + 3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (k-step KK
// of P: p[4 KK .. 4 KK + 3]), B (MN-major) from shared memory
template <int KK>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&p)[16],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(p[4 * KK]), "r"(p[4 * KK + 1]), "r"(p[4 * KK + 2]),
        "r"(p[4 * KK + 3]), "l"(db), "r"(scale_d));
}

// the warpgroup's wgmma ordering: fence before the first product that
// reads registers or shared memory written since, commit the products
// issued so far as one group, wait until at most N groups are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an asynchronous
// product's registers across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// this thread's two rows of a 64-row tile: the accumulator fragment's rows
struct Rows {
  int lo, hi;      // row within the tile
  int c_lane;      // the first of this thread's two columns in each n8 block
  float m_lo, m_hi, l_lo, l_hi;   // running max (raw score units) and sum
};

// the online softmax of one key tile's scores s (raw q.k, this thread's 32),
// in place: masks where the tile straddles one, updates the rows' max and
// sum (of the f32 weights), and leaves in s the weights exp((s - m) /
// sqrt(hd)) (one fma and one exp2 each; rounded to bf16 only when packed,
// which keeps conversions off the exponentials' pipe), and the factors the
// accumulator must be rescaled by.  It writes only s, whose product has
// retired, so that it can run while P.V runs (ptxas serialises every
// wgmma of a kernel that writes a running product's operands)
__device__ __forceinline__ void softmax_tile(float (&s)[32], Rows& r,
                                             float& corr_lo, float& corr_hi,
                                             int k0, int q0, const Args& a) {
  const bool need_mask =
      k0 + kBN > a.Skv || (a.causal && k0 + kBN - 1 > q0 + a.q_offset) ||
      (a.window && q0 + kBM - 1 + a.q_offset - k0 >= a.window);
  float mx_lo = kNeg, mx_hi = kNeg;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = (i & 3) >= 2;
    if (need_mask) {
      const int key = k0 + (i >> 2) * 8 + r.c_lane + (i & 1);
      const int qp = q0 + (hi ? r.hi : r.lo) + a.q_offset;
      const bool ok = key < a.Skv && (!a.causal || key <= qp) &&
                      (a.window == 0 || qp - key < a.window);
      s[i] = ok ? s[i] : kNeg;
    }
    if (hi) mx_hi = fmaxf(mx_hi, s[i]);
    else mx_lo = fmaxf(mx_lo, s[i]);
  }
  // a row's 64 scores lie in the 4 lanes of a quad
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, 2));
  const float mn_lo = fmaxf(r.m_lo, mx_lo);
  const float mn_hi = fmaxf(r.m_hi, mx_hi);
  corr_lo = ex2((r.m_lo - mn_lo) * a.scale_log2);
  corr_hi = ex2((r.m_hi - mn_hi) * a.scale_log2);
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  const float off_lo = -mn_lo * a.scale_log2;
  const float off_hi = -mn_hi * a.scale_log2;
  // a row that has seen only masked keys so far (its max still -1e30)
  // weighs each of them 1, exp(0): fma(-1e30, scale, 1e30 * scale) would
  // give the rounding error of 1e30 * scale, some 1e21, whose ex2 may be
  // inf; once a key is visible, its tile's rescale by 0 drops them
  const bool dead_lo = mn_lo == kNeg, dead_hi = mn_hi == kNeg;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool hi = (i & 3) >= 2;
    s[i] = (hi ? dead_hi : dead_lo)
               ? 1.0f
               : ex2(fmaf(s[i], a.scale_log2, hi ? off_hi : off_lo));
    if (hi) sum_hi += s[i];
    else sum_lo += s[i];
  }
  r.l_lo = r.l_lo * corr_lo + sum_lo;
  r.l_hi = r.l_hi * corr_hi + sum_hi;
}

// the weights in s rounded to bf16 and packed as P.V's A operand: k-step kk
// takes p[4kk .. 4kk + 3], the accumulator fragment of S being the A layout
__device__ __forceinline__ void pack_p(const float (&s)[32],
                                       uint32_t (&p)[16]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 pb = __floats2bfloat162_rn(s[i], s[i + 1]);
    p[i / 2] = *reinterpret_cast<const uint32_t*>(&pb);
  }
}

// S = Q . K^T for one key tile: hd / 16 k-steps, committed as one group
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq,
                                         uint32_t sk) {
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wgmma_ss_n64(s, qk_desc<HD>(sq, j), qk_desc<HD>(sk, j), j);
  wgmma_commit();
}

// k-step KK (keys 16KK .. 16KK + 15) of O += P . V: the wide columns
// (accumulators o[0 .. wide / 2)) from the wide boxes, MN-major, 64-column
// atoms kWideBox apart; the tail columns from the tail box
template <int HD, int KK>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&p)[16], uint32_t sv) {
  float (&ow)[wide(HD) / 2] = *reinterpret_cast<float(*)[wide(HD) / 2]>(&o[0]);
  const uint64_t dw =
      gmma_desc(sv + KK * 16 * 128, kWideBox, 8 * 128, Swizzle::B128);
  if constexpr (wide(HD) == 64) wgmma_rs_n64<KK>(ow, p, dw, 1);
  if constexpr (wide(HD) == 128) wgmma_rs_n128<KK>(ow, p, dw, 1);
  if constexpr (wide(HD) == 256) {
    // two n128 halves: o[0 .. 64) from boxes 0-1, o[64 .. 128) from 2-3
    float (&o0)[64] = *reinterpret_cast<float(*)[64]>(&o[0]);
    float (&o1)[64] = *reinterpret_cast<float(*)[64]>(&o[64]);
    wgmma_rs_n128<KK>(o0, p, dw, 1);
    wgmma_rs_n128<KK>(
        o1, p,
        gmma_desc(sv + 2 * kWideBox + KK * 16 * 128, kWideBox, 8 * 128,
                  Swizzle::B128),
        1);
  }
  if constexpr (tail(HD) > 0) {
    float (&ot)[tail(HD) / 2] =
        *reinterpret_cast<float(*)[tail(HD) / 2]>(&o[wide(HD) / 2]);
    const uint32_t row = tail(HD) * 2;   // bytes of a tail-box row
    const uint64_t dt =
        gmma_desc(sv + wide(HD) / kWide * kWideBox + KK * 16 * row, 0,
                  8 * row, tail_swizzle<HD>());
    if constexpr (tail(HD) == 16) wgmma_rs_n16<KK>(ot, p, dt, 1);
    if constexpr (tail(HD) == 32) wgmma_rs_n32<KK>(ot, p, dt, 1);
  }
}

// O += P . V for one key tile: 4 k-steps of 16 keys, committed as one group
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[16],
                                         uint32_t sv) {
  pv_step<HD, 0>(o, p, sv);
  pv_step<HD, 1>(o, p, sv);
  pv_step<HD, 2>(o, p, sv);
  pv_step<HD, 3>(o, p, sv);
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_tc_kernel(const __grid_constant__ Maps qmap,
                    const __grid_constant__ Maps kmap,
                    const __grid_constant__ Maps vmap, const Args a) {
  constexpr int kTile = kBM * HD * 2;
  constexpr int kStages = stages(HD);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + kTile;                  // + stage * kTile
  const uint32_t s_v = s_k + kStages * kTile;        // + stage * kTile
  const uint32_t s_bar = s_v + kStages * kTile;      // Q, then one per stage

  // the last query tiles (the most key tiles under causality) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.K);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the key tiles some row of this block can see
  const int last = min(q0 + kBM, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Skv, last + a.q_offset + 1) : a.Skv;
  int k_begin = a.window ? max(0, q0 + a.q_offset - a.window + 1) : 0;
  k_begin = (k_begin / kBN) * kBN;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN : 0;

  auto kv_bar = [&](int stage) { return s_bar + 8 * (1 + stage); };
  auto load_kv = [&](int t) {      // tile t into stage t % kStages
    const int stage = t % kStages;
    mbar_expect_tx(kv_bar(stage), 2 * kTile);
    tma_tile<HD>(s_k + stage * kTile, kmap, kv_bar(stage), k_begin + t * kBN,
                 kh, b);
    tma_tile<HD>(s_v + stage * kTile, vmap, kv_bar(stage), k_begin + t * kBN,
                 kh, b);
  };
  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(s_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(s_bar, kTile);
    tma_tile<HD>(s_q, qmap, s_bar, q0, h, b);
    for (int t = 0; t < kStages && t < ntiles; ++t) load_kv(t);
  }

  Rows r{warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8,
         2 * (lane & 3), kNeg, kNeg, 0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float s[32];
  uint32_t p[16];
  float corr_lo, corr_hi;

  mbar_wait(s_bar, 0);
  if (ntiles > 0) {
    mbar_wait(kv_bar(0), 0);
    fence_regs(s);
    wgmma_fence();
    issue_qk<HD>(s, s_q, s_k);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, r, corr_lo, corr_hi, k_begin, q0, a);
    pack_p(s, p);
  }
  // tile t's S = Q.K^T and tile t - 1's O += P.V run on the tensor cores
  // while the same warps work tile t's softmax
  for (int t = 1; t < ntiles; ++t) {
    const int stage = t % kStages;
    const int prev = (t - 1) % kStages;
    mbar_wait(kv_bar(stage), (t / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_qk<HD>(s, s_q, s_k + stage * kTile);
    issue_pv<HD>(o, p, s_v + prev * kTile);
    wgmma_wait<1>();       // S is in; P.V may still run
    fence_regs(s);
    softmax_tile(s, r, corr_lo, corr_hi, k_begin + t * kBN, q0, a);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 3) >= 2 ? corr_hi : corr_lo;
    pack_p(s, p);
    // tile t - 1's stage is consumed: thread 0 refills it
    __syncthreads();
    if (tid == 0 && t - 1 + kStages < ntiles) load_kv(t - 1 + kStages);
  }
  if (ntiles > 0) {
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    issue_pv<HD>(o, p, s_v + ((ntiles - 1) % kStages) * kTile);
    wgmma_wait<0>();
    fence_regs(o);
  }

  float l_lo = r.l_lo, l_hi = r.l_hi;
  l_lo += __shfl_xor_sync(kFull, l_lo, 1);
  l_lo += __shfl_xor_sync(kFull, l_lo, 2);
  l_hi += __shfl_xor_sync(kFull, l_hi, 1);
  l_hi += __shfl_xor_sync(kFull, l_hi, 2);
  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool hi = (i & 3) >= 2;
    const int row = q0 + (hi ? r.hi : r.lo);
    if (row < a.Sq) {
      const float d = hi ? d_hi : d_lo;
      const int col = (i >> 2) * 8 + r.c_lane;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * a.o_ss + col) =
          __floats2bfloat162_rn(o[i] / d, o[i + 1] / d);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the [B, X, S, hd] view at ptr, element strides (sb, sx, ss, 1), as boxes
// of 64 rows x `cols` columns with the given swizzle, zeros past every edge
bool encode(CUtensorMap* map, const void* ptr, int B, int X, int S, int hd,
            int64_t sb, int64_t sx, int64_t ss, int cols,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sx) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(kBN), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an operand's wide map and (where hd has a tail) its tail map
template <int HD>
bool encode_maps(Maps* m, const void* ptr, int B, int X, int S, int64_t sb,
                 int64_t sx, int64_t ss) {
  if (!encode(&m->wide, ptr, B, X, S, HD, sb, sx, ss, kWide,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if constexpr (tail(HD) == 0) {
    m->tail = m->wide;
    return true;
  }
  return encode(&m->tail, ptr, B, X, S, HD, sb, sx, ss, tail(HD),
                tail(HD) == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                               : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int HD>
int launch_hd(const FlashArgs& f, int B, cudaStream_t stream) {
  Maps qmap, kmap, vmap;
  if (!encode_maps<HD>(&qmap, f.q, B, f.H, f.Sq, f.q_sb, f.q_sh, f.q_ss) ||
      !encode_maps<HD>(&kmap, f.k, B, f.K, f.Skv, f.k_sb, f.k_sh, f.k_ss) ||
      !encode_maps<HD>(&vmap, f.v, B, f.K, f.Skv, f.v_sb, f.v_sh, f.v_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = smem_bytes(HD);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Args a{f.out,  f.H,    f.K,    f.Sq,     f.Skv,
               f.o_sb, f.o_sh, f.o_ss, f.scale * kLog2e,
               f.causal, f.window, f.q_offset};
  const dim3 grid(static_cast<unsigned>((f.Sq + kBM - 1) / kBM),
                  static_cast<unsigned>(f.H), static_cast<unsigned>(B));
  flash_tc_kernel<HD><<<grid, kThreads, bytes, stream>>>(qmap, kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core body takes hd 64, 80, 96, 128, 256 and TMA-describable
// views: 16-byte aligned starts and strides that are multiples of 8
// elements (the wrapper raises on anything else at these head dims, so no
// cp.async path is needed)
int launch(const FlashArgs& f, int B, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (f.hd) {
    case 64: return launch_hd<64>(f, B, s);
    case 80: return launch_hd<80>(f, B, s);
    case 96: return launch_hd<96>(f, B, s);
    case 128: return launch_hd<128>(f, B, s);
    case 256: return launch_hd<256>(f, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc


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

// the serving prefill's entry: the tensor-core body at hd 64, 80, 96, 128
// and 256, the CUDA-core body at the other head dims
extern "C" int flash_attention_bf16_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int hd, int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale,
    int causal, int window, int q_offset, void* stream) {
  const FlashArgs a{q,    k,    v,    out,  H,    K,    Sq,     Skv,    hd,
                    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,   v_sh,   v_ss,
                    o_sb, o_sh, o_ss, scale, causal, window, q_offset};
  switch (hd) {
    case 64: case 80: case 96: case 128: case 256:
      return tc::launch(a, B, stream);
    default: return launch<__nv_bfloat16, __nv_bfloat16>(a, B, stream);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
