// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel (entry
// ssd_scan), and serves the chunked scan of src/repro/models/ssd.py:ssd_chunked
// with one more entry point.  x [B, S, H, hd], dt [B, S, H], A [H] f32 (< 0),
// Bm / Cm [B, S, N] (one group, shared by the heads) -> y [B, S, H, hd] in x's
// type.  Per (b, h), with the state h [hd, N] carried across chunks of Q rows:
//
//     la_t = A * dt_t,   l = inclusive cumsum of la over the chunk
//     y_t  = sum_{s <= t} exp(l_t - l_s) (C_t . B_s) dt_s x_s     (intra-chunk)
//          + exp(l_t) (C_t . h)                                   (inter-chunk)
//     h'   = exp(l_last) h + sum_s exp(l_last - l_s) dt_s x_s (x) B_s
//
// The exponentials are taken of differences of within-chunk cumsums, as the
// reference does, never of -l_s alone: with Mamba-2's decay rates (A down to
// -16, models/ssd.py:32) exp(-l_s) overflows f32 within a chunk.  Rows past S
// are read as zeros with dt = 0, so they are the identity for the state
// (ssd_scan.py:47-48).  Everything is computed in f32.
//
// Two entry points:
//   ssd_scan_{f32,bf16}     zero initial state, writes y only (the TPU
//                           kernel's contract: a prefill from nothing);
//   ssd_chunked_{f32,bf16}  reads h0 [B, H, hd, N] f32 and writes h_last
//                           [B, H, hd, N] f32 as well (ssd_chunked's contract:
//                           a prefill into a decode cache).
// x, Bm and Cm are read through their strides (last dimension contiguous), so
// the model's views into its conv output go in as they are; dt through its
// three strides; y, h0 and h_last are contiguous.
//
// Two schedules, chosen by S alone:
//
// One chunk (S <= kQ = 64: the serving prefill of short prompts), one launch.
// Bound by bytes: a 16-token prompt into a cache reads h0 and writes h_last,
// 2 x 4 hd N bytes per (b, h), eight times x and y together at mamba2's
// widths.  One block of 256 threads owns (b, h, kP = 32 head-dim rows: the
// rows of h are independent) and one chunk of Q = 16, 32 or 64 rows (the
// shortest that holds S).  At entry one thread starts the block's h0 slice,
// [kP, N] f32 and contiguous in h0, as one asynchronous bulk copy
// (cp.async.bulk, the 1-D TMA) completing on an mbarrier; the chunk's dt, B,
// C and x loads and the intra-chunk term (C.B^T, the decay, att.x) proceed
// without it, and the block waits on the barrier only before the inter-chunk
// term and the update.  The copy lands row-major [kP][N] without padding, so
// lanes run over N there (a lane reading one column across rows would hit one
// bank 32 ways): each warp holds 4 rows of the state in registers, 4 columns
// a lane; C.h^T is summed across the lanes by a transposing butterfly (31
// shuffles for 32 sums), and h_last leaves as 16-byte stores of whole rows.
// C.B^T is formed the same way, lanes over N and 4 x 8 dot products summed
// by the butterfly, so each row of B and C is read from shared memory once
// per block and not once per output (read per output, C.B^T took a quarter
// of the kernel's time on its shared-memory reads).
//
// Chunk-parallel (S > kQ: long prompts), three launches over chunks of kQ
// rows, the SSD decomposition of the Mamba-2 paper (sec. 6):
//   chunk_state_kernel each chunk's own state from zero, in parallel over
//                      (b, chunk, head): sum_s exp(l_last - l_s) dt_s x_s (x) B_s,
//                      and the chunk's decay exp(l_last); one more row of its
//                      grid forms C.B^T once per (b, chunk) (chunk_cb: the
//                      heads share B and C), beside the states (in a launch
//                      of its own it left most SMs idle for 9 us at S = 4096);
//   state_pass_kernel  the sequential pass, only over the [hd, N] states:
//                      h_c = decay_c h_{c-1} + state_c, each chunk's slot
//                      overwritten in place with the state before it (heads
//                      in the reverse order, so that it starts on the states
//                      the L2 still holds);
//   chunk_scan_kernel  the outputs, in parallel over (b, chunk, head) again:
//                      y = att . x + diag(exp(l)) C . h_prev^T, C and h_prev
//                      in two halves of N through one pair of buffers (72 KB,
//                      three blocks an SM; the whole of N, 104 KB, fits two
//                      and was 14 % slower).
// The states go through device memory (B nc H hd N f32 in a workspace the
// wrapper allocates): at S = 4096, 100 MB written, read, rewritten and read
// again, 400 MB of the schedule's 550 MB.  In f32 on the CUDA cores the
// schedule would be bound by operations (per token and head about
// (Q + 1) hd + 4 hd N of them against 2 hd values of x and y); with the
// products on the tensor cores the bytes weigh as much.  The products run
// as mma.sync m16n8k8 TF32 in 3xTF32, to keep f32's accuracy: each operand
// is split into a TF32 high part (its f32 bits with the low 13 of the
// mantissa masked) and the residual, and hi.hi + hi.lo + lo.hi are summed in
// f32.  Measured on the H100, the products take about a third of the time
// at S = 4096 and the bytes the rest; wgmma for the scan's C . h_prev^T (A
// from registers, h_prev K-major in the 128-byte swizzle) was as exact and
// slower in that kernel (by 14 and 31 %, in two schedules of the wgmma), so
// the products stay on mma.sync.  Operands are staged in shared memory with
// row strides that make every fragment load free of bank conflicts (4 mod
// 32 floats where a lane group reads along a row, 8 mod 32 where it reads
// down a column); f32 tiles come in by cp.async, and the scan's state tile
// in a second group that lands while att . x runs.
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns the first launch error (cudaGetLastError()
// right after each launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 32;          // one chunk: head-dim rows of the state per block
constexpr int kMaxN = 128;      // state columns: 4 a lane
constexpr int kQ = 64;          // chunk-parallel chunk; the longest one chunk
constexpr int kD = 64;          // chunk-parallel: head-dim rows per block
constexpr int kNH = 64;         // chunk-parallel: columns of N a pass takes
constexpr unsigned kFull = 0xffffffffu;

struct ScanArgs {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;
  float* h_last;
  void* y;
  float* work;
  int S, H, hd, N;
  int64_t x_sb, x_ss, x_sh;
  int64_t dt_sb, dt_ss, dt_sh;
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies: the bulk copy on an mbarrier, and cp.async groups
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, counted against the barrier's expected transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes, or 16 zero bytes when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
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

// true for f32 tiles, which stage_tile copies by cp.async
template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// A tile of R rows and `cols` f32 columns (a multiple of 4, the row padded
// for the products) into dst with row stride `ld`, from src rows `src_ld`
// elements apart: rows >= `rows` and columns >= `valid` read as zeros.  f32
// goes by cp.async (the caller commits and waits); bf16 through registers,
// every load of the thread issued before its first store.
template <typename T, int R, int kMaxCols>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const T* src,
                                           int64_t src_ld, int rows, int cols,
                                           int valid, int tid) {
  const int c4 = cols / 4;
  constexpr int kIt = (R * kMaxCols / 4 + kThreads - 1) / kThreads;
  if constexpr (IsF32<T>::value) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads, r = i / c4, q = (i - r * c4) * 4;
      if (i < R * c4) {
        const bool ok = r < rows && q < valid;
        cp_async16(dst + r * ld + q, ok ? src + r * src_ld + q : src, ok);
      }
    }
  } else {
    float4 v[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads, r = i / c4, q = (i - r * c4) * 4;
      v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < R * c4 && r < rows && q < valid) v[it] = load4(src + r * src_ld + q);
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = tid + it * kThreads, r = i / c4, q = (i - r * c4) * 4;
      if (i < R * c4) *reinterpret_cast<float4*>(dst + r * ld + q) = v[it];
    }
  }
}

// ---------------------------------------------------------------------------
// a chunk's decays (warp 0)
// ---------------------------------------------------------------------------

// dt of rows t0 .. t0 + Q - 1 (zero past S and past Q), the inclusive cumsum
// l of A dt by a shuffle scan, and per row l, dt, exp(l) and
// exp(l_last - l) dt; *decay = exp(l_last).  Q <= 64: two rows a lane.
template <typename T, int Q>
__device__ __forceinline__ void chunk_decays(const T* dt, int64_t dt_ss,
                                             int t0, int S, float A, int lane,
                                             float* lv, float* dtv, float* elv,
                                             float* wv, float* decay) {
  float d_lo = 0.f, d_hi = 0.f;
  if (lane < Q && t0 + lane < S)
    d_lo = to_f32(dt[static_cast<int64_t>(t0 + lane) * dt_ss]);
  if (lane + 32 < Q && t0 + lane + 32 < S)
    d_hi = to_f32(dt[static_cast<int64_t>(t0 + lane + 32) * dt_ss]);
  float l_lo = A * d_lo, l_hi = A * d_hi;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, l_lo, o);
    const float v = __shfl_up_sync(kFull, l_hi, o);
    if (lane >= o) {
      l_lo += u;
      l_hi += v;
    }
  }
  l_hi += __shfl_sync(kFull, l_lo, 31);
  float l_last;
  if constexpr (Q > 32) {
    l_last = __shfl_sync(kFull, l_hi, Q - 33);
  } else {
    l_last = __shfl_sync(kFull, l_lo, Q - 1);
  }
  if (lane < Q) {
    lv[lane] = l_lo;
    dtv[lane] = d_lo;
    elv[lane] = expf(l_lo);
    wv[lane] = expf(l_last - l_lo) * d_lo;
  }
  if (lane + 32 < Q) {
    lv[lane + 32] = l_hi;
    dtv[lane + 32] = d_hi;
    elv[lane + 32] = expf(l_hi);
    wv[lane + 32] = expf(l_last - l_hi) * d_hi;
  }
  if (lane == 0) *decay = expf(l_last);
}

// ---------------------------------------------------------------------------
// one chunk: the serving prefill
// ---------------------------------------------------------------------------

// the sums over the warp's 32 lanes of each of the lane's 32 values, one a
// lane: lane l ends with the sum of value l in v[0], after 31 shuffles.  A
// step per halving, recursive so that every index is a constant and v stays
// in registers.
template <int OFF>
__device__ __forceinline__ void transpose_sum(float (&v)[32], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
  if constexpr (OFF > 1) transpose_sum<OFF / 2>(v, lane);
}

// shared memory of a one-chunk block, in floats: the barrier (padded to 128
// bytes), the state [kP][N] as h0 lies, B and C tiles [Q][N + 4], the decayed
// C.B^T [Q][Q + 4], x [Q][kP], y [Q][kP + 4], and l, dt, exp(l),
// exp(l_last - l) dt [Q] each, plus exp(l_last)
__host__ __device__ constexpr int one_chunk_floats(int Q, int N) {
  return 32 + kP * N + 2 * Q * (N + 4) + Q * (Q + 4) + Q * kP + Q * (kP + 4) +
         4 * Q + 4;
}

template <typename T, int Q, bool kState>
__global__ void __launch_bounds__(kThreads) one_chunk_kernel(const ScanArgs a) {
  constexpr int QP = Q + 4;       // padded row of att
  constexpr int YP = kP + 4;      // padded row of y
  constexpr int RY = Q / kWarps;  // rows of y per thread in att.x
  extern __shared__ __align__(128) float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int N = a.N;
  const int NP = N + 4;
  float* const hs = sm + 32;
  float* const Bs = hs + kP * N;
  float* const Cs = Bs + Q * NP;
  float* const att = Cs + Q * NP;
  float* const xs = att + Q * QP;
  float* const ys = xs + Q * kP;
  float* const lv = ys + Q * YP;
  float* const dtv = lv + Q;
  float* const elv = dtv + Q;
  float* const wv = elv + Q;
  float* const decay = wv + Q;

  const int d0 = blockIdx.x * kP;
  const int rows = min(kP, a.hd - d0);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t hoff = ((b * a.H + h) * a.hd + d0) * N;
  const uint32_t bar = smem_u32(sm);

  // the state first: its bytes are most of the block's, and nothing before
  // the inter-chunk term needs them
  if (kState && tid == 0) {
    mbar_init(bar, 1);
    bulk_load(smem_u32(hs), a.h0 + hoff, static_cast<uint32_t>(rows * N * 4),
              bar);
  }

  const T* const x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + d0;
  const T* const dt = static_cast<const T*>(a.dt) + b * a.dt_sb + h * a.dt_sh;
  const T* const Bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* const Cm = static_cast<const T*>(a.Cm) + b * a.c_sb;
  const float A = a.A[h];
  if (warp == 0) chunk_decays<T, Q>(dt, a.dt_ss, 0, a.S, A, lane, lv, dtv, elv, wv, decay);
  // every load of the chunk is issued before the first store, so they are
  // in flight together
  {
    constexpr int kBC = Q * (kMaxN / 4) / kThreads;  // float4s per thread
    constexpr int kX = (Q * (kP / 4) + kThreads - 1) / kThreads;
    const int n4 = N / 4;
    float4 vb[kBC], vc[kBC], vx[kX];
#pragma unroll
    for (int it = 0; it < kBC; ++it) {
      const int i = tid + it * kThreads, r = i / n4, q = (i - r * n4) * 4;
      vb[it] = vc[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < Q * n4 && r < a.S) {
        vb[it] = load4(Bm + static_cast<int64_t>(r) * a.b_ss + q);
        vc[it] = load4(Cm + static_cast<int64_t>(r) * a.c_ss + q);
      }
    }
#pragma unroll
    for (int it = 0; it < kX; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kP / 4), q = (i - r * (kP / 4)) * 4;
      vx[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < Q * (kP / 4) && r < a.S && q < rows)
        vx[it] = load4(x + static_cast<int64_t>(r) * a.x_ss + q);
    }
#pragma unroll
    for (int it = 0; it < kBC; ++it) {
      const int i = tid + it * kThreads, r = i / n4, q = (i - r * n4) * 4;
      if (i < Q * n4) {
        *reinterpret_cast<float4*>(Bs + r * NP + q) = vb[it];
        *reinterpret_cast<float4*>(Cs + r * NP + q) = vc[it];
      }
    }
#pragma unroll
    for (int it = 0; it < kX; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kP / 4), q = (i - r * (kP / 4)) * 4;
      if (i < Q * (kP / 4)) *reinterpret_cast<float4*>(xs + r * kP + q) = vx[it];
    }
  }
  __syncthreads();

  // att[t][s] = exp(l_t - l_s) (C_t . B_s) dt_s for s <= t, else 0, in
  // blocks of 4 rows t x 8 columns s, one a warp at a time: lanes run over
  // N (4 columns a lane), and the block's 32 dot products are summed across
  // the lanes by the butterfly, so each C and B row is read once a block
  // and not once an output; blocks above the diagonal are zeros
  {
    const int n0 = 4 * lane;
    const bool nval = n0 < N;
    constexpr int kSB = Q / 8;    // column blocks of a row block
#pragma unroll 1
    for (int blk = warp; blk < (Q / 4) * kSB; blk += kWarps) {
      const int t0 = (blk / kSB) * 4, s0 = (blk % kSB) * 8;
      const int t = t0 + (lane >> 3), s = s0 + (lane & 7);
      if (s0 > t0 + 3) {
        att[t * QP + s] = 0.f;
        continue;
      }
      float4 cv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = nval ? *reinterpret_cast<const float4*>(Cs + (t0 + i) * NP + n0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = nval ? *reinterpret_cast<const float4*>(Bs + (s0 + j) * NP + n0)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      float v[32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i * 8 + j] = dot4(cv[i], bv[j], 0.f);
      transpose_sum<16>(v, lane);
      att[t * QP + s] = s <= t ? expf(lv[t] - lv[s]) * v[0] * dtv[s] : 0.f;
    }
  }
  __syncthreads();

  // the intra-chunk term of rows warp + 8 r, head-dim row d0 + lane
  {
    float yacc[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) yacc[r] = 0.f;
#pragma unroll 4
    for (int s = 0; s < Q; s += 4) {
      const float4 xv = make_float4(xs[s * kP + lane], xs[(s + 1) * kP + lane],
                                    xs[(s + 2) * kP + lane], xs[(s + 3) * kP + lane]);
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(att + (warp + kWarps * r) * QP + s);
        yacc[r] = dot4(av, xv, yacc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RY; ++r) ys[(warp + kWarps * r) * YP + lane] = yacc[r];
  }

  if constexpr (kState) {
    // rows 4 warp .. 4 warp + 3 of the state, columns 4 lane .. 4 lane + 3
    const int n0 = 4 * lane;
    const bool nval = n0 < N;
    float4 hr[4];
    __syncthreads();              // ys complete before the inter-chunk adds
    mbar_wait(bar, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * warp + j;
      hr[j] = nval && p < rows ? *reinterpret_cast<const float4*>(hs + p * N + n0)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // y[t][p] += exp(l_t) C_t . h_p, eight rows t at a time: 32 partial sums
    // a lane, summed across the lanes; lane l ends with row tb + l / 4 and
    // state row 4 warp + l % 4
#pragma unroll 1
    for (int tb = 0; tb < Q; tb += 8) {
      float v[32];
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) {
        const float4 cv = nval ? *reinterpret_cast<const float4*>(Cs + (tb + tt) * NP + n0)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[tt * 4 + j] = dot4(cv, hr[j], 0.f);
      }
      transpose_sum<16>(v, lane);
      const int t = tb + (lane >> 2);
      ys[t * YP + 4 * warp + (lane & 3)] += elv[t] * v[0];
    }
    // h' = exp(l_last) h + sum_s (x_s w_s) (x) B_s, written as whole rows
    const float dec = *decay;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hr[j].x *= dec;
      hr[j].y *= dec;
      hr[j].z *= dec;
      hr[j].w *= dec;
    }
#pragma unroll 4
    for (int s = 0; s < Q; ++s) {
      const float4 bv = nval ? *reinterpret_cast<const float4*>(Bs + s * NP + n0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 xv = *reinterpret_cast<const float4*>(xs + s * kP + 4 * warp);
      const float w = wv[s];
      const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hr[j].x = fmaf(xw[j], bv.x, hr[j].x);
        hr[j].y = fmaf(xw[j], bv.y, hr[j].y);
        hr[j].z = fmaf(xw[j], bv.z, hr[j].z);
        hr[j].w = fmaf(xw[j], bv.w, hr[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * warp + j;
      if (nval && p < rows)
        *reinterpret_cast<float4*>(a.h_last + hoff + p * N + n0) = hr[j];
    }
  }
  __syncthreads();

  // y, four head-dim columns a thread
  T* const y = static_cast<T*>(a.y) + (b * a.S * a.H + h) * a.hd + d0;
  const int64_t y_ss = static_cast<int64_t>(a.H) * a.hd;
  for (int i = tid; i < Q * (kP / 4); i += kThreads) {
    const int t = i / (kP / 4), q = (i - t * (kP / 4)) * 4;
    if (t < a.S && q < rows)
      store4(y + t * y_ss + q, *reinterpret_cast<const float4*>(ys + t * YP + q));
  }
}

// ---------------------------------------------------------------------------
// chunk-parallel: 3xTF32 products on the tensor cores
// ---------------------------------------------------------------------------

// x as a TF32 high part (its low 13 mantissa bits masked) and the residual
// x - hi, exact in f32; the tensor cores read a TF32 operand's top 19 bits
// only, so the residual's low bits are masked by the product itself
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's A fragment (16 x 8 at rows m0, columns k0), split: element
// (m, k) read by at(m, k); lane (g = lane / 4, t = lane % 4) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float v0, float v1, float v2, float v3) {
    split_tf32(v0, hi[0], lo[0]);
    split_tf32(v1, hi[1], lo[1]);
    split_tf32(v2, hi[2], lo[2]);
    split_tf32(v3, hi[3], lo[3]);
  }
};

// d += a . b in 3xTF32, b the fragment (k = t and t + 4, n = g) of an
// 8 x 8 tile: the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0f,
                                     float b1f) {
  uint32_t b0h, b0l, b1h, b1l;
  split_tf32(b0f, b0h, b0l);
  split_tf32(b1f, b1h, b1l);
  mma_tf32(d, a.lo, b0h, b1h);
  mma_tf32(d, a.hi, b0l, b1l);
  mma_tf32(d, a.hi, b0h, b1h);
}

// the padded K of the products over N: a whole number of 8-column steps
__host__ __device__ constexpr int padded_n(int N) { return (N + 7) / 8 * 8; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// workspace, in floats: the chunk states [B][nc][H][hd][N], C.B^T
// [B][nc][kQ][kQ], the chunk decays [B][H][nc]
__host__ __device__ inline int64_t states_floats(int B, int nc, int H, int hd, int N) {
  return static_cast<int64_t>(B) * nc * H * hd * N;
}
__host__ __device__ inline int64_t cb_floats(int B, int nc) {
  return static_cast<int64_t>(B) * nc * kQ * kQ;
}

// C.B^T of chunk c of row b: [kQ][kQ] f32, the blocks of eight columns above
// the diagonal left unwritten (the scan never reads them); C and B come in
// halves of kNH columns of N, so that it fits the state kernel's shared
// memory, whose grid it shares.
template <typename T>
__device__ __forceinline__ void chunk_cb(const ScanArgs& a, int nc, int c, int64_t b,
                                         float* sm) {
  constexpr int LD = kNH + 4;
  float* const cs = sm;
  float* const bs = cs + kQ * LD;
  const int NK = padded_n(a.N), t0 = c * kQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kQ, a.S - t0);
  const T* const Cm = static_cast<const T*>(a.Cm) + b * a.c_sb + t0 * a.c_ss;
  const T* const Bm = static_cast<const T*>(a.Bm) + b * a.b_sb + t0 * a.b_ss;
  // warp: rows m0 .. m0 + 15 (t), columns n0 .. n0 + 31 (s), 4 tiles of 8
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4] = {};
  for (int nh = 0; nh < NK; nh += kNH) {
    if (nh > 0) __syncthreads();  // every warp done with the previous half
    stage_tile<T, kQ, kNH>(cs, LD, Cm + nh, a.c_ss, rows, min(kNH, NK - nh), a.N - nh, tid);
    stage_tile<T, kQ, kNH>(bs, LD, Bm + nh, a.b_ss, rows, min(kNH, NK - nh), a.N - nh, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int k0 = 0; k0 < min(kNH, NK - nh); k0 += 8) {
      FragA fa;
      fa.set(cs[(m0 + g) * LD + k0 + tq], cs[(m0 + g + 8) * LD + k0 + tq],
             cs[(m0 + g) * LD + k0 + tq + 4], cs[(m0 + g + 8) * LD + k0 + tq + 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = n0 + 8 * j;
        if (nj > m0 + 15) continue;
        mma3(acc[j], fa, bs[(nj + g) * LD + k0 + tq], bs[(nj + g) * LD + k0 + tq + 4]);
      }
    }
  }
  float* const cb = a.work + states_floats(gridDim.z, nc, a.H, a.hd, a.N) +
                    (b * nc + c) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nj = n0 + 8 * j;
    if (nj > m0 + 15) continue;
    store2(cb + (m0 + g) * kQ + nj + 2 * tq, acc[j][0], acc[j][1]);
    store2(cb + (m0 + g + 8) * kQ + nj + 2 * tq, acc[j][2], acc[j][3]);
  }
}

// The state of chunk blockIdx.x / dsl from zero, head-dim rows
// d0 .. d0 + kD - 1 (d0 = kD (blockIdx.x % dsl)), head blockIdx.y - 1, row
// blockIdx.z: [kD][N] = (x w)^T [kD][kQ] . B [kQ][N]; and the chunk's
// decay.  The blocks of blockIdx.y = 0 form the chunk's C.B^T instead.
__host__ __device__ constexpr int chunk_state_floats(int N) {
  // x [kQ][kD + 8], B [kQ][NK + 8] and the decays; or, in the row of blocks
  // that forms C.B^T, halves of C and of B [kQ][kNH + 4] each
  return imax(kQ * (kD + 8) + kQ * (padded_n(N) + 8) + 4 * kQ + 4, 2 * kQ * (kNH + 4));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(const ScanArgs a, int nc) {
  extern __shared__ __align__(128) float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int N = a.N, NK = padded_n(N);
  constexpr int LDX = kD + 8;     // x stored [s][d]: read down columns
  const int LDB = NK + 8;         // B stored [s][n]: read down columns
  float* const xs = sm;
  float* const bs = xs + kQ * LDX;
  float* const lv = bs + kQ * LDB;
  float* const dtv = lv + kQ;
  float* const elv = dtv + kQ;
  float* const wv = elv + kQ;
  float* const decay = wv + kQ;
  const int dsl = (a.hd + kD - 1) / kD;
  const int c = blockIdx.x / dsl, d0 = (blockIdx.x - c * dsl) * kD, t0 = c * kQ;
  const int64_t b = blockIdx.z;
  if (blockIdx.y == 0) {          // the chunk's C.B^T, shared by the heads
    if (d0 == 0) chunk_cb<T>(a, nc, c, b, sm);
    return;
  }
  const int h = blockIdx.y - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kQ, a.S - t0);
  stage_tile<T, kQ, kD>(xs, LDX,
                        static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_ss + h * a.x_sh + d0,
                        a.x_ss, rows, kD, a.hd - d0, tid);
  stage_tile<T, kQ, kMaxN + 8>(bs, LDB, static_cast<const T*>(a.Bm) + b * a.b_sb + t0 * a.b_ss,
                               a.b_ss, rows, NK, N, tid);
  cp_async_commit();
  if (warp == 0)
    chunk_decays<T, kQ>(static_cast<const T*>(a.dt) + b * a.dt_sb + h * a.dt_sh, a.dt_ss, t0,
                        a.S, a.A[h], lane, lv, dtv, elv, wv, decay);
  cp_async_wait<0>();
  __syncthreads();
  const int B = gridDim.z;
  if (tid == 0 && d0 == 0)
    a.work[states_floats(B, nc, a.H, a.hd, N) + cb_floats(B, nc) + (b * a.H + h) * nc + c] = *decay;

  // warp: state rows m0 .. m0 + 15, columns n0 .. n0 + 63, 8 tiles of 8
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 64 * (warp >> 2);
  float acc[8][4] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < kQ; k0 += 8) {
    const float w0 = wv[k0 + tq], w4 = wv[k0 + tq + 4];
    FragA fa;
    fa.set(xs[(k0 + tq) * LDX + m0 + g] * w0, xs[(k0 + tq) * LDX + m0 + g + 8] * w0,
           xs[(k0 + tq + 4) * LDX + m0 + g] * w4, xs[(k0 + tq + 4) * LDX + m0 + g + 8] * w4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nj = n0 + 8 * j;
      if (nj >= N) continue;
      mma3(acc[j], fa, bs[(k0 + tq) * LDB + nj + g], bs[(k0 + tq + 4) * LDB + nj + g]);
    }
  }
  float* const st = a.work + ((b * nc + c) * a.H + h) * static_cast<int64_t>(a.hd) * N;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 8 * j + 2 * tq;
    if (n >= N) continue;
    const int p = d0 + m0 + g;
    if (p < a.hd) store2(st + static_cast<int64_t>(p) * N + n, acc[j][0], acc[j][1]);
    if (p + 8 < a.hd) store2(st + static_cast<int64_t>(p + 8) * N + n, acc[j][2], acc[j][3]);
  }
}

// The sequential pass over chunks, four state elements a thread: chunk c's
// slot is overwritten with the state before chunk c (h0, or zero, for the
// first), and h_last receives the state after the last.  Eight chunks'
// states are loaded together before their updates.
template <bool kState>
__global__ void __launch_bounds__(kThreads) state_pass_kernel(const ScanArgs a, int nc) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  const int64_t per = static_cast<int64_t>(a.hd) * a.N;
  if (e >= per) return;
  // heads in the reverse of the order the chunk states were written and
  // the scan reads them, so each kernel starts on what the L2 still holds
  const int h = a.H - 1 - blockIdx.y;
  const int64_t b = blockIdx.z;
  const int B = gridDim.z;
  const int64_t cstride = a.H * per;
  float* const st = a.work + (b * nc * a.H + h) * per + e;
  const float* const dec =
      a.work + states_floats(B, nc, a.H, a.hd, a.N) + cb_floats(B, nc) + (b * a.H + h) * nc;
  const int64_t hoff = (b * a.H + h) * per + e;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kState) hv = load4(a.h0 + hoff);
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 sv[8];
    float dv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        sv[u] = load4(st + (c0 + u) * cstride);
        dv[u] = dec[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < nc) {
        store4(st + (c0 + u) * cstride, hv);
        hv.x = fmaf(dv[u], hv.x, sv[u].x);
        hv.y = fmaf(dv[u], hv.y, sv[u].y);
        hv.z = fmaf(dv[u], hv.z, sv[u].z);
        hv.w = fmaf(dv[u], hv.w, sv[u].w);
      }
    }
  }
  if constexpr (kState) store4(a.h_last + hoff, hv);
}

// The outputs of chunk blockIdx.x / dsl, head-dim columns d0 .. d0 + kD - 1,
// head blockIdx.y, row blockIdx.z: y [kQ][kD] = att [kQ][kQ] . x [kQ][kD]
// + diag(exp(l)) C [kQ][N] . h_prev^T [N][kD], one accumulator.  C and h_prev
// come in halves of kNH columns of N through one pair of buffers, so three
// blocks fit on an SM.
__host__ __device__ constexpr int chunk_scan_floats(int) {
  return kQ * (kQ + 4) + kQ * (kD + 8) + kQ * (kNH + 4) + kD * (kNH + 4) + 4 * kQ + 4;
}

template <typename T, bool kState>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(const ScanArgs a, int nc) {
  extern __shared__ __align__(128) float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int N = a.N, NK = padded_n(N);
  constexpr int LDA = kQ + 4;     // att [t][s]: read along rows
  constexpr int LDX = kD + 8;     // x [s][d]: read down columns
  constexpr int LDC = kNH + 4;    // C [t][n]: read along rows
  constexpr int LDH = kNH + 4;    // h_prev [d][n]: read along rows
  float* const at = sm;
  float* const xs = at + kQ * LDA;
  float* const cs = xs + kQ * LDX;
  float* const hs = cs + kQ * LDC;
  float* const lv = hs + kD * LDH;
  float* const dtv = lv + kQ;
  float* const elv = dtv + kQ;
  float* const wv = elv + kQ;
  float* const decay = wv + kQ;
  const int dsl = (a.hd + kD - 1) / kD;
  const int c = blockIdx.x / dsl, d0 = (blockIdx.x - c * dsl) * kD, t0 = c * kQ;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int B = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = min(kQ, a.S - t0);
  const bool inter = kState || c > 0;
  const T* const Cm = static_cast<const T*>(a.Cm) + b * a.c_sb + t0 * a.c_ss;
  const float* const hprev = a.work + (((b * nc + c) * a.H + h) * a.hd + d0) * static_cast<int64_t>(N);
  // columns n0 .. n0 + kNH - 1 of C and of the state before the chunk
  auto stage_half = [&](int n0) {
    stage_tile<T, kQ, kNH>(cs, LDC, Cm + n0, a.c_ss, rows, min(kNH, NK - n0), N - n0, tid);
    stage_tile<float, kD, kNH>(hs, LDH, hprev + n0, N, a.hd - d0, min(kNH, NK - n0), N - n0, tid);
  };
  // group 0: C.B^T and x; group 1: the first half of C and the state
  stage_tile<float, kQ, kQ>(at, LDA,
                            a.work + states_floats(B, nc, a.H, a.hd, N) + (b * nc + c) * kQ * kQ,
                            kQ, kQ, kQ, kQ, tid);
  stage_tile<T, kQ, kD>(xs, LDX,
                        static_cast<const T*>(a.x) + b * a.x_sb + t0 * a.x_ss + h * a.x_sh + d0,
                        a.x_ss, rows, kD, a.hd - d0, tid);
  cp_async_commit();
  if (inter) stage_half(0);
  cp_async_commit();
  if (warp == 0)
    chunk_decays<T, kQ>(static_cast<const T*>(a.dt) + b * a.dt_sb + h * a.dt_sh, a.dt_ss, t0,
                        a.S, a.A[h], lane, lv, dtv, elv, wv, decay);
  cp_async_wait<1>();
  __syncthreads();
  // att[t][s] = exp(l_t - l_s) CB[t][s] dt_s for s <= t, in place
  for (int i = tid; i < kQ * kQ; i += kThreads) {
    const int t = i / kQ, s = i - t * kQ;
    float* const p = at + t * LDA + s;
    *p = s <= t ? expf(lv[t] - lv[s]) * *p * dtv[s] : 0.f;
  }
  __syncthreads();

  // warp: rows m0 .. m0 + 15 (t), columns n0 .. n0 + 31 (d), 4 tiles of 8
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4] = {};
  // att . x over s <= the warp's last row
  for (int k0 = 0; k0 < m0 + 16; k0 += 8) {
    FragA fa;
    fa.set(at[(m0 + g) * LDA + k0 + tq], at[(m0 + g + 8) * LDA + k0 + tq],
           at[(m0 + g) * LDA + k0 + tq + 4], at[(m0 + g + 8) * LDA + k0 + tq + 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nj = n0 + 8 * j;
      mma3(acc[j], fa, xs[(k0 + tq) * LDX + nj + g], xs[(k0 + tq + 4) * LDX + nj + g]);
    }
  }
  if (inter) {
    const float e0 = elv[m0 + g], e8 = elv[m0 + g + 8];
    for (int nh = 0; nh < NK; nh += kNH) {
      if (nh > 0) {
        __syncthreads();          // every warp done with the previous half
        stage_half(nh);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      const int kend = min(kNH, NK - nh);
#pragma unroll 2
      for (int k0 = 0; k0 < kend; k0 += 8) {
        FragA fa;
        fa.set(cs[(m0 + g) * LDC + k0 + tq] * e0, cs[(m0 + g + 8) * LDC + k0 + tq] * e8,
               cs[(m0 + g) * LDC + k0 + tq + 4] * e0, cs[(m0 + g + 8) * LDC + k0 + tq + 4] * e8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nj = n0 + 8 * j;
          mma3(acc[j], fa, hs[(nj + g) * LDH + k0 + tq], hs[(nj + g) * LDH + k0 + tq + 4]);
        }
      }
    }
  }
  T* const y = static_cast<T*>(a.y) + ((b * a.S + t0) * a.H + h) * a.hd + d0;
  const int64_t y_ss = static_cast<int64_t>(a.H) * a.hd;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = n0 + 8 * j + 2 * tq;
    if (d0 + d >= a.hd) continue;
    const int t = m0 + g;
    if (t < rows) store2(y + t * y_ss + d, acc[j][0], acc[j][1]);
    if (t + 8 < rows) store2(y + (t + 8) * y_ss + d, acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// the most shared memory a kernel can take (N = kMaxN), granted once per
// kernel, before its first launch (and so outside any CUDA-graph capture)
template <typename K>
cudaError_t grant(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * floats));
}

template <typename T, int Q, bool kState>
int launch_one_chunk(const ScanArgs& a, int B, cudaStream_t stream) {
  static const cudaError_t granted =
      grant(one_chunk_kernel<T, Q, kState>, one_chunk_floats(Q, kMaxN));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const dim3 grid(static_cast<unsigned>((a.hd + kP - 1) / kP),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  one_chunk_kernel<T, Q, kState>
      <<<grid, kThreads, sizeof(float) * one_chunk_floats(Q, a.N), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kState>
int launch_chunk_parallel(const ScanArgs& a, int B, cudaStream_t stream) {
  static const cudaError_t granted[2] = {
      grant(chunk_state_kernel<T>, chunk_state_floats(kMaxN)),
      grant(chunk_scan_kernel<T, kState>, chunk_scan_floats(kMaxN))};
  for (cudaError_t e : granted)
    if (e != cudaSuccess) return static_cast<int>(e);
  const int nc = (a.S + kQ - 1) / kQ;
  const unsigned dsl = static_cast<unsigned>((a.hd + kD - 1) / kD);
  const unsigned H = static_cast<unsigned>(a.H), Bu = static_cast<unsigned>(B);
  const unsigned pass_blocks =
      static_cast<unsigned>((a.hd * a.N / 4 + kThreads - 1) / kThreads);
  // the state kernel's grid holds one more row of blocks for C.B^T
  chunk_state_kernel<T><<<dim3(nc * dsl, H + 1, Bu), kThreads,
                          sizeof(float) * chunk_state_floats(a.N), stream>>>(a, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  state_pass_kernel<kState><<<dim3(pass_blocks, H, Bu), kThreads, 0, stream>>>(a, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  chunk_scan_kernel<T, kState><<<dim3(nc * dsl, H, Bu), kThreads,
                                 sizeof(float) * chunk_scan_floats(a.N), stream>>>(a, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kState>
int dispatch(const ScanArgs& a, int B, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (a.S <= 16) return launch_one_chunk<T, 16, kState>(a, B, stream);
  if (a.S <= 32) return launch_one_chunk<T, 32, kState>(a, B, stream);
  if (a.S <= kQ) return launch_one_chunk<T, kQ, kState>(a, B, stream);
  return launch_chunk_parallel<T, kState>(a, B, stream);
}

}  // namespace

// x [B, S, H, hd] with strides (x_sb, x_ss, x_sh, 1); dt [B, S, H] with
// strides (dt_sb, dt_ss, dt_sh); A [H] f32; Bm / Cm [B, S, N] with strides
// (*_sb, *_ss, 1); y [B, S, H, hd] and h0 / h_last [B, H, hd, N] contiguous
// (h0 and h_last unused by ssd_scan_*); work: ssd_scan_workspace_floats(B,
// S, H, hd, N) f32 (unused, and may be null, when S <= ssd_scan_chunk()).
// hd % 4 == 0, N % 4 == 0, N <= 128, 16-byte aligned rows: the wrapper
// checks all of these.
#define SSD_ENTRY(NAME, T, STATE)                                              \
  extern "C" int NAME(const void* x, const void* dt, const void* A,            \
                      const void* Bm, const void* Cm, const void* h0,          \
                      void* h_last, void* y, void* work, int B, int S, int H,  \
                      int hd, int N, int64_t x_sb, int64_t x_ss, int64_t x_sh, \
                      int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,             \
                      int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,  \
                      void* stream) {                                          \
    ScanArgs a{x,     dt,    static_cast<const float*>(A),                     \
               Bm,    Cm,    static_cast<const float*>(h0),                    \
               static_cast<float*>(h_last),                                    \
               y,     static_cast<float*>(work),                               \
               S,     H,     hd,   N,     x_sb,  x_ss,  x_sh,                  \
               dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};                   \
    return dispatch<T, STATE>(a, B, stream);                                   \
  }

SSD_ENTRY(ssd_scan_f32, float, false)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16, false)
SSD_ENTRY(ssd_chunked_f32, float, true)
SSD_ENTRY(ssd_chunked_bf16, __nv_bfloat16, true)

// the chunk of the chunk-parallel schedule, and the longest S one launch
// takes
extern "C" int ssd_scan_chunk() { return kQ; }

extern "C" int64_t ssd_scan_workspace_floats(int B, int S, int H, int hd, int N) {
  if (S <= kQ) return 0;
  const int nc = (S + kQ - 1) / kQ;
  return states_floats(B, nc, H, hd, N) + cb_floats(B, nc) + static_cast<int64_t>(B) * H * nc;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
