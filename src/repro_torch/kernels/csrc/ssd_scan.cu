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
// Two entry points share one kernel body through the template flag kState:
//   ssd_scan_{f32,bf16}     zero initial state, writes y only (the TPU
//                           kernel's contract: a prefill from nothing);
//   ssd_chunked_{f32,bf16}  reads h0 [B, H, hd, N] f32 and writes h_last
//                           [B, H, hd, N] f32 as well (ssd_chunked's contract:
//                           a prefill into a decode cache).
// x, Bm and Cm are read through their strides (last dimension contiguous), so
// the model's views into its conv output go in as they are; dt through its
// three strides; y, h0 and h_last are contiguous.
//
// Design.  The TPU kernel threads the state through VMEM scratch along its
// innermost, sequential grid axis.  Blocks on Hopper run in no order, so here
// one block of 256 threads owns (b, h, a slice of kP = 32 head-dim rows: the
// rows of h [hd, N] are independent) and loops over the chunks itself,
// keeping its [kP, N] part of the state in shared memory.  At B = 1 and
// S = 4096 the 48 (b, h) pairs of mamba2-780m become 96 blocks; a finer slice
// would fill more SMs but repeat the C.B^T product once more per slice.
//
// Chunk length.  Shared memory decides it: one chunk of the model's Q = 256 at
// N = 128 needs B and C tiles of 256 x 128 f32, 256 KB, above the 227 KB a
// block may use.  The kernel takes Q = 64 (B and C tiles, the [Q, Q] decay-
// weighted C.B^T, x and the state: 111 KB at N = 128, so two blocks fit on an
// SM), and Q = 16 or 32 when the whole sequence fits in one such chunk (the
// serving prefill of 16-token prompts), so no block works on 48 rows of
// padding.  The result is invariant to the chunk up to rounding
// (tests/test_kernels.py:361 holds the reference to that within 2e-4).
//
// Per chunk: warp 0 reads dt, forms the cumsum by a shuffle scan and the
// exponentials; all threads stage B, C (rows padded by 4 floats, so 16 rows
// read as float4 at one column fall in distinct banks) and x; then (A) each
// thread computes a (Q/16)^2 tile of the masked, decayed C.B^T and every
// thread its Q/8 rows of one head-dim column of the inter-chunk term from the
// state; then (B) the intra-chunk term att.x completes y, which is written,
// and each warp updates 16 state columns of its lane's row.  Three barriers
// per chunk separate the phases.
//
// Bound on the H100: operations, except for a short prefill into a cache.
// Per token and head the chunked algorithm needs about (Q + 1) hd operations
// for att.x and 4 hd N for the inter-chunk term and the state update, against
// 2 hd values of x and y (B, C and dt are shared by the heads); at mamba2's
// hd 64 and N 128 that is about 70 f32 operations per byte, above the card's
// 67 TFLOP/s (f32, CUDA cores) over 3.35 TB/s = 20, so the scan is bound by
// the f32 units.  The ssd_chunked entry also reads h0 and writes h_last,
// 2 x 4 hd N bytes per (b, h): over a 16-token prompt that outweighs the
// operations, and the serving prefill is bound by the state's bytes, which
// are read and written once.  What the design does about it: every operand
// of the inner loops is read from shared memory as a float4 or a broadcast,
// a chunk's global loads are all in flight before the first is stored, the
// causal mask and the decay are applied once when att is formed, the first
// chunk of the zero-state entry skips the inter-chunk term, and short
// sequences take a short chunk.  Left for later work: the C.B^T, att.x and
// state products on the tensor cores (wgmma), and C.B^T computed once per
// (b, chunk) instead of once per (head, slice).
//
// Plain C interface, bound from Python with ctypes: each entry point launches
// on the given stream and returns cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 32;          // head-dim rows of the state per block
constexpr int kMaxN = 128;      // state columns: 16 per warp in the update
constexpr int kHP = kP + 1;     // padded row of the transposed state
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// shared memory of one block, in floats: B and C tiles [Q][N + 4], the decayed
// C.B^T [Q][Q + 4], x [Q][kP], the state transposed [N][kP + 1], and l, dt,
// exp(l), exp(l_last - l) dt [Q] each, plus exp(l_last)
__host__ __device__ constexpr int smem_floats(int Q, int N) {
  return 2 * Q * (N + 4) + Q * (Q + 4) + Q * kP + N * kHP + 4 * Q + 4;
}

template <typename T, int Q, bool kState>
__global__ void __launch_bounds__(kThreads) ssd_kernel(const ScanArgs a) {
  constexpr int QP = Q + 4;       // padded row of att
  constexpr int RT = Q / 16;      // C.B^T tile per thread: RT x RT
  constexpr int RY = Q / kWarps;  // rows of y per thread
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int N = a.N;
  const int NP = N + 4;
  float* const Bs = sm;
  float* const Cs = Bs + Q * NP;
  float* const att = Cs + Q * NP;
  float* const xs = att + Q * QP;
  float* const hs = xs + Q * kP;
  float* const lv = hs + N * kHP;
  float* const dtv = lv + Q;
  float* const elv = dtv + Q;
  float* const wv = elv + Q;
  float* const decay = wv + Q;

  const int d0 = blockIdx.x * kP;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* const x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + d0;
  const T* const dt = static_cast<const T*>(a.dt) + b * a.dt_sb + h * a.dt_sh;
  const T* const Bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* const Cm = static_cast<const T*>(a.Cm) + b * a.c_sb;
  T* const y = static_cast<T*>(a.y) + ((b * a.S) * a.H + h) * a.hd + d0;
  const int64_t y_ss = static_cast<int64_t>(a.H) * a.hd;
  const int64_t hoff = ((b * a.H + h) * a.hd + d0) * N;
  const float A = a.A[h];
  const bool dvalid = d0 + lane < a.hd;
  const int nb = warp * 16;       // this warp's state columns in the update

  for (int i = tid; i < kP * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    float v = 0.f;
    if (kState && d0 + p < a.hd) v = a.h0[hoff + static_cast<int64_t>(p) * N + n];
    hs[n * kHP + p] = v;
  }

  const int nchunks = (a.S + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    if (warp == 0) {
      // rows lane and lane + 32 of the chunk; zero dt past S and past Q
      float d_lo = 0.f, d_hi = 0.f;
      if (lane < Q && t0 + lane < a.S)
        d_lo = to_f32(dt[static_cast<int64_t>(t0 + lane) * a.dt_ss]);
      if (lane + 32 < Q && t0 + lane + 32 < a.S)
        d_hi = to_f32(dt[static_cast<int64_t>(t0 + lane + 32) * a.dt_ss]);
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
        if (i < Q * n4 && t0 + r < a.S) {
          vb[it] = load4(Bm + static_cast<int64_t>(t0 + r) * a.b_ss + q);
          vc[it] = load4(Cm + static_cast<int64_t>(t0 + r) * a.c_ss + q);
        }
      }
#pragma unroll
      for (int it = 0; it < kX; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / (kP / 4), q = (i - r * (kP / 4)) * 4;
        vx[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < Q * (kP / 4) && t0 + r < a.S && d0 + q < a.hd)
          vx[it] = load4(x + static_cast<int64_t>(t0 + r) * a.x_ss + q);
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

    // (A) att[t][s] = exp(l_t - l_s) (C_t . B_s) dt_s for s <= t, else 0; rows
    // ti + 16 i and columns si + 16 j of this thread
    {
      const int ti = tid & 15, si = tid >> 4;
      float cb[RT][RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) cb[i][j] = 0.f;
      for (int k = 0; k < N; k += 4) {
        float4 cv[RT], bv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          cv[i] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * i) * NP + k);
#pragma unroll
        for (int j = 0; j < RT; ++j)
          bv[j] = *reinterpret_cast<const float4*>(Bs + (si + 16 * j) * NP + k);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) cb[i][j] = dot4(cv[i], bv[j], cb[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int t = ti + 16 * i, s = si + 16 * j;
          att[t * QP + s] = s <= t ? expf(lv[t] - lv[s]) * cb[i][j] * dtv[s] : 0.f;
        }
    }
    // the inter-chunk term of rows warp + 8 r, head-dim row d0 + lane
    float yacc[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) yacc[r] = 0.f;
    if (kState || c > 0) {
      for (int k = 0; k < N; k += 4) {
        const float4 hv = make_float4(hs[k * kHP + lane], hs[(k + 1) * kHP + lane],
                                      hs[(k + 2) * kHP + lane], hs[(k + 3) * kHP + lane]);
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          const float4 cv = *reinterpret_cast<const float4*>(Cs + (warp + kWarps * r) * NP + k);
          yacc[r] = dot4(cv, hv, yacc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RY; ++r) yacc[r] *= elv[warp + kWarps * r];
    }
    __syncthreads();

    // (B) y += att . x, written; then the state update of columns nb .. nb + 15
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
    if (dvalid) {
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int t = t0 + warp + kWarps * r;
        if (t < a.S) store(y + t * y_ss + lane, yacc[r]);
      }
    }
    if (nb < N) {
      const float dec = *decay;
      float hacc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        hacc[j] = nb + j < N ? hs[(nb + j) * kHP + lane] * dec : 0.f;
      for (int s = 0; s < Q; ++s) {
        const float xw = xs[s * kP + lane] * wv[s];
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          if (nb + 4 * j4 < N) {
            const float4 bv = *reinterpret_cast<const float4*>(Bs + s * NP + nb + 4 * j4);
            hacc[4 * j4 + 0] = fmaf(xw, bv.x, hacc[4 * j4 + 0]);
            hacc[4 * j4 + 1] = fmaf(xw, bv.y, hacc[4 * j4 + 1]);
            hacc[4 * j4 + 2] = fmaf(xw, bv.z, hacc[4 * j4 + 2]);
            hacc[4 * j4 + 3] = fmaf(xw, bv.w, hacc[4 * j4 + 3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (nb + j < N) hs[(nb + j) * kHP + lane] = hacc[j];
    }
    __syncthreads();
  }

  if constexpr (kState) {
    for (int i = tid; i < kP * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      if (d0 + p < a.hd) a.h_last[hoff + static_cast<int64_t>(p) * N + n] = hs[n * kHP + p];
    }
  }
}

template <typename T, int Q, bool kState>
int launch(const ScanArgs& a, int B, void* stream) {
  // the most shared memory this instantiation can take (N = kMaxN), granted
  // once, before any launch (and so outside any CUDA-graph capture)
  static const cudaError_t granted = cudaFuncSetAttribute(
      ssd_kernel<T, Q, kState>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * smem_floats(Q, kMaxN)));
  if (granted != cudaSuccess) return static_cast<int>(granted);
  const dim3 grid(static_cast<unsigned>((a.hd + kP - 1) / kP),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  const size_t smem = sizeof(float) * smem_floats(Q, a.N);
  ssd_kernel<T, Q, kState>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kState>
int dispatch(const ScanArgs& a, int B, void* stream) {
  if (a.S <= 16) return launch<T, 16, kState>(a, B, stream);
  if (a.S <= 32) return launch<T, 32, kState>(a, B, stream);
  return launch<T, 64, kState>(a, B, stream);
}

}  // namespace

// x [B, S, H, hd] with strides (x_sb, x_ss, x_sh, 1); dt [B, S, H] with
// strides (dt_sb, dt_ss, dt_sh); A [H] f32; Bm / Cm [B, S, N] with strides
// (*_sb, *_ss, 1); y [B, S, H, hd] and h0 / h_last [B, H, hd, N] contiguous
// (h0 and h_last unused by ssd_scan_*).  hd % 4 == 0, N % 4 == 0, N <= 128,
// 16-byte aligned rows: the wrapper checks all of these.
#define SSD_ENTRY(NAME, T, STATE)                                              \
  extern "C" int NAME(const void* x, const void* dt, const void* A,            \
                      const void* Bm, const void* Cm, const void* h0,          \
                      void* h_last, void* y, int B, int S, int H, int hd,      \
                      int N, int64_t x_sb, int64_t x_ss, int64_t x_sh,         \
                      int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,             \
                      int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,  \
                      void* stream) {                                          \
    ScanArgs a{x,     dt,    static_cast<const float*>(A),                     \
               Bm,    Cm,    static_cast<const float*>(h0),                    \
               static_cast<float*>(h_last),                                    \
               y,     S,     H,    hd,    N,     x_sb,  x_ss,  x_sh,           \
               dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss};                   \
    return dispatch<T, STATE>(a, B, stream);                                   \
  }

SSD_ENTRY(ssd_scan_f32, float, false)
SSD_ENTRY(ssd_scan_bf16, __nv_bfloat16, false)
SSD_ENTRY(ssd_chunked_f32, float, true)
SSD_ENTRY(ssd_chunked_bf16, __nv_bfloat16, true)

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
