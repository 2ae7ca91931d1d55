// Softmax entropy / confidence statistics: the controller's L(x).
//
// Replaces the TPU kernel src/repro/kernels/entropy.py:_entropy_kernel
// (entry entropy_stats).  logits [B, V] (f32 or bf16, row-major,
// contiguous) -> entropy [B] f32 (nats), max_prob [B] f32, argmax [B]
// int32 (first index of the maximum), in one pass over V:
//
//     m = max_v x_v,  s = sum_v e^{x_v - m},  u = sum_v x_v e^{x_v - m}
//     H = m + log(s) - u/s,   p_max = 1/s
//
// Statistics (m, s, u, idx) merge as
//     m = max(m1, m2),  s = s1 e^{m1-m} + s2 e^{m2-m}  (u likewise),
//     idx = the lower index when m1 == m2,
// so the result is the FIRST index of the maximum, as the TPU kernel's
// strict `>` across blocks plus jnp.argmax within a block gives, in
// whatever order partials meet.  Anything that owns no column starts at
// m = -1e30, s = u = 0 (the TPU kernel's _NEG), not at -inf: merging two
// -inf maxima would give exp(-inf - -inf) = NaN.  All arithmetic is f32
// with expf/logf (no fast math).
//
// What bounds it on the H100: the kernel reads B*V*itemsize bytes and
// writes 12*B; its arithmetic (an exp and a few FLOPs per element) is far
// below the card's f32 rate, so its least time is those bytes at 3.35
// TB/s, or, where that is under a microsecond, the launch floor
// (entropy_empty below: one warp that does nothing).  Three schedules,
// chosen by entropy_schedule() in entropy.py from (B, V, itemsize, SM
// count) and passed in by the wrapper:
//
//   packed (V <= 16; the gated step's [64 or 128, 2]): bound by the
//     launch floor.  One thread per row and every row of a block its own
//     thread, so 64 x 2 and 128 x 2 are one block; each thread reads its
//     row in the widest loads (<= 16 bytes) that divide it and its start
//     (a 2 x f32 row is one 8-byte load) and keeps its statistics in
//     registers: no shuffle, no shared memory, no barrier.  Beyond 16
//     columns one thread's chain of loads loses to a warp.
//   warp (rows of up to 4 KB): a warp per row, several rows a block once
//     there are more rows than SMs; two rounds of loads at most.
//   split (longer rows; bound by bytes): each row split into `splits`
//     contiguous slices, one block of 256 threads each, so that every SM
//     has a block and each slice is one round of loads (a block a row,
//     8 x 256000 would stream through 8 of the 132 SMs).  The partials
//     merge inside the same launch: each block writes its partial to
//     global scratch and takes a ticket with one acquire-release atomic;
//     the row's last block reads every partial (lane l folds slices l,
//     l+32, ... in rank order) and merges them.  The ticket wraps to 0 at
//     `splits` (atomic inc), so it is zero again for the next call.  A
//     thread-block-cluster merge through distributed shared memory was
//     slower on the H100 at all but one split case (PERF.md, kernel #1).
//   In warp and split, a lane reads 16-byte vectors (4 f32 or 8 bf16) in
//   rounds of kUnroll, all of a round's loads in flight together, and
//   folds a round with one rescale of (s, u): the round's maximum first,
//   not one rescale per element.  A row whose start is not 16-byte
//   aligned (odd V) is read as a scalar head up to the first aligned
//   address, the aligned vectors, and a scalar tail: no load runs past
//   the row.  Lanes, then warps, merge as: their maximum, one rescale
//   each, then plain sums (one exp a lane, not one a tree level).
//
// Plain C interface, bound from Python with ctypes: each entry point
// launches on the given stream and returns the launch's error (or
// cudaGetLastError() right after it), so a refused launch (a bad
// configuration) is reported where it happened.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kVecBytes = 16;
constexpr int kUnroll = 4;

enum Schedule { kPacked = 0, kWarp = 1, kSplit = 2 };

struct Stats {
  float m;
  float s;
  float u;
  int idx;
};

struct Out {
  float* entropy;
  float* max_prob;
  int32_t* argmax;
};

__device__ __forceinline__ Stats neutral() { return {kNeg, 0.0f, 0.0f, 0}; }

// one exp: the side with the larger maximum keeps its sums as they are
__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  const float d = a.m - b.m;
  const float e = expf(-fabsf(d));
  const bool a_hi = d >= 0.0f;
  Stats r;
  r.m = a_hi ? a.m : b.m;
  r.s = a_hi ? fmaf(b.s, e, a.s) : fmaf(a.s, e, b.s);
  r.u = a_hi ? fmaf(b.u, e, a.u) : fmaf(a.u, e, b.u);
  r.idx = d > 0.0f ? a.idx : (d < 0.0f ? b.idx : min(a.idx, b.idx));
  return r;
}

// Lane 0 ends with the merge of lanes 0 .. lanes-1 (a power of two): the
// lanes' maximum first, then each lane rescales its own (s, u) to it with
// one exp, then plain sums; the index is the least among the lanes that
// hold the maximum.  One exp a lane, where pairwise merges take one a
// level.  The sums meet as a tree, lane i with lane i + lanes/2 first.
__device__ __forceinline__ Stats warp_reduce(const Stats& a, int lanes = 32) {
  float m = a.m;
  for (int offset = lanes >> 1; offset > 0; offset >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  }
  const float c = expf(a.m - m);
  float s = a.s * c;
  float u = a.u * c;
  int idx = a.m == m ? a.idx : 0x7fffffff;
  for (int offset = lanes >> 1; offset > 0; offset >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, offset);
    u += __shfl_xor_sync(0xffffffffu, u, offset);
    idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, offset));
  }
  return {m, s, u, idx};
}

// the least power of two >= n (n <= 32)
__device__ __forceinline__ int lanes_for(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

__device__ __forceinline__ void write(const Out& out, int64_t row,
                                      const Stats& t) {
  out.entropy[row] = t.m + logf(t.s) - t.u / t.s;
  out.max_prob[row] = 1.0f / t.s;
  out.argmax[row] = t.idx;
}

// N consecutive elements from p (aligned to their N * sizeof(T) bytes),
// as f32: f32 bits as they are, bf16 as the top half of an f32
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&x)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes <= kVecBytes, "one load moves at most 16 bytes");
  if constexpr (kBytes == 2) {
    x[0] = __uint_as_float(
        static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  } else {
    unsigned w[kBytes / 4];
    if constexpr (kBytes == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (sizeof(T) == 4) {
        x[k] = __uint_as_float(w[k]);
      } else {
        x[k] = __uint_as_float(k & 1 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
      }
    }
  }
}

// Fold a round of U vectors of E elements into t: vector r starts at
// column col + r * stride.  The round's maximum and its first column
// first (within each vector, then across vectors, the earlier element
// winning a tie), then one rescale of (s, u) for the round, not one per
// element.  A vector that holds no data is filled with kNeg: it moves no
// maximum and adds e^{-1e30 - m} = 0.
template <int U, int E>
__device__ __forceinline__ void fold_round(Stats& t, const float (&x)[U][E],
                                           int col, int stride) {
  float vm[U];
  int vk[U];
#pragma unroll
  for (int r = 0; r < U; ++r) {
    vm[r] = x[r][0];
    vk[r] = 0;
#pragma unroll
    for (int k = 1; k < E; ++k) {
      if (x[r][k] > vm[r]) {
        vm[r] = x[r][k];
        vk[r] = k;
      }
    }
  }
  float rm = vm[0];
  int rc = col + vk[0];
#pragma unroll
  for (int r = 1; r < U; ++r) {
    if (vm[r] > rm) {
      rm = vm[r];
      rc = col + r * stride + vk[r];
    }
  }
  const float m = fmaxf(t.m, rm);
  float s = 0.0f;
  float u = 0.0f;
#pragma unroll
  for (int r = 0; r < U; ++r) {
    float se = 0.0f;
    float ue = 0.0f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float e = expf(x[r][k] - m);
      se += e;
      ue = fmaf(x[r][k], e, ue);
    }
    s += se;
    u += ue;
  }
  const float c = expf(t.m - m);
  t.idx = rm > t.m ? rc : (rm == t.m ? min(t.idx, rc) : t.idx);
  t.s = fmaf(t.s, c, s);
  t.u = fmaf(t.u, c, u);
  t.m = m;
}

// The statistics of slice k of `splits` of one row, as thread `tid` of
// `nthreads` sees them.  The row is a scalar head up to its first
// 16-byte aligned element, `nvec` aligned vectors, and a scalar tail;
// slice k owns vectors [nvec k / splits, nvec (k+1) / splits), slice 0
// the head and the last slice the tail.  Thread tid folds head element
// tid, then rounds of kUnroll vectors (v, v + nthreads, ...; all loads of
// a round in flight together) from vector tid of its slice on, then tail
// element tid.
template <typename T>
__device__ __forceinline__ Stats slice_stats(const T* x, int64_t cols, int k,
                                             int splits, int tid,
                                             int nthreads) {
  constexpr int E = kVecBytes / static_cast<int>(sizeof(T));
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) &
                                   (kVecBytes - 1));
  const int64_t to_aligned =
      ((kVecBytes - mis) & (kVecBytes - 1)) / static_cast<int>(sizeof(T));
  const int64_t head = to_aligned < cols ? to_aligned : cols;
  const int64_t nvec = (cols - head) / E;
  const int64_t tail = head + nvec * E;
  Stats t = neutral();
  if (k == 0 && tid < head) {
    float v[1][1];
    load<T, 1>(x + tid, v[0]);
    fold_round<1, 1>(t, v, tid, 0);
  }
  const T* body = x + head;
  const int64_t v1 = nvec * (k + 1) / splits;
  const int64_t step = static_cast<int64_t>(nthreads);
  for (int64_t v = nvec * k / splits + tid; v < v1; v += kUnroll * step) {
    float buf[kUnroll][E];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      if (v + r * step < v1) {
        load<T, E>(body + (v + r * step) * E, buf[r]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) buf[r][e] = kNeg;
      }
    }
    fold_round<kUnroll, E>(t, buf, static_cast<int>(head + v * E),
                           nthreads * E);
  }
  if (k == splits - 1 && tid < cols - tail) {
    float e[1][1];
    load<T, 1>(x + tail + tid, e[0]);
    fold_round<1, 1>(t, e, static_cast<int>(tail + tid), 0);
  }
  return t;
}

template <typename T, int N>
__global__ void packed_kernel(const T* __restrict__ logits, Out out,
                              int64_t rows, int64_t cols) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= rows) return;
  const T* x = logits + row * cols;
  Stats t = neutral();
#pragma unroll 4
  for (int64_t j = 0; j < cols; j += N) {
    float v[1][N];
    load<T, N>(x + j, v[0]);
    fold_round<1, N>(t, v, static_cast<int>(j), 0);
  }
  write(out, row, t);
}

template <typename T>
__global__ void warp_kernel(const T* __restrict__ logits, Out out,
                            int64_t rows, int64_t cols) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  Stats t = slice_stats(logits + row * cols, cols, 0, 1, lane, 32);
  t = warp_reduce(t);
  if (lane == 0) write(out, row, t);
}

// grid: rows x splits blocks, block b on slice b % splits of row
// b / splits; kTicket: more than one slice, merged by the last block
template <typename T, bool kTicket>
__global__ void split_kernel(const T* __restrict__ logits, Out out,
                             int64_t cols, int splits,
                             float4* __restrict__ partials,
                             unsigned* __restrict__ tickets) {
  const int64_t row = blockIdx.x / splits;
  const int k = static_cast<int>(blockIdx.x % splits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Stats t = slice_stats(logits + row * cols, cols, k, splits, threadIdx.x,
                        blockDim.x);

  // the block's partial, in thread 0
  __shared__ Stats warp_part[32];
  t = warp_reduce(t);
  if (lane == 0) warp_part[warp] = t;
  __syncthreads();
  if (warp == 0) {
    const int warps = static_cast<int>(blockDim.x >> 5);
    t = lane < warps ? warp_part[lane] : neutral();
    t = warp_reduce(t, lanes_for(warps));
  }

  if constexpr (!kTicket) {
    if (threadIdx.x == 0) write(out, row, t);
  } else {
    __shared__ bool last;
    if (threadIdx.x == 0) {
      partials[row * splits + k] = make_float4(t.m, t.s, t.u,
                                               __int_as_float(t.idx));
      // release: the partial is visible before the ticket; acquire: the
      // last block sees every other block's partial
      unsigned ticket;
      asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                   : "=r"(ticket)
                   : "l"(tickets + row), "r"(static_cast<unsigned>(splits - 1))
                   : "memory");
      last = ticket == static_cast<unsigned>(splits - 1);
    }
    __syncthreads();
    if (!last || warp != 0) return;
    Stats p = neutral();
    for (int r = lane; r < splits; r += 32) {
      const float4 q = __ldcg(partials + row * splits + r);
      p = merge(p, Stats{q.x, q.y, q.z, __float_as_int(q.w)});
    }
    p = warp_reduce(p, lanes_for(splits < 32 ? splits : 32));
    if (lane == 0) write(out, row, p);
  }
}

__global__ void empty_kernel() {}

template <typename T, int N>
int launch_packed(const T* x, Out out, int64_t rows, int64_t cols,
                  int threads, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  packed_kernel<T, N><<<blocks, threads, 0, stream>>>(x, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* logits, void* entropy, void* max_prob, void* argmax,
           int64_t rows, int64_t cols, int schedule, int threads,
           int vector, int splits, void* partials, void* tickets,
           void* stream_ptr) {
  const T* x = static_cast<const T*>(logits);
  const Out out{static_cast<float*>(entropy), static_cast<float*>(max_prob),
                static_cast<int32_t*>(argmax)};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr int kMaxVector = kVecBytes / static_cast<int>(sizeof(T));
  if (rows < 1 || cols < 1 || cols > INT32_MAX || threads < 32 ||
      threads > 1024 || threads % 32 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (schedule == kPacked) {
    const bool aligned =
        vector >= 1 && vector <= kMaxVector && cols % vector == 0 &&
        reinterpret_cast<uintptr_t>(x) % (vector * sizeof(T)) == 0;
    if (!aligned || splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (vector) {
      case 1: return launch_packed<T, 1>(x, out, rows, cols, threads, stream);
      case 2: return launch_packed<T, 2>(x, out, rows, cols, threads, stream);
      case 4: return launch_packed<T, 4>(x, out, rows, cols, threads, stream);
      case 8:
        if constexpr (kMaxVector >= 8) {
          return launch_packed<T, 8>(x, out, rows, cols, threads, stream);
        }
        break;
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vector != kMaxVector) return static_cast<int>(cudaErrorInvalidValue);
  if (schedule == kWarp) {
    const int64_t per_block = threads / 32;
    warp_kernel<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                     threads, 0, stream>>>(x, out, rows, cols);
    return static_cast<int>(cudaGetLastError());
  }
  if (schedule != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(rows * splits);
  if (splits == 1) {
    split_kernel<T, false><<<blocks, threads, 0, stream>>>(
        x, out, cols, 1, nullptr, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  if (partials == nullptr || tickets == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_kernel<T, true><<<blocks, threads, 0, stream>>>(
      x, out, cols, splits, static_cast<float4*>(partials),
      static_cast<unsigned*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int entropy_stats_f32(const void* logits, void* entropy, void* max_prob,
                      void* argmax, int64_t rows, int64_t cols, int schedule,
                      int threads, int vector, int splits, void* partials,
                      void* tickets, void* stream) {
  return launch<float>(logits, entropy, max_prob, argmax, rows, cols,
                       schedule, threads, vector, splits, partials, tickets,
                       stream);
}

int entropy_stats_bf16(const void* logits, void* entropy, void* max_prob,
                       void* argmax, int64_t rows, int64_t cols, int schedule,
                       int threads, int vector, int splits, void* partials,
                       void* tickets, void* stream) {
  return launch<__nv_bfloat16>(logits, entropy, max_prob, argmax, rows, cols,
                               schedule, threads, vector, splits, partials,
                               tickets, stream);
}

// the id of the CUDA graph capture `stream` is in (*id = 0 when it is
// not capturing), so the wrapper gives each capture its own tickets
int entropy_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, id);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return 0;
}

// one warp that does nothing: the card's launch floor
int entropy_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
