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
// Design: one block of 256 threads per row.  Each thread strides over the
// row's columns keeping an online (m, s, u, idx) in f32; threads merge
// with warp shuffles, then through shared memory, using
//     m = max(m1, m2),  s = s1 e^{m1-m} + s2 e^{m2-m}  (u likewise),
//     idx = the lower index when m1 == m2,
// so the result is the FIRST index of the maximum, as the TPU kernel's
// strict `>` across blocks plus jnp.argmax within a block gives.  A thread
// starts at m = -1e30, s = u = 0 (the TPU kernel's _NEG), not at -inf: at
// the main path's V = 2 almost every thread owns no column, and merging
// two -inf maxima would give exp(-inf - -inf) = NaN.
//
// Bound on the H100: the kernel must read B*V*itemsize bytes and write
// 12*B, so its least time is those bytes over HBM bandwidth (3.35 TB/s on
// the SXM part); its arithmetic (an exp and a few FLOPs per element) is
// far below the card's rate.  At the main path's shapes (B <= 128, V = 2)
// that is under a nanosecond, so what bounds it in practice is the launch
// latency of a few microseconds.  Making it fast (several rows per block,
// vectorised 16-byte loads, fusing it into the proxy head's epilogue) is
// later work: this version is the simple, correct one.
//
// Plain C interface, bound from Python with ctypes: each entry point
// launches on the given stream and returns cudaGetLastError() right after
// the launch, so a refused launch is reported where it happened.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

struct Stats {
  float m;
  float s;
  float u;
  int idx;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ Stats merge(const Stats& a, const Stats& b) {
  Stats r;
  r.m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - r.m);
  const float cb = expf(b.m - r.m);
  r.s = a.s * ca + b.s * cb;
  r.u = a.u * ca + b.u * cb;
  r.idx = a.m > b.m ? a.idx : (b.m > a.m ? b.idx : min(a.idx, b.idx));
  return r;
}

__device__ __forceinline__ Stats shfl_down(const Stats& a, int offset) {
  Stats b;
  b.m = __shfl_down_sync(0xffffffffu, a.m, offset);
  b.s = __shfl_down_sync(0xffffffffu, a.s, offset);
  b.u = __shfl_down_sync(0xffffffffu, a.u, offset);
  b.idx = __shfl_down_sync(0xffffffffu, a.idx, offset);
  return b;
}

__device__ __forceinline__ Stats warp_reduce(Stats a) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    a = merge(a, shfl_down(a, offset));
  }
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
entropy_stats_kernel(const T* __restrict__ logits, float* __restrict__ entropy,
                     float* __restrict__ max_prob, int32_t* __restrict__ argmax,
                     int64_t cols) {
  const int64_t row = blockIdx.x;
  const T* x_row = logits + row * cols;

  // per-thread online statistics over columns tid, tid + 256, ...
  Stats t = {kNeg, 0.0f, 0.0f, 0};
  for (int64_t j = threadIdx.x; j < cols; j += kThreads) {
    const float x = to_float(x_row[j]);
    if (x > t.m) {
      const float c = expf(t.m - x);
      t.s = t.s * c + 1.0f;
      t.u = t.u * c + x;
      t.m = x;
      t.idx = static_cast<int>(j);
    } else {
      const float e = expf(x - t.m);
      t.s += e;
      t.u += x * e;
    }
  }

  __shared__ Stats partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  t = warp_reduce(t);
  if (lane == 0) partial[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kWarps ? partial[lane] : Stats{kNeg, 0.0f, 0.0f, 0};
    t = warp_reduce(t);
    if (lane == 0) {
      entropy[row] = t.m + logf(t.s) - t.u / t.s;
      max_prob[row] = 1.0f / t.s;
      argmax[row] = t.idx;
    }
  }
}

template <typename T>
int launch(const void* logits, void* entropy, void* max_prob, void* argmax,
           int64_t rows, int64_t cols, void* stream) {
  entropy_stats_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<float*>(entropy),
      static_cast<float*>(max_prob), static_cast<int32_t*>(argmax), cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int entropy_stats_f32(const void* logits, void* entropy, void* max_prob,
                      void* argmax, int64_t rows, int64_t cols, void* stream) {
  return launch<float>(logits, entropy, max_prob, argmax, rows, cols, stream);
}

int entropy_stats_bf16(const void* logits, void* entropy, void* max_prob,
                       void* argmax, int64_t rows, int64_t cols, void* stream) {
  return launch<__nv_bfloat16>(logits, entropy, max_prob, argmax, rows, cols,
                               stream);
}

const char* entropy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
