// Shared helpers of the pqa2_tpu_torch kernels (border indexing, block
// reductions, the fixed-order second pass of the float kernels). Plain C
// interface: each launcher is extern "C", returns cudaGetLastError(),
// launches on the stream it is given, allocates nothing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pqa2 {

typedef unsigned long long u64;
typedef long long i64;

// Threads per block of every kernel (full warps; reductions assume it).
constexpr int kThreads = 256;

// Trap 4 (borders). VIF and motion mirror WITHOUT repeating the edge
// ('reflect', golden/filters.py:reflect_index): -1 -> 1, n -> n-2.
__device__ __forceinline__ int reflect_idx(int j, int n) {
  j = j < 0 ? -j : j;
  if (j >= n) j = 2 * n - j - 2;
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

// ADM mirrors WITH the edge repeated ('symmetric',
// golden/filters.py:symmetric_index): -1 -> 0, n -> n-1.
__device__ __forceinline__ int symmetric_idx(int j, int n) {
  if (j < 0) j = -j - 1;
  if (j >= n) j = 2 * n - j - 1;
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

__device__ __forceinline__ i64 warp_sum(i64 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Trap 6 (no grid order on Hopper): blocks run in no order, so per-frame
// integer statistics are summed with 64-bit integer atomics, which are
// exact in any order. Signed values wrap through the unsigned atomic as
// two's complement, which gives the exact signed sum. Every thread of the
// block must call this (it synchronises).
template <int K>
__device__ void block_atomic_add(i64 (&v)[K], i64* dst) {
  __shared__ i64 red[K][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const i64 s = warp_sum(v[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      i64 s = lane < kThreads / 32 ? red[k][lane] : 0;
      s = warp_sum(s);
      if (lane == 0 && s != 0)
        atomicAdd(reinterpret_cast<u64*>(dst + k), static_cast<u64>(s));
    }
  }
}

// Deterministic block sum of doubles (fixed shuffle/shared pattern); the
// result is valid in thread 0. Every thread must call it.
__device__ inline double block_sum(double v) {
  __shared__ double red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[lane] : 0.0;
    s = warp_sum(s);
  }
  __syncthreads();
  return s;
}

// K per-block double partials of one block -> part[(n * nblocks + b) * K
// + k], written by thread 0. Every thread must call it.
template <int K>
__device__ void block_partials(const double (&v)[K], double* part) {
  const size_t slot = (static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y +
                       static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const double s = block_sum(v[k]);
    if (threadIdx.x == 0) part[slot + k] = s;
  }
}

// The fixed-order second pass of the float kernels: one block per frame
// adds that frame's per-block partials (layout of block_partials) in the
// same order on every run — no float atomics, so two runs give the same
// bits — and rounds each total to f32 once: out[n * K + k]. (A template,
// so each source that launches it gets its own instance; a nested
// anonymous namespace here would clash with the sources' own.)
template <int K>
__global__ void __launch_bounds__(kThreads)
finish_partials_kernel(const double* __restrict__ part, int nblocks,
                       float* __restrict__ out) {
  const int n = blockIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double a = 0.0;
    for (int i = threadIdx.x; i < nblocks; i += kThreads)
      a += part[(static_cast<size_t>(n) * nblocks + i) * K + k];
    a = block_sum(a);
    if (threadIdx.x == 0) out[static_cast<size_t>(n) * K + k] = static_cast<float>(a);
  }
}

}  // namespace pqa2
