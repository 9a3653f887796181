// Float motion SAD — kernel 7 of pqa2_tpu_torch.
//
// Replaces motion_sad_pallas (pqa2_tpu/ops/pallas_motion.py, pl.pallas_call
// at :137, body _make_kernel :41): per frame n, the mean over the plane of
// |blur5(f[n]) - blur5(f[n-1])|, the 5-tap Gaussian with reflect borders,
// frame 0 paired with itself (SAD 0), the f32 sum divided by H*W as
// pallas_motion.py:153 does. The float VIF wrapper (ops/cuda_vif.py)
// launches it on the scale-0 call, over every frame of the chunk, halos
// included; the TPU fused the same term into vif_scale_pallas
// (pallas_vif.py:280-295).
//
// What bounds it on Hopper: device-memory reads, two f32 planes per frame
// (frame n and n-1; the second read of each frame mostly hits L2), against
// 2 x 20 f32 operations per pixel for the two blurs, far below the f32 rate.
// Design: one block per 64x16 output tile stages both frames' tiles plus a
// 2-pixel reflect halo in shared memory, runs the column pass into shared
// memory and the row pass in registers (tap order and one rounding per
// operation as ops/filters.py, so the blurred values equal the plain
// version's), and sums |diff| in float64. Per-block partials go to scratch
// and a second launch adds them per frame in a fixed order: no float
// atomics, the same bits on every run.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int HALF = 2;
constexpr int K = 2 * HALF + 1;
constexpr int TW = 64;  // output columns per block
constexpr int TH = 16;  // output rows per block
constexpr int SW = TW + 2 * HALF;
constexpr int SH = TH + 2 * HALF;

__global__ void __launch_bounds__(kThreads)
motion_sad_f32_kernel(const float* __restrict__ frames, int H, int W,
                      const float* __restrict__ taps_g, double* __restrict__ part) {
  __shared__ float s_taps[K];
  __shared__ float s_x[2][SH][SW];
  __shared__ float s_v[2][TH][SW];
  const int n = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  // Frame 0 pairs with itself: its SAD is exactly 0.
  const float* src[2] = {frames + n * plane, frames + (n > 0 ? n - 1 : 0) * plane};
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;

  if (tid < K) s_taps[tid] = taps_g[tid];
  for (int i = tid; i < SH * SW; i += kThreads) {
    const int sy = i / SW, sx = i - (i / SW) * SW;
    const size_t p = static_cast<size_t>(reflect_idx(y0 - HALF + sy, H)) * W +
                     reflect_idx(x0 - HALF + sx, W);
    s_x[0][sy][sx] = __ldg(src[0] + p);
    s_x[1][sy][sx] = __ldg(src[1] + p);
  }
  __syncthreads();

  // Column pass: out = f0*x0, then out + f_t*x_t, one rounding each.
  for (int i = tid; i < TH * SW; i += kThreads) {
    const int ty = i / SW, sx = i - (i / SW) * SW;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      float acc = __fmul_rn(s_taps[0], s_x[f][ty][sx]);
#pragma unroll
      for (int t = 1; t < K; ++t) acc = __fadd_rn(acc, __fmul_rn(s_taps[t], s_x[f][ty + t][sx]));
      s_v[f][ty][sx] = acc;
    }
  }
  __syncthreads();

  double sad[1] = {0.0};
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int ty = i / TW, tx = i - (i / TW) * TW;
    if (y0 + ty >= H || x0 + tx >= W) continue;
    float b[2];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      float acc = __fmul_rn(s_taps[0], s_v[f][ty][tx]);
#pragma unroll
      for (int t = 1; t < K; ++t) acc = __fadd_rn(acc, __fmul_rn(s_taps[t], s_v[f][ty][tx + t]));
      b[f] = acc;
    }
    sad[0] += static_cast<double>(fabsf(__fsub_rn(b[0], b[1])));
  }
  block_partials<1>(sad, part);
}

// sad[n] = f32(sum) / f32(H*W), from the per-frame sums.
__global__ void motion_mean_kernel(float* __restrict__ sad, int n, float hw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) sad[i] = __fdiv_rn(sad[i], hw);
}

}  // namespace

extern "C" {

// Partials per frame for an (h, w) plane (the wrapper sizes its scratch).
int pqa2_motion_f32_blocks(int h, int w) {
  return ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
}

// frames (n, h, w) f32; taps 5 f32; part scratch n * blocks doubles;
// sad (n,) f32 out.
int pqa2_motion_sad_f32(const float* frames, int n, int h, int w, const float* taps,
                        double* part, float* sad, cudaStream_t stream) {
  if (h <= HALF || w <= HALF || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  motion_sad_f32_kernel<<<grid, kThreads, 0, stream>>>(frames, h, w, taps, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_partials_kernel<1><<<n, kThreads, 0, stream>>>(part, static_cast<int>(grid.x * grid.y), sad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  motion_mean_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      sad, n, static_cast<float>(static_cast<double>(h) * w));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
