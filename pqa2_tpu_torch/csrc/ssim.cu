// ffmpeg's 8x8-window SSIM and the plane SSE in one pass — kernel 4 of
// pqa2_tpu_torch.
//
// Replaces ssim_sse_pallas (pqa2_tpu/ops/pallas_ssim.py, pl.pallas_call at
// :225, body _make_kernel :43): 4x4 block sums of ref, dist, ref^2, dist^2
// and ref*dist, overlapping 8x8 windows as 2x2 block groups on a 4-pixel
// grid, the x264/ffmpeg window formula with depth-scaled c1/c2, and the
// plane's sum of squared differences for PSNR.
//
// What bounds it on Hopper: device-memory reads of the two f32 planes
// (each pixel is read twice: once for its block sum, once for the SSE);
// the arithmetic per window is small. Design: a block covers 32x8 windows;
// its threads first stage the (8+1)x(32+1) block sums in shared memory
// (plain loads replace the TPU's one-hot MXU block-sum dots), then one
// thread evaluates one window, and the block sums the SSE of the pixels it
// owns (every pixel exactly once). Per-block partial sums go to a scratch
// tensor and a second launch adds them per frame in a fixed order: no
// float atomics, so the result is the same on every run. The SSE of
// pixels on the 8-bit scale is exact (f32 squares, float64 sums).
#include "common.cuh"

using namespace pqa2;

namespace {

constexpr int SWX = 32;  // windows per block, x
constexpr int SWY = 8;   // windows per block, y (SWX*SWY == kThreads)

__global__ void __launch_bounds__(kThreads)
ssim_sse_kernel(const float* __restrict__ ref, const float* __restrict__ dist,
                int H, int W, float c1, float c2, double* __restrict__ part_ssim,
                double* __restrict__ part_sse) {
  __shared__ float b1[SWY + 1][SWX + 1];
  __shared__ float b2[SWY + 1][SWX + 1];
  __shared__ float bss[SWY + 1][SWX + 1];
  __shared__ float b12[SWY + 1][SWX + 1];
  const int n = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* r = ref + n * plane;
  const float* d = dist + n * plane;
  const int h4 = H / 4, w4 = W / 4;
  const int nwy = h4 - 1, nwx = w4 - 1;
  const int bx0 = blockIdx.x * SWX, by0 = blockIdx.y * SWY;
  const int tid = threadIdx.x;

  for (int i = tid; i < (SWY + 1) * (SWX + 1); i += kThreads) {
    const int ly = i / (SWX + 1), lx = i - (i / (SWX + 1)) * (SWX + 1);
    const int gby = by0 + ly, gbx = bx0 + lx;
    float s1 = 0.f, s2 = 0.f, srr = 0.f, sdd = 0.f, s12 = 0.f;
    if (gby < h4 && gbx < w4) {
      for (int yy = 0; yy < 4; ++yy) {
        const size_t row = static_cast<size_t>(4 * gby + yy) * W + 4 * gbx;
#pragma unroll
        for (int xx = 0; xx < 4; ++xx) {
          const float x = __ldg(r + row + xx), y = __ldg(d + row + xx);
          s1 = __fadd_rn(s1, x);
          s2 = __fadd_rn(s2, y);
          srr = __fadd_rn(srr, __fmul_rn(x, x));
          sdd = __fadd_rn(sdd, __fmul_rn(y, y));
          s12 = __fadd_rn(s12, __fmul_rn(x, y));
        }
      }
    }
    b1[ly][lx] = s1;
    b2[ly][lx] = s2;
    bss[ly][lx] = __fadd_rn(srr, sdd);
    b12[ly][lx] = s12;
  }
  __syncthreads();

  double win = 0.0;
  const int ty = tid / SWX, tx = tid - (tid / SWX) * SWX;
  if (by0 + ty < nwy && bx0 + tx < nwx) {
    // 2x2 block group, summed left to right as pqa2_tpu/ops/ssim.py:_group.
#define GROUP(a) __fadd_rn(__fadd_rn(__fadd_rn(a[ty][tx], a[ty][tx + 1]), a[ty + 1][tx]), a[ty + 1][tx + 1])
    const float fs1 = GROUP(b1), fs2 = GROUP(b2), fss = GROUP(bss), fs12 = GROUP(b12);
#undef GROUP
    // Trap 2 (FMA contraction): the window formula of
    // pqa2_tpu/ops/ssim.py:63-68 with every operation rounded on its own.
    const float vars = __fsub_rn(__fsub_rn(__fmul_rn(fss, 64.f), __fmul_rn(fs1, fs1)),
                                 __fmul_rn(fs2, fs2));
    const float covar = __fsub_rn(__fmul_rn(fs12, 64.f), __fmul_rn(fs1, fs2));
    const float num = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.f, fs1), fs2), c1),
                                __fadd_rn(__fmul_rn(2.f, covar), c2));
    const float den = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(fs1, fs1), __fmul_rn(fs2, fs2)), c1),
        __fadd_rn(vars, c2));
    win = static_cast<double>(__fdiv_rn(num, den));
  }

  // SSE of the pixels this block owns; the last block of a row/column of
  // blocks also owns the plane's edge past the last whole window.
  const int ry0 = 4 * by0, rx0 = 4 * bx0;
  const int ry1 = blockIdx.y == gridDim.y - 1 ? H : 4 * (by0 + SWY);
  const int rx1 = blockIdx.x == gridDim.x - 1 ? W : 4 * (bx0 + SWX);
  const int cols = rx1 - rx0;
  const int count = (ry1 - ry0) * cols;
  double sse = 0.0;
  for (int i = tid; i < count; i += kThreads) {
    const size_t q = static_cast<size_t>(ry0 + i / cols) * W + rx0 + (i - (i / cols) * cols);
    const float e = __fsub_rn(__ldg(r + q), __ldg(d + q));
    sse += static_cast<double>(__fmul_rn(e, e));
  }
  const double bw = block_sum(win);
  const double be = block_sum(sse);
  if (tid == 0) {
    const size_t slot = static_cast<size_t>(n) * gridDim.x * gridDim.y +
                        blockIdx.y * gridDim.x + blockIdx.x;
    part_ssim[slot] = bw;
    part_sse[slot] = be;
  }
}

// Per frame: fixed-order sum of the block partials.
__global__ void __launch_bounds__(kThreads)
ssim_finish_kernel(const double* __restrict__ part_ssim,
                   const double* __restrict__ part_sse, int nblocks, double nwin,
                   float* __restrict__ ssim, double* __restrict__ sse) {
  const int n = blockIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
    a += part_ssim[static_cast<size_t>(n) * nblocks + i];
    b += part_sse[static_cast<size_t>(n) * nblocks + i];
  }
  a = block_sum(a);
  b = block_sum(b);
  if (threadIdx.x == 0) {
    ssim[n] = static_cast<float>(a / nwin);
    sse[n] = b;
  }
}

}  // namespace

extern "C" {

// ref/dist (n, h, w) f32; part_ssim/part_sse scratch of n * nblocks
// doubles; ssim (n,) f32 and sse (n,) float64 out.
int pqa2_ssim_sse(const float* ref, const float* dist, int n, int h, int w,
                  float c1, float c2, double* part_ssim, double* part_sse,
                  float* ssim, double* sse, cudaStream_t stream) {
  const int nwy = h / 4 - 1, nwx = w / 4 - 1;
  if (nwy < 1 || nwx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nwx + SWX - 1) / SWX, (nwy + SWY - 1) / SWY, n);
  ssim_sse_kernel<<<grid, kThreads, 0, stream>>>(ref, dist, h, w, c1, c2,
                                                 part_ssim, part_sse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_finish_kernel<<<n, kThreads, 0, stream>>>(
      part_ssim, part_sse, static_cast<int>(grid.x * grid.y),
      static_cast<double>(nwx) * nwy, ssim, sse);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
