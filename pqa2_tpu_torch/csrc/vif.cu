// Float VIF scale pass — kernel 5 of pqa2_tpu_torch.
//
// Replaces vif_scale_pallas (pqa2_tpu/ops/pallas_vif.py, pl.pallas_call at
// :404, body _make_kernel :92): for one scale, the five Gaussian moments
// (mu1, mu2, E[x^2], E[y^2], E[xy]; column pass, then row pass, reflect
// borders), the per-pixel statistic — 'default' or 'classic'
// (pallas_vif.py:51-89), with the optional NEG gain limit — summed per
// frame into num and den, and with emit_next the next scale's input: the
// tile blurred with the next scale's taps at the even rows and columns
// only, written as (ceil(H/2), ceil(W/2)) planes. The TPU kernel's fused
// motion term is kernel 7 (csrc/motion.cu), launched by the same wrapper.
//
// What bounds it on Hopper: f32 arithmetic. At scale 0 a pixel costs
// 5 moments x 17 taps x 2 passes of a multiply and an add (~340 f32
// operations), plus the statistic (two divisions, two log2) and, with
// emit_next, a quarter of 2 planes x 9 taps x 2 passes; device memory
// sees one read of each input plane and one write of each decimated
// plane. Design: one block per 64x16 output tile stages ref and dist plus
// the filter's reflect halo in shared memory (one device-memory read of
// each pixel), runs the column pass of all five moments into shared
// memory, then the row pass, the statistic and the per-pixel sums in
// registers; the next scale's column pass reuses the staged tile. Every
// product and sum is rounded on its own in ops/vif.py's order (__fmul_rn/
// __fadd_rn, and the build passes --fmad=false), so the moments and the
// decimated planes equal the plain version's bit for bit. num and den are
// summed in float64 to per-block partials and a second launch adds them
// per frame in a fixed order: no float atomics, the same bits every run.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int TW = 64;  // output columns per block
constexpr int TH = 16;  // output rows per block (even: decimation keeps parity)

struct VifParams {
  float eps, nsq, max_inv, gain;
  int has_gain;  // 0: gain limit infinite, no clamp (pallas_vif.py:61)
  int classic;   // 1: classic statistic, 0: default
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(x, min=lo) / clamp(x, max=hi): NaN stays NaN.
__device__ __forceinline__ float at_least(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float at_most(float x, float hi) { return x > hi ? hi : x; }

// One pixel of the statistic (ops/vif.py:_statistic_default/_classic).
__device__ __forceinline__ void vif_stat(float mu1, float mu2, float xx, float yy,
                                         float xy, const VifParams& p, float* num,
                                         float* den) {
  float s1 = fsub(xx, fmul(mu1, mu1));
  float s2 = fsub(yy, fmul(mu2, mu2));
  const float s12 = fsub(xy, fmul(mu1, mu2));
  if (!p.classic) {
    s1 = at_least(s1, 0.f);
    s2 = at_least(s2, 0.f);
    float g = s12 > 0.f ? fdiv(s12, at_least(s1, p.eps)) : 0.f;
    const float sv = at_least(fsub(s2, fmul(g, s12)), 0.f);  // NEG clamp after sv
    if (p.has_gain) g = at_most(g, p.gain);
    if (s1 >= p.nsq) {
      *num = log2f(fadd(1.f, fdiv(fmul(fmul(g, g), s1), fadd(sv, p.nsq))));
      *den = log2f(fadd(1.f, fdiv(s1, p.nsq)));
    } else {
      *num = fsub(1.f, fmul(s2, p.max_inv));
      *den = 1.f;
    }
    return;
  }
  float g = fdiv(s12, fadd(s1, p.eps));
  float sv = fsub(s2, fmul(g, s12));
  if (s1 < p.eps) {
    g = 0.f;
    sv = s2;
    s1 = 0.f;
  }
  if (s2 < p.eps) {
    g = 0.f;
    sv = 0.f;
  }
  if (g < 0.f) {
    sv = s2;
    g = 0.f;
  }
  sv = at_least(sv, p.eps);
  if (p.has_gain) g = at_most(g, p.gain);
  *num = log2f(fadd(1.f, fdiv(fmul(fmul(g, g), s1), fadd(sv, p.nsq))));
  *den = log2f(fadd(1.f, fdiv(s1, p.nsq)));
}

// HALF: this scale's filter half-width; HN: the next scale's (0: no
// emit_next). taps_g = this scale's 2*HALF+1 taps, then the next scale's.
template <int HALF, int HN>
__global__ void __launch_bounds__(kThreads)
vif_scale_f32_kernel(const float* __restrict__ ref, const float* __restrict__ dist,
                     int H, int W, const float* __restrict__ taps_g, VifParams p,
                     double* __restrict__ part, float* __restrict__ next_ref,
                     float* __restrict__ next_dist) {
  constexpr int K = 2 * HALF + 1;
  constexpr int KN = 2 * HN + 1;
  constexpr int SW = TW + 2 * HALF;
  constexpr int SH = TH + 2 * HALF;
  __shared__ float s_taps[K + KN];
  __shared__ float s_r[SH][SW];
  __shared__ float s_d[SH][SW];
  __shared__ float v[5][TH][SW];  // column pass of mu1, mu2, xx, yy, xy

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* r = ref + n * plane;
  const float* d = dist + n * plane;
  const int tid = threadIdx.x;

  if (tid < K + (HN ? KN : 0)) s_taps[tid] = taps_g[tid];
  for (int i = tid; i < SH * SW; i += kThreads) {
    const int sy = i / SW, sx = i - (i / SW) * SW;
    const size_t q = static_cast<size_t>(reflect_idx(y0 - HALF + sy, H)) * W +
                     reflect_idx(x0 - HALF + sx, W);
    s_r[sy][sx] = __ldg(r + q);
    s_d[sy][sx] = __ldg(d + q);
  }
  __syncthreads();

  // Column pass of the five moments; the squares and the product are
  // rounded before filtering, as ref * ref is in ops/vif.py:_moments.
  for (int i = tid; i < TH * SW; i += kThreads) {
    const int ty = i / SW, sx = i - (i / SW) * SW;
    float a[5];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float f = s_taps[t], x = s_r[ty + t][sx], y = s_d[ty + t][sx];
      const float term[5] = {fmul(f, x), fmul(f, y), fmul(f, fmul(x, x)),
                             fmul(f, fmul(y, y)), fmul(f, fmul(x, y))};
#pragma unroll
      for (int m = 0; m < 5; ++m) a[m] = t == 0 ? term[m] : fadd(a[m], term[m]);
    }
#pragma unroll
    for (int m = 0; m < 5; ++m) v[m][ty][sx] = a[m];
  }
  __syncthreads();

  // Row pass, statistic, per-pixel sums.
  double acc[2] = {0.0, 0.0};
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int ty = i / TW, tx = i - (i / TW) * TW;
    if (y0 + ty >= H || x0 + tx >= W) continue;
    float mom[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      float s = fmul(s_taps[0], v[m][ty][tx]);
#pragma unroll
      for (int t = 1; t < K; ++t) s = fadd(s, fmul(s_taps[t], v[m][ty][tx + t]));
      mom[m] = s;
    }
    float num, den;
    vif_stat(mom[0], mom[1], mom[2], mom[3], mom[4], p, &num, &den);
    acc[0] += static_cast<double>(num);
    acc[1] += static_cast<double>(den);
  }
  block_partials<2>(acc, part);

  if (HN) {
    // Next scale's input at the even rows/columns of this tile: column
    // pass at rows 2a for every column the row pass reads (staged columns
    // HALF-HN .. HALF+TW+HN), into v[0]/v[1] (free after the row pass;
    // block_partials ends on a barrier), then the row pass at columns 2b.
    constexpr int NW = TW + 2 * HN;
    const float* fn = s_taps + K;
    for (int i = tid; i < (TH / 2) * NW; i += kThreads) {
      const int a = i / NW, c = i - (i / NW) * NW;
      const int sx = HALF - HN + c;
      const int sy = 2 * a + HALF - HN;
      float vr = fmul(fn[0], s_r[sy][sx]);
      float vd = fmul(fn[0], s_d[sy][sx]);
#pragma unroll
      for (int t = 1; t < KN; ++t) {
        vr = fadd(vr, fmul(fn[t], s_r[sy + t][sx]));
        vd = fadd(vd, fmul(fn[t], s_d[sy + t][sx]));
      }
      v[0][a][c] = vr;
      v[1][a][c] = vd;
    }
    __syncthreads();
    const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
    for (int i = tid; i < (TH / 2) * (TW / 2); i += kThreads) {
      const int a = i / (TW / 2), b = i - (i / (TW / 2)) * (TW / 2);
      const int gy = y0 / 2 + a, gx = x0 / 2 + b;
      if (gy >= H2 || gx >= W2) continue;
      float orr = fmul(fn[0], v[0][a][2 * b]);
      float odd = fmul(fn[0], v[1][a][2 * b]);
#pragma unroll
      for (int t = 1; t < KN; ++t) {
        orr = fadd(orr, fmul(fn[t], v[0][a][2 * b + t]));
        odd = fadd(odd, fmul(fn[t], v[1][a][2 * b + t]));
      }
      const size_t o = static_cast<size_t>(n) * H2 * W2 + static_cast<size_t>(gy) * W2 + gx;
      next_ref[o] = orr;
      next_dist[o] = odd;
    }
  }
}

template <int HALF, int HN>
int launch(const float* ref, const float* dist, int n, int h, int w, const float* taps,
           const VifParams& p, double* part, float* sums, float* next_ref,
           float* next_dist, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  vif_scale_f32_kernel<HALF, HN><<<grid, kThreads, 0, stream>>>(
      ref, dist, h, w, taps, p, part, next_ref, next_dist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_partials_kernel<2><<<n, kThreads, 0, stream>>>(
      part, static_cast<int>(grid.x * grid.y), sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Partials per frame for an (h, w) plane (the wrapper sizes its scratch).
int pqa2_vif_f32_blocks(int h, int w) {
  return ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
}

// One float VIF scale. ref/dist (n, h, w) f32; taps: this scale's
// 2*half+1 taps followed, with emit_next, by the next scale's 2*(half/2)+1;
// part scratch n * blocks * 2 doubles; sums (n, 2) f32 out {num, den};
// next_ref/next_dist (n, ceil(h/2), ceil(w/2)) f32 out when emit_next.
int pqa2_vif_scale_f32(const float* ref, const float* dist, int n, int h, int w,
                       int half, int emit_next, const float* taps, int classic,
                       int has_gain, float gain, float eps, float nsq, float max_inv,
                       double* part, float* sums, float* next_ref, float* next_dist,
                       cudaStream_t stream) {
  if (h <= half || w <= half || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const VifParams p = {eps, nsq, max_inv, gain, has_gain, classic};
  const int key = half * 2 + (emit_next ? 1 : 0);
  switch (key) {
    case 17: return launch<8, 4>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 16: return launch<8, 0>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 9: return launch<4, 2>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 8: return launch<4, 0>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 5: return launch<2, 1>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 4: return launch<2, 0>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    case 2: return launch<1, 0>(ref, dist, n, h, w, taps, p, part, sums, next_ref, next_dist, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
