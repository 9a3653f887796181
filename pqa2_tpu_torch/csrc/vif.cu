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
// What bounds it on Hopper: f32 issue. Every product and sum is rounded on
// its own in ops/vif.py's order (__fmul_rn/__fadd_rn, and the build passes
// --fmad=false), so the moments and the decimated planes equal the plain
// version's bit for bit; that rules out FMA and any regrouping, so at
// scale 0 a pixel costs 5 moments x 17 taps x 2 passes of a multiply and
// an add (~340 f32 instructions, twice the FMA count the bound assumes),
// plus the statistic (two divisions, two log2) and, with emit_next, a
// quarter of 2 planes x 9 taps x 2 passes. Device memory sees one read of
// each input plane and one write of each decimated plane. Design:
//   * one block per 48x32 output tile stages ref and dist plus the
//     filter's reflect halo in shared memory (one device-memory read of
//     each pixel);
//   * register tiling: in the column pass a thread owns one column and 8
//     output rows, in the row pass one row (a warp's 32 lanes are the
//     tile's 32 rows; row strides are odd, so the lanes hit 32 banks) and 6
//     output columns; each slides a window over values it read once from
//     shared memory, one moment at a time, and x*x, y*y, x*y are rounded
//     once per staged value (the same value every tap used before);
//   * taps are kernel parameters (a constant-bank operand, no shared-memory
//     load), the f32 values the wrapper passes;
//   * the next scale's column pass reads the same staged tile at its even
//     rows, its row pass the even columns.
// num and den are summed in float64 to per-block partials and a second
// launch adds them per frame in a fixed order: no float atomics, the same
// bits every run.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

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

constexpr int TH = 32;      // output rows per block (even: decimation keeps parity)
constexpr int RC = 6;       // output columns per thread in the row pass
constexpr int TW = 8 * RC;  // output columns per block: 8 warps x RC
constexpr int RV = 8;       // output rows per thread in the column passes

static_assert(TH == 32 && TH % RV == 0, "tile shape");

// f32 taps by value: this scale's, then the next scale's.
struct Taps {
  float f[17];
  float fn[9];
};

// Shared-memory layout of one scale's tile, in floats.
template <int HALF>
struct Tile {
  static constexpr int HN = HALF / 2;           // next scale's half-width
  static constexpr int SH = TH + 2 * HALF, SW = TW + 2 * HALF;
  static constexpr int VS = SW | 1;              // column-sum row stride: odd
  static constexpr int DW = TW + 2 * HN;         // decimation column-pass width
  static constexpr int oY = SH * SW;
  static constexpr int oV = 2 * SH * SW;         // column-sum planes
  static constexpr int oD = oV + 5 * TH * VS;    // 2 decimation planes
  static constexpr size_t kBytes = sizeof(float) * (oD + 2 * (TH / 2) * DW);
};

// taps[0]*v[o] + taps[1]*v[o+1] + ... over K = 2*H+1 taps, in that order,
// each product and sum rounded on its own (ops/filters.py:_filter_axis).
template <int H, int N>
__device__ __forceinline__ float win(const float* f, const float (&v)[N], int o) {
  float a = fmul(f[0], v[o]);
#pragma unroll
  for (int t = 1; t <= 2 * H; ++t) a = fadd(a, fmul(f[t], v[o + t]));
  return a;
}

// Column pass of the five moments (0 mu1, 1 mu2, 2 xx, 3 yy, 4 xy) for
// column item i (a column and RV rows) into v[m]. The squares and the
// product are rounded before filtering, as ref * ref is in
// ops/vif.py:_moments.
template <int HALF>
__device__ __forceinline__ void column_moments(const float* sx, const float* sy, float* v,
                                               int i, const float* f) {
  constexpr int SW = Tile<HALF>::SW, VS = Tile<HALF>::VS, N = RV + 2 * HALF;
  const int c = i % SW, r0 = (i / SW) * RV;
  float x[N], y[N], q[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = sx[(r0 + j) * SW + c];
    y[j] = sy[(r0 + j) * SW + c];
  }
#pragma unroll
  for (int m = 0; m < 5; ++m) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      q[j] = m == 0 ? x[j] : m == 1 ? y[j] : m == 2 ? fmul(x[j], x[j])
             : m == 3 ? fmul(y[j], y[j]) : fmul(x[j], y[j]);
#pragma unroll
    for (int r = 0; r < RV; ++r) v[m * TH * VS + (r0 + r) * VS + c] = win<HALF>(f, q, r);
  }
}

// Row pass of the five moments from v for this thread's row (its lane) and
// RC columns (its warp) into mom.
template <int HALF>
__device__ __forceinline__ void row_moments(const float* v, const float* f,
                                            float (&mom)[5][RC]) {
  constexpr int VS = Tile<HALF>::VS, N = RC + 2 * HALF;
  const int row = threadIdx.x & 31, c0 = (threadIdx.x >> 5) * RC;
  float q[N];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = v[m * TH * VS + row * VS + c0 + j];
#pragma unroll
    for (int c = 0; c < RC; ++c) mom[m][c] = win<HALF>(f, q, c);
  }
}

// HALF: this scale's filter half-width; emit_next needs HALF >= 2.
template <int HALF>
__global__ void __launch_bounds__(kThreads, 2)
vif_scale_f32_kernel(const float* __restrict__ ref, const float* __restrict__ dist,
                     int H, int W, const __grid_constant__ Taps taps,
                     const __grid_constant__ VifParams p,
                     double* __restrict__ part, float* __restrict__ next_ref,
                     float* __restrict__ next_dist) {
  using T = Tile<HALF>;
  constexpr int HN = T::HN, SH = T::SH, SW = T::SW, DW = T::DW;
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;
  float* sy = smem + T::oY;
  float* v = smem + T::oV;
  float* dv = smem + T::oD;

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* r = ref + n * plane;
  const float* d = dist + n * plane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dec = HN > 0 && next_ref != nullptr;

  for (int yy = warp; yy < SH; yy += kThreads / 32) {
    const size_t row = static_cast<size_t>(reflect_idx(y0 - HALF + yy, H)) * W;
    for (int xx = lane; xx < SW; xx += 32) {
      const size_t q = row + reflect_idx(x0 - HALF + xx, W);
      sx[yy * SW + xx] = __ldg(r + q);
      sy[yy * SW + xx] = __ldg(d + q);
    }
  }
  __syncthreads();

  // Column passes: the moments (SW columns x TH/RV strips of RV rows),
  // then the next scale's at the even rows (2 planes x DW columns).
  constexpr int NM = SW * (TH / RV);
  const int total = NM + (dec ? 2 * DW : 0);
  for (int i = tid; i < total; i += kThreads) {
    if (i < NM) {
      column_moments<HALF>(sx, sy, v, i, taps.f);
    } else if constexpr (HALF >= 2) {
      // Staged columns HALF-HN .. HALF+TW+HN, rows 2a + HALF-HN + t.
      const int j = i - NM, pl = j / DW, c = j - (j / DW) * DW;
      constexpr int N = TH - 1 + 2 * HN;
      const float* col = (pl ? sy : sx) + (HALF - HN) * SW + (HALF - HN + c);
      float q[N];
#pragma unroll
      for (int k = 0; k < N; ++k) q[k] = col[k * SW];
#pragma unroll
      for (int a = 0; a < TH / 2; ++a)
        dv[pl * (TH / 2) * DW + a * DW + c] = win<HN>(taps.fn, q, 2 * a);
    }
  }
  __syncthreads();

  // Row pass (lane = tile row, warp = a strip of RC columns), statistic,
  // per-pixel sums.
  float mom[5][RC];
  row_moments<HALF>(v, taps.f, mom);
  double acc[2] = {0.0, 0.0};
  {
    const int row = lane, c0 = warp * RC;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (y0 + row >= H || x0 + c0 + c >= W) continue;
      float num, den;
      vif_stat(mom[0][c], mom[1][c], mom[2][c], mom[3][c], mom[4][c], p, &num, &den);
      acc[0] += static_cast<double>(num);
      acc[1] += static_cast<double>(den);
    }
  }

  // The next scale's row pass at the even columns 2b, one output per item.
  if constexpr (HALF >= 2) {
    if (dec) {
      constexpr int KN = 2 * HN + 1;
      const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
      for (int i = tid; i < 2 * (TH / 2) * (TW / 2); i += kThreads) {
        const int pl = i / ((TH / 2) * (TW / 2)), qi = i - pl * ((TH / 2) * (TW / 2));
        const int a = qi / (TW / 2), b = qi - (qi / (TW / 2)) * (TW / 2);
        const int gy = y0 / 2 + a, gx = x0 / 2 + b;
        if (gy >= H2 || gx >= W2) continue;
        float q[KN];
#pragma unroll
        for (int t = 0; t < KN; ++t) q[t] = dv[pl * (TH / 2) * DW + a * DW + 2 * b + t];
        float* out = pl ? next_dist : next_ref;
        out[static_cast<size_t>(n) * H2 * W2 + static_cast<size_t>(gy) * W2 + gx] =
            win<HN>(taps.fn, q, 0);
      }
    }
  }
  block_partials<2>(acc, part);
}

template <int HALF>
int launch(const float* ref, const float* dist, int n, int h, int w, const Taps& taps,
           const VifParams& p, double* part, float* sums, float* next_ref,
           float* next_dist, cudaStream_t stream) {
  auto kern = vif_scale_f32_kernel<HALF>;
  constexpr size_t bytes = Tile<HALF>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  kern<<<grid, kThreads, bytes, stream>>>(ref, dist, h, w, taps, p, part, next_ref, next_dist);
  err = cudaGetLastError();
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

// One float VIF scale. ref/dist (n, h, w) f32; taps (host memory): this
// scale's 2*half+1 f32 taps followed, with emit_next, by the next scale's
// 2*(half/2)+1; part scratch n * blocks * 2 doubles; sums (n, 2) f32 out
// {num, den}; next_ref/next_dist (n, ceil(h/2), ceil(w/2)) f32 out when
// emit_next.
int pqa2_vif_scale_f32(const float* ref, const float* dist, int n, int h, int w,
                       int half, int emit_next, const float* taps, int classic,
                       int has_gain, float gain, float eps, float nsq, float max_inv,
                       double* part, float* sums, float* next_ref, float* next_dist,
                       cudaStream_t stream) {
  if (h <= half || w <= half || n < 1 || (emit_next && half < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const VifParams p = {eps, nsq, max_inv, gain, has_gain, classic};
  Taps t = {};
  const int k = 2 * half + 1;
  for (int i = 0; i < k; ++i) t.f[i] = taps[i];
  for (int i = 0; emit_next && i < 2 * (half / 2) + 1; ++i) t.fn[i] = taps[k + i];
  float* nr = emit_next ? next_ref : nullptr;
  float* nd = emit_next ? next_dist : nullptr;
  switch (half) {
    case 8: return launch<8>(ref, dist, n, h, w, t, p, part, sums, nr, nd, stream);
    case 4: return launch<4>(ref, dist, n, h, w, t, p, part, sums, nr, nd, stream);
    case 2: return launch<2>(ref, dist, n, h, w, t, p, part, sums, nr, nd, stream);
    case 1: return launch<1>(ref, dist, n, h, w, t, p, part, sums, nr, nd, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
