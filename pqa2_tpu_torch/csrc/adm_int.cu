// One integer ADM level — kernel 3 of pqa2_tpu_torch.
//
// Replaces adm_int_level_pallas (pqa2_tpu/ops/pallas_adm_int.py,
// pl.pallas_call at :381, body _make_int_kernel :60): the Q15 db2 DWT of
// ref and dist, integer decoupling with the f32 angle test, the IRF CSF,
// the 3x3 trunc(S/30) masking threshold, cube-sum pooling over the 10 %
// trimmed core, and the next level's approximation bands.
//
// What bounds it on Hopper: device-memory traffic of the bands (the DWT
// writes four int32 bands per plane and the pooling pass reads six) and
// the integer divide of the decoupling (one 64-bit divide per band and
// pixel, about twice per pixel counting the halo). Design, two launches
// per level: (a) one thread per band pixel computes a/h/v/d of one plane
// straight from the approximation plane with the symmetric ``2i-1+f``
// indexing (golden/adm_int.py:61-84) — no host polyphase split, the
// 16-value input window comes through L1; (b) one block per 32x8 core
// tile decouples the tile plus a one-band symmetric halo into shared
// memory (only the per-pixel |icsf(additive)| sum the threshold needs),
// then each thread thresholds and pools its pixel. The six sums per frame
// are int64 (adm_cube_shift keeps them below 2^63) and are summed with
// integer atomics, so block order does not matter. No digit columns, no
// int16 band stores and no byte-split accumulators: int64 has the room.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int PW = 32;  // core pixels per pooling tile, x
constexpr int PH = 8;   // core pixels per pooling tile, y (PW*PH == kThreads)

// (a) One band pixel (i, j) of one plane: rows first (with the extra row
// shift), then columns; taps = {lo[0..3], hi[0..3]} in Q15.
__global__ void __launch_bounds__(kThreads)
adm_dwt_kernel(const int* __restrict__ src, int H, int W, int extra,
               const int* __restrict__ taps_g, int* __restrict__ a,
               int* __restrict__ hb, int* __restrict__ vb, int* __restrict__ db) {
  __shared__ i64 f[8];
  if (threadIdx.x < 8) f[threadIdx.x] = taps_g[threadIdx.x];
  __syncthreads();
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= H2 * W2) return;
  const int n = blockIdx.y;
  const int i = idx / W2, j = idx - (idx / W2) * W2;
  const int* s = src + static_cast<size_t>(n) * H * W;
  int rows[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) rows[t] = symmetric_idx(2 * i - 1 + t, H);
  const int rs = 15 + extra;
  const i64 rr = 1ll << (rs - 1);
  i64 lo[4], hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = symmetric_idx(2 * j - 1 + c, W);
    i64 la = 0, ha = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const i64 x = __ldg(s + static_cast<size_t>(rows[t]) * W + col);
      la += f[t] * x;
      ha += f[4 + t] * x;
    }
    // Trap 5 (signed arithmetic): bands are negative; >> on a signed
    // integer is an arithmetic shift in nvcc, i.e. it floors, as numpy's
    // int64 >> does in the oracle.
    lo[c] = (la + rr) >> rs;
    hi[c] = (ha + rr) >> rs;
  }
  i64 aa = 0, vv = 0, hh = 0, dd = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    aa += f[c] * lo[c];
    vv += f[4 + c] * lo[c];
    hh += f[c] * hi[c];
    dd += f[4 + c] * hi[c];
  }
  const size_t o = static_cast<size_t>(n) * H2 * W2 + idx;
  a[o] = static_cast<int>((aa + 16384) >> 15);
  vb[o] = static_cast<int>((vv + 16384) >> 15);
  hb[o] = static_cast<int>((hh + 16384) >> 15);
  db[o] = static_cast<int>((dd + 16384) >> 15);
}

struct LevelParams {
  int irf[3];
  float gain;
  int gain_one;
  float cos_sq;
};

// Integer decoupling of one pixel (golden/adm_int.py:119-150) -> rst.
__device__ __forceinline__ void decouple(const int (&o)[3], const int (&t)[3],
                                         const LevelParams& p, i64 (&rst)[3]) {
  const float oh = static_cast<float>(o[0]), ov = static_cast<float>(o[1]);
  const float th = static_cast<float>(t[0]), tv = static_cast<float>(t[1]);
  // Trap 2 (FMA contraction): the oracle's f32 angle test with every
  // product and sum rounded on its own (golden/adm_int.py:160-166).
  const float ot_dp = __fadd_rn(__fmul_rn(oh, th), __fmul_rn(ov, tv));
  const float o_mag = __fadd_rn(__fmul_rn(oh, oh), __fmul_rn(ov, ov));
  const float t_mag = __fadd_rn(__fmul_rn(th, th), __fmul_rn(tv, tv));
  const bool angle = ot_dp >= 0.0f &&
      __fmul_rn(ot_dp, ot_dp) >= __fmul_rn(__fmul_rn(p.cos_sq, o_mag), t_mag);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const i64 ob = o[b], tb = t[b];
    const i64 oa = ob < 0 ? -ob : ob, ta = tb < 0 ? -tb : tb;
    // Trap 5: k = min((|t| << 15) / |o|, 32768) only where the signs agree
    // and t != 0; restoration sign(o) * ((k*|o| + 2^14) >> 15).
    i64 k = 0;
    if (oa > 0 && ((ob > 0) == (tb > 0)) && tb != 0) {
      k = (ta << 15) / oa;
      k = k > 32768 ? 32768 : k;
    }
    const i64 mag = (k * oa + 16384) >> 15;
    i64 r = ob > 0 ? mag : (ob < 0 ? -mag : 0);
    if (angle) {
      // rint(f32(r) * f32(gain)), one f32 rounding then round-half-even.
      const i64 g = p.gain_one ? r
          : static_cast<i64>(rintf(__fmul_rn(static_cast<float>(r), p.gain)));
      r = tb > 0 ? (g < tb ? g : tb) : (tb < 0 ? (g > tb ? g : tb) : tb);
    }
    rst[b] = r;
  }
}

__device__ __forceinline__ i64 icsf(i64 band, int irf) {
  return (band * irf + 4096) >> 13;  // arithmetic shift (trap 5)
}

__device__ __forceinline__ i64 iabs(i64 v) { return v < 0 ? -v : v; }

// (b) Decoupling, CSF, masking and pooling of one 32x8 core tile. sums
// (n, 3, 2) int64: bands h/v/d x {masked restoration, |icsf(ref)|}.
__global__ void __launch_bounds__(kThreads)
adm_pool_kernel(const int* __restrict__ oh, const int* __restrict__ ov,
                const int* __restrict__ od, const int* __restrict__ th,
                const int* __restrict__ tv, const int* __restrict__ td,
                int H2, int W2, int trim_h, int trim_w, LevelParams p,
                int dshift, i64* __restrict__ sums) {
  __shared__ int s_a[PH + 2][PW + 2];
  const int n = blockIdx.z;
  const size_t off = static_cast<size_t>(n) * H2 * W2;
  const int y0 = trim_h + blockIdx.y * PH, x0 = trim_w + blockIdx.x * PW;
  const int y_end = H2 - trim_h, x_end = W2 - trim_w;

  // Threshold input over the tile plus a symmetric one-band halo
  // (golden/adm_int.py:204-220): A = sum over bands of |icsf(additive)|.
  for (int i = threadIdx.x; i < (PH + 2) * (PW + 2); i += kThreads) {
    const int sy = i / (PW + 2), sx = i - (i / (PW + 2)) * (PW + 2);
    const size_t q = off + static_cast<size_t>(symmetric_idx(y0 - 1 + sy, H2)) * W2 +
                     symmetric_idx(x0 - 1 + sx, W2);
    const int o[3] = {__ldg(oh + q), __ldg(ov + q), __ldg(od + q)};
    const int t[3] = {__ldg(th + q), __ldg(tv + q), __ldg(td + q)};
    i64 rst[3];
    decouple(o, t, p, rst);
    i64 A = 0;
#pragma unroll
    for (int b = 0; b < 3; ++b) A += iabs(icsf(t[b] - rst[b], p.irf[b]));
    s_a[sy][sx] = static_cast<int>(A);
  }
  __syncthreads();

  i64 acc[6] = {0, 0, 0, 0, 0, 0};
  const int ty = threadIdx.x / PW, tx = threadIdx.x - (threadIdx.x / PW) * PW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < y_end && gx < x_end) {
    i64 S = s_a[ty + 1][tx + 1];  // centre counted twice
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) S += s_a[ty + dy][tx + dx];
    const i64 thr = S / 30;  // S >= 0: truncation == floor
    const size_t q = off + static_cast<size_t>(gy) * W2 + gx;
    const int o[3] = {__ldg(oh + q), __ldg(ov + q), __ldg(od + q)};
    const int t[3] = {__ldg(th + q), __ldg(tv + q), __ldg(td + q)};
    i64 rst[3];
    decouple(o, t, p, rst);
    const i64 rnd = 1ll << (dshift - 1);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      i64 m = iabs(icsf(rst[b], p.irf[b])) - thr;
      m = m > 0 ? m : 0;
      i64 v = (m + rnd) >> dshift;
      acc[2 * b] += v * v * v;
      v = (iabs(icsf(o[b], p.irf[b])) + rnd) >> dshift;
      acc[2 * b + 1] += v * v * v;
    }
  }
  block_atomic_add<6>(acc, sums + static_cast<size_t>(n) * 6);
}

}  // namespace

extern "C" {

// a/h/v/d: (n, ceil(h/2), ceil(w/2)) int32 each.
int pqa2_adm_dwt(const int* src, int n, int h, int w, int extra, const int* taps,
                 int* a, int* hb, int* vb, int* db, cudaStream_t stream) {
  const int bands = ((h + 1) / 2) * ((w + 1) / 2);
  const dim3 grid((bands + kThreads - 1) / kThreads, n);
  adm_dwt_kernel<<<grid, kThreads, 0, stream>>>(src, h, w, extra, taps, a, hb, vb, db);
  return static_cast<int>(cudaGetLastError());
}

// sums (n, 3, 2) int64, zeroed by the caller.
int pqa2_adm_pool(const int* oh, const int* ov, const int* od, const int* th,
                  const int* tv, const int* td, int n, int h2, int w2,
                  int trim_h, int trim_w, int irf_h, int irf_v, int irf_d,
                  float gain, int gain_one, float cos_sq, int dshift,
                  long long* sums, cudaStream_t stream) {
  const int ch = h2 - 2 * trim_h, cw = w2 - 2 * trim_w;
  if (ch <= 0 || cw <= 0 || dshift < 1) return static_cast<int>(cudaErrorInvalidValue);
  LevelParams p;
  p.irf[0] = irf_h;
  p.irf[1] = irf_v;
  p.irf[2] = irf_d;
  p.gain = gain;
  p.gain_one = gain_one;
  p.cos_sq = cos_sq;
  const dim3 grid((cw + PW - 1) / PW, (ch + PH - 1) / PH, n);
  adm_pool_kernel<<<grid, kThreads, 0, stream>>>(oh, ov, od, th, tv, td, h2, w2,
                                                 trim_h, trim_w, p, dshift, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
