// Integer fixed-point VIF scale pass with the next scale's decimation and
// the motion blur fused in, the motion SAD, and the Q11 log2 table audit —
// kernels 1, 1f and 2 of pqa2_tpu_torch.
//
// Replaces (pqa2_tpu/ops/pallas_vif_int.py):
//   * vif_int_scale_pallas (pl.pallas_call at :1021, body _make_int_kernel
//     :486): one VIF scale's Q16 moments, sigma planes and the exact
//     Q11-LUT statistic summed per frame; the next scale's 2x-decimated Q8
//     planes (next_taps, :488); at scale 0 the 5-tap motion blur of the
//     reference and the integer SAD of consecutive blurred frames
//     (with_motion, :507, :530);
//   * the same kernel's fast body (exact_fused=False, emit_sigma=False;
//     statistic _statistic_int :467-483, precision="integer_fast"): the
//     same planes, then the smooth f32-log statistic, summed per frame as
//     {num, den} (FAST = true below: kernel 1f);
//   * log2_direct_exceptions (pl.pallas_call at :152): the exhaustive audit
//     of the log2 used by the statistic against golden/log2lut.py.
//
// What bounds it on Hopper: integer issue. At scale 0 a pixel costs five
// 17-tap sums in each of two passes (~170 multiply-adds), the mean
// products and the statistic (one f64 divide, four f64 multiplies and
// three table reads on the log branch); device memory sees one read of
// each input plane and one write of each output plane. Design:
//   * one block per 48x32 output tile stages ref and dist plus the
//     filter's reflect halo in shared memory as uint16 (one device-memory
//     read of each pixel; 8-bit sources are read as their bytes);
//   * register tiling: in the column pass a thread owns one column and 8
//     output rows, in the row pass one row (a warp's 32 lanes are the
//     tile's 32 rows, row strides are odd in 32-bit words, so the lanes hit
//     32 banks) and 6 output columns; each slides a window over its values,
//     one plane at a time. The column pass reads its staged values again
//     for each plane rather than holding them: that keeps the 8-bit
//     instantiations in 64 registers, 4 blocks (32 warps) per SM, to hide
//     the statistic's f64 and table latencies (holding them took 127
//     registers, 2 blocks per SM, and ran slower on the H100);
//   * taps are kernel parameters (a constant-bank operand of IMAD, no
//     shared-memory load) and symmetric, so a tap pair costs one add and
//     one multiply-add: t and K-1-t share a tap, and integer sums are exact
//     in any grouping;
//   * arithmetic no wider than the values: with 8-bit codes (in_q == 0)
//     every tap sum stays below 2^32 (vertical <= 65536*255^2 + 2^15,
//     horizontal <= 65536*65280), so the filters run in uint32 and only the
//     three mean products widen to 64 bits; with wider codes (< 2^16) x*x
//     still fits uint32 and f*x^2 is one 32x32->64 multiply-add per tap;
//     no 64x64 product is left in the filters;
//   * the same staged tile feeds the next scale's blur at its even rows and
//     columns (its window lies inside the halo), and at scale 0 the motion
//     blur of the core frames; a small staged launch blurs the chunk's halo
//     frames, and one reduction sums |diff| of consecutive blurred frames
//     (uint16 planes, exact int64 atomics);
//   * the seven per-frame accumulators are reduced per block before one
//     integer atomic each. Hopper has int64, uint64 and f64 natively, so
//     none of the TPU's uint32 splitting, long division, double-f32 log
//     engines or the 2^24-px envelope is needed: the table is read (__ldg,
//     L1-resident 128 KB);
//   * kernel 1f shares everything above but the statistic: per pixel a few
//     f32 operations and two log2f (no table read, no 64-bit division, no
//     int64 accumulator), summed in float64 per thread, per block in a
//     fixed shuffle order, and across blocks by the fixed-order second pass
//     (common.cuh:finish_partials_kernel), so a run gives the same bits
//     every time;
//   * the audit (kernel 2) compares each lookup with the expected value on
//     the card and adds each block's mismatch count with one integer
//     atomic, so one int32 comes back; the wrapper caches a passed audit
//     per device.
#include "common.cuh"

#include <math.h>

#include <type_traits>

using namespace pqa2;

namespace {

typedef unsigned short u16;

constexpr int TH = 32;        // output rows per block: the 32 lanes of a warp in the row pass
constexpr int TW = 48;        // output columns per block: 8 warps x RC
constexpr int RV = 8;         // output rows per thread in the column passes
constexpr int RC = TW / 8;    // output columns per thread in the row pass
constexpr int MHALF = 2;      // motion blur: 5 taps
constexpr int MK = 2 * MHALF + 1;
constexpr int MW = TW + 2 * MHALF;  // motion column-pass width

// Blocks per SM the register budget must allow: the 8-bit instantiations
// fit in 64 registers (4 blocks of 256 threads), the widening ones in 80.
constexpr int kMinBlocksNarrow = 4;
constexpr int kMinBlocksWide = 3;

static_assert(TH == 32 && TW % 8 == 0 && TH % RV == 0, "tile shape (TW even: parity)");

// Q16 taps by value: this scale's, the next scale's, the motion blur's.
struct Taps {
  unsigned f[17];
  unsigned fn[9];
  unsigned fm[MK];
};

// Shared-memory layout of one scale's tile (bytes; the uint32 planes first).
template <int HALF, bool WIDE>
struct Tile {
  static constexpr int HN = HALF / 2;                     // next scale's half-width
  static constexpr int SH = TH + 2 * HALF, SW = TW + 2 * HALF;
  static constexpr int VS = 2 * (((SW + 1) / 2) | 1);      // uint16 row stride: odd words
  static constexpr int PS = WIDE ? (SW | 1) : VS;          // product row stride
  static constexpr int DW = TW + 2 * HN;                   // decimation column-pass width
  static constexpr size_t kProd = size_t(TH) * PS * (WIDE ? 4 : 2);
  static constexpr size_t kMu = size_t(TH) * VS * 2;
  static constexpr size_t kStage = size_t(SH) * SW * 2;
  static constexpr size_t kDec = size_t(TH / 2) * DW * 2;
  static constexpr size_t oMu = 3 * kProd;
  static constexpr size_t oX = oMu + 2 * kMu;
  static constexpr size_t oY = oX + kStage;
  static constexpr size_t oDec = oY + kStage;
  static constexpr size_t oMot = oDec + 2 * kDec;
  static constexpr size_t kBytes = oMot + size_t(TH) * MW * 2;
};

// Truncating normalisation of x >= 2^15 into [2^15, 2^16)
// (golden/log2lut.py:normalize16): returns the mantissa, sets the shift.
__device__ __forceinline__ int normalize16(u64 x, int* k) {
  const int bl = 64 - __clzll(static_cast<i64>(x));
  const int s = bl > 16 ? bl - 16 : 0;
  *k = s;
  return static_cast<int>(x >> s);
}

// Q11 log2 table value of x's truncated 16-bit mantissa. ``tab`` holds
// log2_table()[32768:65536] as int32. Trap 3: the values run 30720..32768,
// past int16's range, so the table is int32 and is indexed with m - 32768
// only for mantissas m >= 32768 (normalize16 guarantees that here).
__device__ __forceinline__ int q11_log2(u64 x, const int* __restrict__ tab, int* k) {
  const int m = normalize16(x, k);
  return __ldg(tab + (m - 32768));
}

// One pixel of the exact statistic (golden/vif_int.py:126-161), added to
// the accumulators {num_tab, num_k, den_tab, den_k, n_log, flat_hi,
// flat_lo}.
__device__ __forceinline__ void vif_pixel(i64 sigma1, i64 sigma2, i64 sigma12,
                                          i64 nsq, const int* __restrict__ tab,
                                          double gain_limit, double eps,
                                          i64 (&acc)[7]) {
  const i64 s1 = sigma1 > 0 ? sigma1 : 0;
  const i64 s2 = sigma2 > 0 ? sigma2 : 0;
  if (s1 < nsq) {
    // Flat reference: raw sigma2, kept as the JAX package's 16/16 split so
    // the f32 combine can reproduce its rounding order.
    acc[5] += s2 >> 16;
    acc[6] += s2 & 0xFFFF;
    return;
  }
  int k;
  acc[2] += q11_log2(static_cast<u64>(nsq + s1), tab, &k);
  acc[3] += k;
  acc[4] += 1;
  if (sigma12 < 0) return;
  // Trap 2 (FMA contraction): the gain chain is numpy's float64
  // expression with one rounding per operation: g = s12/(s1+eps),
  // sv = trunc(s2 - g*s12), tmp = trunc((g*g)*s1). The _rn intrinsics are
  // never contracted (the build also passes --fmad=false).
  const double s1f = static_cast<double>(s1);
  const double s12f = static_cast<double>(sigma12);
  double g = __ddiv_rn(s12f, __dadd_rn(s1f, eps));
  double sv = trunc(__dsub_rn(static_cast<double>(s2), __dmul_rn(g, s12f)));
  sv = sv > 0.0 ? sv : 0.0;
  g = fmin(g, gain_limit);  // NEG clamp after sv (libvmaf order)
  const u64 numer1 = static_cast<u64>(sv) + static_cast<u64>(nsq);
  const double tmp = trunc(__dmul_rn(__dmul_rn(g, g), s1f));
  int k1, k2;
  const int t1 = q11_log2(static_cast<u64>(tmp) + numer1, tab, &k1);
  const int t2 = q11_log2(numer1, tab, &k2);
  acc[0] += t1 - t2;
  acc[1] += k1 - k2;
}

// 4 / 255^2 of the fast statistic's flat branch, rounded to f32 from the
// double once, as the plain version's constant is.
constexpr float kFlatScale = static_cast<float>(4.0 / (255.0 * 255.0));

// One pixel of the smooth f32-log statistic (pqa2_tpu/ops/vif_int.py:
// _statistic_fast), added to {num, den}: the plain version's f32
// operations in its order, each rounded on its own (the _rn intrinsics;
// the build also passes --fmad=false), and log2f, which torch.log2 calls
// on the card too. The divisions by 65536 and by 2 are multiplications by
// 2^-16 and 0.5, exact for these values as the divisions are, so they give
// the same bits. A Q16 variance on the 8-bit scale is below 2^30
// (|covariance| too), so every sigma converts through int32 as the JAX
// package's does. The gain limit applies after sv^2 (libvmaf order).
__device__ __forceinline__ void vif_pixel_fast(i64 sigma1, i64 sigma2, i64 sigma12, i64 nsq,
                                               float gain_limit, double (&acc)[2]) {
  constexpr float kQ16 = 1.0f / 65536.0f;
  const float s2 = __fmul_rn(__int2float_rn(static_cast<int>(sigma2 > 0 ? sigma2 : 0)), kQ16);
  if (sigma1 < nsq) {
    acc[0] += static_cast<double>(__fsub_rn(1.0f, __fmul_rn(s2, kFlatScale)));
    acc[1] += 1.0;
    return;
  }
  const float s1 = __fmul_rn(__int2float_rn(static_cast<int>(sigma1)), kQ16);
  const float s12 = __fmul_rn(__int2float_rn(static_cast<int>(sigma12)), kQ16);
  float g = s12 > 0.0f ? __fdiv_rn(s12, fmaxf(s1, 1e-10f)) : 0.0f;
  const float sv = fmaxf(__fsub_rn(s2, __fmul_rn(g, s12)), 0.0f);
  g = fminf(g, gain_limit);
  const float ratio = __fdiv_rn(__fmul_rn(__fmul_rn(g, g), s1), __fadd_rn(sv, 2.0f));
  acc[0] += static_cast<double>(log2f(__fadd_rn(1.0f, ratio)));
  acc[1] += static_cast<double>(log2f(__fadd_rn(1.0f, __fmul_rn(s1, 0.5f))));
}

// A symmetric KxK-tap window at v[o .. o + 2*H] (step 1), uint32: exact
// while the whole sum stays below 2^32 (every term is non-negative, so
// every partial sum is below the total).
template <int H, int N>
__device__ __forceinline__ unsigned sum32(const unsigned* f, const unsigned (&v)[N], int o) {
  unsigned a = f[H] * v[o + H];
#pragma unroll
  for (int t = 0; t < H; ++t) a += f[t] * (v[o + t] + v[o + 2 * H - t]);
  return a;
}

// The same window in 64 bits: one 32x32->64 multiply-add per tap (the
// values may reach 2^32, so a pair could not be added first).
template <int H, int N>
__device__ __forceinline__ u64 sum64(const unsigned* f, const unsigned (&v)[N], int o) {
  u64 a = static_cast<u64>(f[H]) * v[o + H];
#pragma unroll
  for (int t = 0; t < H; ++t)
    a += static_cast<u64>(f[t]) * v[o + t] + static_cast<u64>(f[t]) * v[o + 2 * H - t];
  return a;
}

// Staged tile: rows y0-HALF.. and columns x0-HALF.. of one plane with
// reflect borders (golden/filters.py:reflect_index), as uint16.
template <int HALF, typename In>
__device__ __forceinline__ void stage(const In* __restrict__ src, int H, int W, int x0,
                                      int y0, u16* dst) {
  constexpr int SH = TH + 2 * HALF, SW = TW + 2 * HALF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int sy = warp; sy < SH; sy += kThreads / 32) {
    const In* row = src + static_cast<size_t>(reflect_idx(y0 - HALF + sy, H)) * W;
    for (int sx = lane; sx < SW; sx += 32)
      dst[sy * SW + sx] = static_cast<u16>(__ldg(row + reflect_idx(x0 - HALF + sx, W)));
  }
}

// Column pass of the 5-tap motion blur (golden/motion_int.py:blur_int,
// >> 8+in_q, rounded) over the staged tile ``s`` (halo HALF >= 2) into
// ``mv`` (TH x MW); item i of the MW x TH/RV column strips.
template <int HALF>
__device__ __forceinline__ void motion_columns(const u16* s, int i, const unsigned* fm,
                                               int vs, u16* mv) {
  constexpr int SW = TW + 2 * HALF, N = RV + 2 * MHALF;
  const int c = i % MW, r0 = (i / MW) * RV;
  const u16* col = s + (r0 + HALF - MHALF) * SW + (c + HALF - MHALF);
  unsigned v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = col[j * SW];
  const unsigned rnd = 1u << (vs - 1);
#pragma unroll
  for (int r = 0; r < RV; ++r)
    mv[(r0 + r) * MW + c] = static_cast<u16>((sum32<MHALF>(fm, v, r) + rnd) >> vs);
}

// Row pass of the motion blur (>> 16, rounded) for output i of the tile,
// written to the frame's uint16 plane.
__device__ __forceinline__ void motion_row(const u16* mv, int i, const unsigned* fm, int H,
                                           int W, int x0, int y0, u16* __restrict__ out) {
  const int r = i / TW, b = i - (i / TW) * TW;
  if (y0 + r >= H || x0 + b >= W) return;
  unsigned v[MK];
#pragma unroll
  for (int t = 0; t < MK; ++t) v[t] = mv[r * MW + b + t];
  out[static_cast<size_t>(y0 + r) * W + x0 + b] =
      static_cast<u16>((sum32<MHALF>(fm, v, 0) + 32768u) >> 16);
}

// One VIF scale over a 48x32 tile of frame blockIdx.z: the statistic's
// seven accumulators added to ``sums`` (int64 (n, 7)), or with FAST the
// block's {num, den} partials written to ``sums`` (double, the layout of
// common.cuh:block_partials); with next_ref the next scale's Q8 planes
// (even rows and columns, the next scale's taps); with blurred the motion
// blur of this frame, written as frame blockIdx.z + mframe of ``blurred``.
template <int HALF, bool WIDE, bool FAST, typename In>
__global__ void __launch_bounds__(kThreads, WIDE ? kMinBlocksWide : kMinBlocksNarrow)
vif_int_scale_kernel(const In* __restrict__ ref, const In* __restrict__ dist, int H, int W,
                     int in_q, const __grid_constant__ Taps taps,
                     const int* __restrict__ tab, double gain_limit,
                     double eps, i64 nsq, void* __restrict__ sums, int* __restrict__ next_ref,
                     int* __restrict__ next_dist, u16* __restrict__ blurred, int mframe) {
  using T = Tile<HALF, WIDE>;
  typedef typename std::conditional<WIDE, unsigned, u16>::type P;   // product plane
  typedef typename std::conditional<WIDE, u64, unsigned>::type S;   // product row sum
  constexpr int HN = T::HN, SW = T::SW, VS = T::VS, PS = T::PS, DW = T::DW;
  extern __shared__ __align__(16) unsigned char smem[];
  P* vp = reinterpret_cast<P*>(smem);                   // xx, yy, xy column sums
  u16* vmu = reinterpret_cast<u16*>(smem + T::oMu);     // mu1, mu2 column sums
  u16* sx = reinterpret_cast<u16*>(smem + T::oX);
  u16* sy = reinterpret_cast<u16*>(smem + T::oY);
  u16* dv = reinterpret_cast<u16*>(smem + T::oDec);
  u16* mv = reinterpret_cast<u16*>(smem + T::oMot);

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int tid = threadIdx.x;
  // Vertical shift (mu to Q8 pixels) and horizontal shift (products back
  // to Q16 pixel^2); 8-bit codes: 8 and 0.
  const int vs = WIDE ? 8 + in_q : 8;
  const int hs = WIDE ? 2 * in_q : 0;
  const bool dec = HN > 0 && next_ref != nullptr;
  const bool mot = HALF >= MHALF && blurred != nullptr;

  stage<HALF>(ref + n * plane, H, W, x0, y0, sx);
  stage<HALF>(dist + n * plane, H, W, x0, y0, sy);
  __syncthreads();

  // Column passes. Items: the five moments (SW columns x TH/RV strips),
  // then the decimation (2 planes x DW columns), then the motion blur.
  constexpr int NM = SW * (TH / RV);
  constexpr int ND = HN > 0 ? 2 * DW : 0;
  const int total = NM + (dec ? ND : 0) + (mot ? MW * (TH / RV) : 0);
  for (int i = tid; i < total; i += kThreads) {
    if (i < NM) {
      // Moments: mu rounds to Q8 pixels (>> vs), products >> 16.
      const int c = i % SW, r0 = (i / SW) * RV;
      constexpr int N = RV + 2 * HALF;
      const unsigned rnd = 1u << (vs - 1);
      // One plane at a time, each staged value read again from shared
      // memory (cheaper than the registers to hold them): x, y, then x*x,
      // y*y, x*y formed once per staged value (< 2^32: codes < 2^16).
      unsigned p[N];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const unsigned a = sx[(r0 + j) * SW + c], b = sy[(r0 + j) * SW + c];
          p[j] = m == 0 ? a : m == 1 ? b : m == 2 ? a * a : m == 3 ? b * b : a * b;
        }
#pragma unroll
        for (int r = 0; r < RV; ++r) {
          if (m < 2) {
            vmu[m * TH * VS + (r0 + r) * VS + c] =
                static_cast<u16>((sum32<HALF>(taps.f, p, r) + rnd) >> vs);
          } else {
            P* o = vp + (m - 2) * TH * PS + (r0 + r) * PS + c;
            if constexpr (WIDE)
              *o = static_cast<P>((sum64<HALF>(taps.f, p, r) + 32768u) >> 16);
            else
              *o = static_cast<P>((sum32<HALF>(taps.f, p, r) + 32768u) >> 16);
          }
        }
      }
    } else if (i < NM + ND && dec) {
      // Next scale's column pass at the even rows 2a, every column its row
      // pass reads (staged columns HALF-HN .. HALF+TW+HN), >> vs rounded.
      const int j = i - NM, pl = j / DW, c = j - (j / DW) * DW;
      constexpr int N = TH - 1 + 2 * HN;
      const u16* col = (pl ? sy : sx) + (HALF - HN) * SW + (HALF - HN + c);
      unsigned v[N];
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] = col[q * SW];
      const unsigned rnd = 1u << (vs - 1);
#pragma unroll
      for (int a = 0; a < TH / 2; ++a)
        dv[pl * (TH / 2) * DW + a * DW + c] =
            static_cast<u16>((sum32<HN>(taps.fn, v, 2 * a) + rnd) >> vs);
    } else if constexpr (HALF >= MHALF) {
      motion_columns<HALF>(sx, i - NM - (dec ? ND : 0), taps.fm, vs, mv);
    }
  }
  __syncthreads();

  // Row pass of the moments: lane = tile row, warp = a strip of RC
  // columns. mu to Q24 (no rounding), products back to Q16 pixel^2
  // (>> hs), then the sigma planes and the statistic.
  i64 acc[7] = {0, 0, 0, 0, 0, 0, 0};
  double facc[2] = {0.0, 0.0};
  {
    const int row = tid & 31, c0 = (tid >> 5) * RC;
    constexpr int N = RC + 2 * HALF;
    unsigned v[N];
    unsigned mu[2][RC];
    S pr[3][RC];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = vmu[m * TH * VS + row * VS + c0 + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) mu[m][c] = sum32<HALF>(taps.f, v, c);
    }
    const u64 hround = hs ? (1ull << (hs - 1)) : 0ull;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = vp[m * TH * PS + row * PS + c0 + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if constexpr (WIDE)
          pr[m][c] = (sum64<HALF>(taps.f, v, c) + hround) >> hs;
        else
          pr[m][c] = sum32<HALF>(taps.f, v, c);
      }
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (y0 + row >= H || x0 + c0 + c >= W) continue;
      // Trap 1 (uint64 products): mu < 2^32, so mu*mu + 2^31 < 2^64 and
      // (a*b + 2^31) >> 32 is exact in unsigned 64-bit arithmetic.
      const u64 m1 = mu[0][c], m2 = mu[1][c];
      const u64 m11 = (m1 * m1 + (1ull << 31)) >> 32;
      const u64 m22 = (m2 * m2 + (1ull << 31)) >> 32;
      const u64 m12 = (m1 * m2 + (1ull << 31)) >> 32;
      if constexpr (FAST)
        vif_pixel_fast(static_cast<i64>(pr[0][c]) - static_cast<i64>(m11),
                       static_cast<i64>(pr[1][c]) - static_cast<i64>(m22),
                       static_cast<i64>(pr[2][c]) - static_cast<i64>(m12),
                       nsq, static_cast<float>(gain_limit), facc);
      else
        vif_pixel(static_cast<i64>(pr[0][c]) - static_cast<i64>(m11),
                  static_cast<i64>(pr[1][c]) - static_cast<i64>(m22),
                  static_cast<i64>(pr[2][c]) - static_cast<i64>(m12),
                  nsq, tab, gain_limit, eps, acc);
    }
  }

  // Row passes of the decimation (>> 16, rounded, at the even columns 2b)
  // and of the motion blur, one output per item.
  if (dec || mot) {
    constexpr int NDO = HN > 0 ? 2 * (TH / 2) * (TW / 2) : 0;
    const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
    const int nd = dec ? NDO : 0;
    const int total2 = nd + (mot ? TH * TW : 0);
    for (int i = tid; i < total2; i += kThreads) {
      if (i < nd) {
        const int pl = i / ((TH / 2) * (TW / 2)), q = i - pl * ((TH / 2) * (TW / 2));
        const int a = q / (TW / 2), b = q - (q / (TW / 2)) * (TW / 2);
        const int gy = y0 / 2 + a, gx = x0 / 2 + b;
        if (gy >= H2 || gx >= W2) continue;
        constexpr int KN = 2 * HN + 1;
        unsigned v[KN];
#pragma unroll
        for (int t = 0; t < KN; ++t) v[t] = dv[pl * (TH / 2) * DW + a * DW + 2 * b + t];
        int* out = pl ? next_dist : next_ref;
        out[static_cast<size_t>(n) * H2 * W2 + static_cast<size_t>(gy) * W2 + gx] =
            static_cast<int>((sum32<HN>(taps.fn, v, 0) + 32768u) >> 16);
      } else if constexpr (HALF >= MHALF) {
        motion_row(mv, i - nd, taps.fm, H, W, x0, y0,
                   blurred + static_cast<size_t>(n + mframe) * plane);
      }
    }
  }
  if constexpr (FAST)
    block_partials<2>(facc, static_cast<double*>(sums));
  else
    block_atomic_add<7>(acc, static_cast<i64*>(sums) + static_cast<size_t>(n) * 7);
}

// Motion blur of the frames of ``src`` that the scale-0 launch did not
// blur (all frames but [skip_lo, skip_hi)): staged 48x32 tiles with a
// 2-pixel reflect halo, the same column and row passes.
template <typename In>
__global__ void __launch_bounds__(kThreads)
motion_blur_kernel(const In* __restrict__ src, int H, int W, int in_q,
                   const __grid_constant__ Taps taps,
                   int skip_lo, int skip_hi, u16* __restrict__ blurred) {
  constexpr int SW = TW + 2 * MHALF, SH = TH + 2 * MHALF;
  __shared__ u16 s[SH * SW];
  __shared__ u16 mv[TH * MW];
  const int f = blockIdx.z < skip_lo ? blockIdx.z : blockIdx.z + (skip_hi - skip_lo);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int vs = 8 + in_q;
  stage<MHALF>(src + f * plane, H, W, x0, y0, s);
  __syncthreads();
  for (int i = threadIdx.x; i < MW * (TH / RV); i += kThreads)
    motion_columns<MHALF>(s, i, taps.fm, vs, mv);
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += kThreads)
    motion_row(mv, i, taps.fm, H, W, x0, y0, blurred + f * plane);
}

// sad[p-1] = sum |blur[p] - blur[p-1]| over the plane, exact in int64.
__global__ void __launch_bounds__(kThreads)
motion_sad_kernel(const u16* __restrict__ blur, int HW, i64* __restrict__ sad) {
  const int p = blockIdx.y + 1;
  const u16* a = blur + static_cast<size_t>(p) * HW;
  const u16* b = a - HW;
  i64 acc[1] = {0};
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < HW;
       idx += gridDim.x * kThreads) {
    const int dd = static_cast<int>(a[idx]) - static_cast<int>(b[idx]);
    acc[0] += dd < 0 ? -dd : dd;
  }
  block_atomic_add<1>(acc, sad + (p - 1));
}

// For every mantissa m in [2^15, 2^16): the lookup of m itself (shift 0)
// and of a 37-bit value whose truncated mantissa is m (shift 21), compared
// on the card with want[i] and want[32768 + i] (golden/log2lut.py's
// values, uploaded apart from the table the lookup reads); a wrong shift
// is a mismatch too. Each block counts its mismatches and adds them to
// *bad with one integer atomic: exact in any order.
__global__ void __launch_bounds__(kThreads)
log2_audit_kernel(const int* __restrict__ tab, const int* __restrict__ want,
                  int* __restrict__ bad) {
  __shared__ int red[kThreads / 32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int miss = 0;
  if (i < 32768) {
    const u64 m = 32768ull + i;
    int k;
    int v = q11_log2(m, tab, &k);
    miss += k != 0 || v != __ldg(want + i);
    v = q11_log2((m << 21) | (m & 0x1FFFFFull), tab, &k);
    miss += k != 21 || v != __ldg(want + 32768 + i);
  }
  miss = __reduce_add_sync(0xffffffffu, miss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = miss;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    if (s != 0) atomicAdd(bad, s);
  }
}

Taps make_taps(const int* f, int k, const int* fn, int kn, const int* fm) {
  Taps t = {};
  for (int i = 0; i < k; ++i) t.f[i] = static_cast<unsigned>(f[i]);
  for (int i = 0; fn && i < kn; ++i) t.fn[i] = static_cast<unsigned>(fn[i]);
  for (int i = 0; fm && i < MK; ++i) t.fm[i] = static_cast<unsigned>(fm[i]);
  return t;
}

// A scale launch's arguments, as the C launcher was given them.
struct ScaleArgs {
  const void* ref;
  const void* dist;
  int n, h, w, in_q;
  Taps taps;
  const int* tab;
  double gain_limit, eps;
  i64 nsq;
  i64* stats;    // exact form: (n, 7) int64 accumulators
  double* part;  // fast form: n * blocks * 2 partials ...
  float* sums;   // ... and the (n, 2) f32 {num, den} sums
  int* next_ref;
  int* next_dist;
  u16* blurred;
  int mframe;
  cudaStream_t stream;
};

template <int HALF, bool WIDE, bool FAST, typename In>
int launch_scale(const ScaleArgs& a) {
  auto kern = vif_int_scale_kernel<HALF, WIDE, FAST, In>;
  constexpr size_t bytes = Tile<HALF, WIDE>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.w + TW - 1) / TW, (a.h + TH - 1) / TH, a.n);
  void* out = FAST ? static_cast<void*>(a.part) : static_cast<void*>(a.stats);
  kern<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const In*>(a.ref), static_cast<const In*>(a.dist), a.h, a.w, a.in_q, a.taps,
      a.tab, a.gain_limit, a.eps, a.nsq, out, a.next_ref, a.next_dist, a.blurred, a.mframe);
  err = cudaGetLastError();
  if (err != cudaSuccess || !FAST) return static_cast<int>(err);
  finish_partials_kernel<2><<<a.n, kThreads, 0, a.stream>>>(
      a.part, static_cast<int>(grid.x * grid.y), a.sums);
  return static_cast<int>(cudaGetLastError());
}

template <int HALF, bool WIDE, typename In>
int launch_form(const ScaleArgs& a, bool fast) {
  return fast ? launch_scale<HALF, WIDE, true, In>(a) : launch_scale<HALF, WIDE, false, In>(a);
}

template <int HALF>
int dispatch_scale(const ScaleArgs& a, int in_u8, bool fast) {
  if (in_u8) return launch_form<HALF, false, unsigned char>(a, fast);
  if (a.in_q == 0) return launch_form<HALF, false, int>(a, fast);
  return launch_form<HALF, true, int>(a, fast);
}

}  // namespace

extern "C" {

const char* pqa2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Partials per frame of the fast form for an (h, w) plane (the wrapper
// sizes its scratch).
int pqa2_vif_int_blocks(int h, int w) {
  return ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
}

// One VIF scale. ref/dist (n, h, w): uint8 codes (in_u8, in_q 0) or int32
// codes (Q{in_q}, < 2^16; below 2^8 at in_q 0). Host taps: this scale's
// 2*half+1, the next scale's 2*(half/2)+1 when next_ref/next_dist (n,
// ceil(h/2), ceil(w/2)) int32 are given, the 5 motion taps when blurred
// (uint16 frames) is given: frame i of ref is blurred into frame i + mframe
// (half >= 2). The exact statistic (fast 0) adds to stats (n, 7) int64,
// zeroed by the caller; the fast one (fast 1) writes part (n *
// pqa2_vif_int_blocks(h, w) * 2 doubles of scratch) and sums (n, 2) f32
// {num, den}.
int pqa2_vif_scale(const void* ref, const void* dist, int in_u8, int n, int h, int w,
                   int in_q, int half, const int* taps, const int* next_taps,
                   const int* motion_taps, const int* tab, double gain_limit, double eps,
                   long long nsq, int fast, long long* stats, double* part, float* sums,
                   int* next_ref, int* next_dist, unsigned short* blurred, int mframe,
                   cudaStream_t stream) {
  if (n < 1 || h <= half || w <= half || in_q < 0 || in_q > 8 || (in_u8 && in_q != 0) ||
      ((next_ref != nullptr) != (next_dist != nullptr)) || (next_ref && (half < 2 || !next_taps)) ||
      (blurred && (half < MHALF || !motion_taps)) ||
      (fast ? (!part || !sums) : (!stats || !tab)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ScaleArgs a = {ref, dist, n, h, w, in_q,
                       make_taps(taps, 2 * half + 1, next_taps, 2 * (half / 2) + 1, motion_taps),
                       tab, gain_limit, eps, nsq, stats, part, sums, next_ref, next_dist,
                       blurred, mframe, stream};
  switch (half) {
    case 8: return dispatch_scale<8>(a, in_u8, fast != 0);
    case 4: return dispatch_scale<4>(a, in_u8, fast != 0);
    case 2: return dispatch_scale<2>(a, in_u8, fast != 0);
    case 1: return dispatch_scale<1>(a, in_u8, fast != 0);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 5-tap motion blur of the (m, h, w) codes (uint8 when in_u8, else int32)
// into uint16 Q8 frames, skipping frames [skip_lo, skip_hi).
int pqa2_motion_blur(const void* src, int in_u8, int m, int h, int w, int in_q, int skip_lo,
                     int skip_hi, const int* motion_taps, unsigned short* blurred,
                     cudaStream_t stream) {
  const int frames = m - (skip_hi - skip_lo);
  if (h <= MHALF || w <= MHALF || skip_lo < 0 || skip_hi < skip_lo || skip_hi > m ||
      (in_u8 && in_q != 0) || in_q < 0 || in_q > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const Taps t = make_taps(motion_taps, MK, nullptr, 0, motion_taps);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, frames);
  if (in_u8)
    motion_blur_kernel<unsigned char><<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned char*>(src), h, w, in_q, t, skip_lo, skip_hi, blurred);
  else
    motion_blur_kernel<int><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(src), h, w, in_q, t, skip_lo, skip_hi, blurred);
  return static_cast<int>(cudaGetLastError());
}

// sad (m-1,) int64 of consecutive uint16 blurred frames, zeroed by the caller.
int pqa2_motion_sad(const unsigned short* blur, int m, int h, int w, long long* sad,
                    cudaStream_t stream) {
  const int hw = h * w;
  int bx = (hw + kThreads - 1) / kThreads;
  if (bx > 256) bx = 256;
  motion_sad_kernel<<<dim3(bx, m - 1), kThreads, 0, stream>>>(blur, hw, sad);
  return static_cast<int>(cudaGetLastError());
}

// tab: the lookup's table (32768,) int32; want: the expected values (2 *
// 32768,) int32; bad: one int32, zeroed by the caller, the mismatch count.
int pqa2_log2_audit(const int* tab, const int* want, int* bad, cudaStream_t stream) {
  log2_audit_kernel<<<32768 / kThreads, kThreads, 0, stream>>>(tab, want, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
