// One integer ADM level — kernel 3 of pqa2_tpu_torch.
//
// Replaces adm_int_level_pallas (pqa2_tpu/ops/pallas_adm_int.py,
// pl.pallas_call at :381, body _make_int_kernel :60): the Q15 db2 DWT of
// ref and dist, integer decoupling with the f32 angle test, the IRF CSF,
// the 3x3 trunc(S/30) masking threshold, cube-sum pooling over the 10 %
// trimmed core, and the next level's approximation bands.
//
// What bounds it on Hopper: integer issue. Device memory sees one read of
// each input plane and one write of each approximation plane (the bands
// never leave the SM); a band pixel costs ~60 multiply-adds of the two
// DWT passes of two planes, the decoupling (with a quotient per band) and
// the pooling. Design, one launch per level (adm_tile.cuh): a block owns a
// 61x16 band tile, runs the row pass of both planes into shared memory and
// the column pass straight into the decoupling, once per pixel, then pools
// its core pixels after one barrier. Arithmetic no wider than the values:
//   * the DWT runs in int32 wherever the host's envelope
//     (ops/adm_int.py:dwt_envelope) proves every accumulator below 2^31 —
//     level 0 up to 15 bits, both passes of levels 1 and 2 — and elsewhere
//     (depth 16's level-0 row pass, level 3) one 32x32->64 multiply-add per
//     tap; no 64x64 product. Taps are kernel parameters, and 8-bit luma is
//     read as its bytes with the Q4 shift folded into the row taps;
//   * k = (|t| << 15) / |o| needs no divide: the clamp decides k = 2^15
//     where |t| >= |o|, elsewhere the quotient is below 2^15 and an f32
//     estimate within one of it is corrected once, exactly
//     (quotient_q15; pqa2_adm_quotient_audit checks every input of the
//     envelope). The CSF product and the cubes widen to 64 bits, the
//     threshold's sum (< 2^24) does not;
//   * the six sums per frame are int64 (adm_cube_shift keeps them below
//     2^63), reduced per block before one integer atomic each, so block
//     order does not matter.
#include "adm_tile.cuh"

#include <math.h>

using namespace pqa2;
using namespace pqa2::admtile;

namespace {

struct Taps {
  int row[8];  // lo[0..3], hi[0..3] in Q15, times 2^in_shift (the Q4 shift of 8-bit luma)
  int col[8];  // lo[0..3], hi[0..3] in Q15
};

struct LevelParams {
  int irf[3];
  float gain;
  int gain_one;
  float cos_sq;
  int row_shift;  // 15 + extra_row_shift
  int trim_h, trim_w;
  int dshift;
};

// One output of a 1-D pass: (sum_t f[t] * x[t] + 2^(s-1)) >> s, an
// arithmetic shift (it floors, as the oracle's numpy >> does: trap 5). In
// int32 (WIDE false) only where the envelope bounds every partial sum below
// 2^31 (every input interval holds 0, so no partial sum leaves the total's).
template <bool WIDE>
__device__ __forceinline__ int dwt4(const int* f, int x0, int x1, int x2, int x3, int s) {
  if (WIDE) {
    i64 a = static_cast<i64>(f[0]) * x0;
    a += static_cast<i64>(f[1]) * x1;
    a += static_cast<i64>(f[2]) * x2;
    a += static_cast<i64>(f[3]) * x3;
    return static_cast<int>((a + (1ll << (s - 1))) >> s);
  }
  return (f[0] * x0 + f[1] * x1 + f[2] * x2 + f[3] * x3 + (1 << (s - 1))) >> s;
}

// floor(num / oa) for num < oa * 2^15 (the quotient is below 2^15):
// num_f is num in f32 (rounded), the estimate is within 0.02 of the
// quotient (three f32 roundings and __fdividef's 2 ulp, relative to
// 2^15), so its truncation is off by at most one, and one exact step on
// the remainder corrects it. No 64-bit divide.
__device__ __forceinline__ int quotient_q15(u64 num, float num_f, unsigned oa) {
  int q = __float2int_rz(__fdividef(num_f, __uint2float_rn(oa)));
  const i64 r = static_cast<i64>(num) - static_cast<i64>(static_cast<u64>(q) * oa);
  q += (r >= static_cast<i64>(oa)) - (r < 0);
  return q;
}

__device__ __forceinline__ int icsf(int band, int irf) {
  return static_cast<int>((static_cast<i64>(band) * irf + 4096) >> 13);  // trap 5
}

// v^3 of v = (x + 2^(d-1)) >> d, x >= 0: v <= 2^15, so v*v fits 32 bits.
__device__ __forceinline__ u64 cube(int x, int dshift) {
  const unsigned v = static_cast<unsigned>(x + (1 << (dshift - 1))) >> dshift;
  return static_cast<u64>(v * v) * v;
}

// Integer decoupling, CSF and threshold term of one band pixel
// (golden/adm_int.py:119-220): returns sum_b |icsf(t_b - rst_b)|; sets
// rc[b] = |icsf(rst_b)|.
__device__ __forceinline__ int decouple(const int (&o)[3], const int (&t)[3],
                                        const LevelParams& p, int (&rc)[3]) {
  const float oh = static_cast<float>(o[0]), ov = static_cast<float>(o[1]);
  const float th = static_cast<float>(t[0]), tv = static_cast<float>(t[1]);
  // Trap 2 (FMA contraction): the oracle's f32 angle test with every
  // product and sum rounded on its own (golden/adm_int.py:160-166).
  const float ot_dp = __fadd_rn(__fmul_rn(oh, th), __fmul_rn(ov, tv));
  const float o_mag = __fadd_rn(__fmul_rn(oh, oh), __fmul_rn(ov, ov));
  const float t_mag = __fadd_rn(__fmul_rn(th, th), __fmul_rn(tv, tv));
  const bool angle = ot_dp >= 0.0f &&
      __fmul_rn(ot_dp, ot_dp) >= __fmul_rn(__fmul_rn(p.cos_sq, o_mag), t_mag);
  int A = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int ob = o[b], tb = t[b];
    const unsigned oa = ob < 0 ? -ob : ob, ta = tb < 0 ? -tb : tb;
    // Trap 5: k = min((|t| << 15) / |o|, 2^15) only where the signs agree
    // and t != 0; restoration sign(o) * ((k*|o| + 2^14) >> 15), which is
    // |o| itself where k is clamped.
    int mag = 0;
    if (ob != 0 && tb != 0 && (ob > 0) == (tb > 0)) {
      if (ta >= oa) {
        mag = static_cast<int>(oa);
      } else {
        const unsigned k = quotient_q15(static_cast<u64>(ta) << 15,
                                        __uint2float_rn(ta) * 32768.0f, oa);
        mag = static_cast<int>((static_cast<u64>(k) * oa + 16384) >> 15);
      }
    }
    int r = ob < 0 ? -mag : mag;
    if (angle) {
      // rint(f32(r) * f32(gain)), one f32 rounding then round-half-even.
      const i64 g = p.gain_one ? r
          : static_cast<i64>(rintf(__fmul_rn(static_cast<float>(r), p.gain)));
      r = tb > 0 ? static_cast<int>(g < tb ? g : tb)
                 : (tb < 0 ? static_cast<int>(g > tb ? g : tb) : 0);
    }
    const int c = icsf(r, p.irf[b]);
    rc[b] = c < 0 ? -c : c;
    const int a = icsf(tb - r, p.irf[b]);
    A += a < 0 ? -a : a;
  }
  return A;
}

// h, v, d of one plane from its row-pass output at (rr, co); a as well
// where asked.
template <bool WIDE>
__device__ __forceinline__ void col_bands(const int (*lo)[SW], const int (*hi)[SW], int rr,
                                          int co, const int* f, int (&hvd)[3], int* a) {
  const Quad<int> l = quad_at(lo[rr], co), h = quad_at(hi[rr], co);
  if (a) *a = dwt4<WIDE>(f, l.x0, l.x1, l.x2, l.x3, 15);
  hvd[0] = dwt4<WIDE>(f, h.x0, h.x1, h.x2, h.x3, 15);
  hvd[1] = dwt4<WIDE>(f + 4, l.x0, l.x1, l.x2, l.x3, 15);
  hvd[2] = dwt4<WIDE>(f + 4, h.x0, h.x1, h.x2, h.x3, 15);
}

// One level for a 61x16 band tile of one frame. sums (n, 3, 2) int64:
// bands h/v/d x {masked restoration, |icsf(ref)|}, zeroed by the caller.
template <typename In, bool ROW_WIDE, bool COL_WIDE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adm_int_level_kernel(const In* __restrict__ ref, const In* __restrict__ dist, int H, int W,
                     const __grid_constant__ Taps taps, const __grid_constant__ LevelParams p,
                     int* __restrict__ ref_a, int* __restrict__ dist_a, i64* __restrict__ sums) {
  __shared__ __align__(16) int s_lo[2][RH][SW];
  __shared__ __align__(16) int s_hi[2][RH][SW];
  __shared__ int s_A[RH][HW];  // sum_b |icsf(additive_b)|
  const Geometry g = geometry(H, W, p.trim_h, p.trim_w);
  row_pass<int>(g, ref, dist, s_lo, s_hi, [&](bool high, int x0, int x1, int x2, int x3) {
    return dwt4<ROW_WIDE>(taps.row + (high ? 4 : 0), x0, x1, x2, x3, p.row_shift);
  });
  __syncthreads();

  const size_t band0 = static_cast<size_t>(blockIdx.z) * g.H2 * g.W2;
  i64 acc[6] = {0, 0, 0, 0, 0, 0};
  int rc[KP][3];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    int ly, lx;
    const bool mine = tile_slot(k, ly, lx);
    const int i = g.i0 - 1 + ly, j = g.j0 - 1 + lx;
    const bool inside = mine && i < g.H2 && j < g.W2;
    const bool thr = mine && g.pool && thresholded(g, i, j);
    int rr = ly, co = 2 * lx;
    if (thr) band_source(g, ly, lx, rr, co);
    int o[3], t[3], ao, at;
    if (thr) {
      col_bands<COL_WIDE>(s_lo[0], s_hi[0], rr, co, taps.col, o, &ao);
      col_bands<COL_WIDE>(s_lo[1], s_hi[1], rr, co, taps.col, t, &at);
    } else if (inside) {
      const Quad<int> l0 = quad_at(s_lo[0][ly], co), l1 = quad_at(s_lo[1][ly], co);
      ao = dwt4<COL_WIDE>(taps.col, l0.x0, l0.x1, l0.x2, l0.x3, 15);
      at = dwt4<COL_WIDE>(taps.col, l1.x0, l1.x1, l1.x2, l1.x3, 15);
    }
    if (inside) {
      const size_t q = band0 + static_cast<size_t>(i) * g.W2 + j;
      ref_a[q] = ao;
      dist_a[q] = at;
    }
    if (thr) {
      s_A[ly][lx] = decouple(o, t, p, rc[k]);
      if (pooled(g, i, j)) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int c = icsf(o[b], p.irf[b]);
          acc[2 * b + 1] += static_cast<i64>(cube(c < 0 ? -c : c, p.dshift));
        }
      }
    }
  }
  if (g.pool && threadIdx.x < NHALO) {
    int ly, lx;
    halo_slot(threadIdx.x, ly, lx);
    const int i = g.i0 - 1 + ly, j = g.j0 - 1 + lx;
    if (thresholded(g, i, j)) {
      int rr, co, o[3], t[3], rc_h[3];
      band_source(g, ly, lx, rr, co);
      col_bands<COL_WIDE>(s_lo[0], s_hi[0], rr, co, taps.col, o, nullptr);
      col_bands<COL_WIDE>(s_lo[1], s_hi[1], rr, co, taps.col, t, nullptr);
      s_A[ly][lx] = decouple(o, t, p, rc_h);
    }
  }
  __syncthreads();

  if (g.pool) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      int ly, lx;
      const bool mine = tile_slot(k, ly, lx);
      if (!mine || !pooled(g, g.i0 - 1 + ly, g.j0 - 1 + lx)) continue;
      // trunc(S / 30), S the 3x3 sum with the centre counted twice
      // (golden/adm_int.py:204-220): S < 30 * 2^19, so 32 bits hold it.
      unsigned S = s_A[ly][lx];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) S += s_A[ly + dy][lx + dx];
      const int thr = static_cast<int>(S / 30u);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int m = rc[k][b] - thr;
        acc[2 * b] += static_cast<i64>(cube(m > 0 ? m : 0, p.dshift));
      }
    }
  }
  block_atomic_add<6>(acc, sums + static_cast<size_t>(blockIdx.z) * 6);
}

template <typename In, bool ROW_WIDE, bool COL_WIDE>
void launch_level(const void* ref, const void* dist, int n, int h, int w, const Taps& taps,
                  const LevelParams& p, int* ref_a, int* dist_a, i64* sums,
                  cudaStream_t stream) {
  const dim3 grid((((w + 1) / 2) + TW - 1) / TW, (((h + 1) / 2) + TH - 1) / TH, n);
  adm_int_level_kernel<In, ROW_WIDE, COL_WIDE><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(ref), static_cast<const In*>(dist), h, w, taps, p, ref_a,
      dist_a, sums);
}

// The audit of quotient_q15 over every input the decoupling can give it
// (1 <= |t| < |o| <= oa_max), and at the directed numerators q*oa,
// q*oa - 1 and q*oa + oa - 1 for every quotient q < 2^15: one block per
// oa. bad counts the wrong quotients.
__global__ void __launch_bounds__(kThreads)
quotient_audit_kernel(long long* __restrict__ bad) {
  const unsigned oa = blockIdx.x + 1;
  i64 miss[1] = {0};
  for (unsigned ta = 1 + threadIdx.x; ta < oa; ta += kThreads) {
    const u64 num = static_cast<u64>(ta) << 15;
    const u64 q = static_cast<u64>(quotient_q15(num, __uint2float_rn(ta) * 32768.0f, oa));
    miss[0] += !(q * oa <= num && num < (q + 1) * oa);
  }
  for (int q = threadIdx.x; q < 32768; q += kThreads) {
    const u64 base = static_cast<u64>(q) * oa;
    const u64 nums[3] = {base, base - 1, base + oa - 1};
    const int want[3] = {q, q - 1, q};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c == 1 && q == 0) continue;
      miss[0] += quotient_q15(nums[c], __ull2float_rn(nums[c]), oa) != want[c];
    }
  }
  block_atomic_add<1>(miss, bad);
}

}  // namespace

extern "C" {

// One integer ADM level. ref/dist (n, h, w): uint8 8-bit luma at level 0
// (in_u8; in_shift the Q4 shift applied as it is read) or int32 codes.
// taps: host {lo[4], hi[4]} Q15. row_wide/col_wide: the passes that need
// 64-bit accumulators (ops/adm_int.py:dwt_envelope). ref_a/dist_a (n,
// ceil(h/2), ceil(w/2)) int32; sums (n, 3, 2) int64, zeroed by the caller.
int pqa2_adm_int_level(const void* ref, const void* dist, int in_u8, int n, int h, int w,
                       int in_shift, int extra, int row_wide, int col_wide, const int* taps,
                       int irf_h, int irf_v, int irf_d, float gain, int gain_one,
                       float cos_sq, int trim_h, int trim_w, int dshift, int* ref_a,
                       int* dist_a, long long* sums, cudaStream_t stream) {
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  if (n < 1 || h2 - 2 * trim_h <= 0 || w2 - 2 * trim_w <= 0 || trim_h < 0 || trim_w < 0 ||
      dshift < 1 || extra < 0 || extra > 8 || in_shift < 0 || in_shift > 8 ||
      (in_u8 && (row_wide || col_wide)))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  for (int k = 0; k < 8; ++k) {
    t.row[k] = taps[k] * (1 << in_shift);
    t.col[k] = taps[k];
  }
  LevelParams p;
  p.irf[0] = irf_h;
  p.irf[1] = irf_v;
  p.irf[2] = irf_d;
  p.gain = gain;
  p.gain_one = gain_one;
  p.cos_sq = cos_sq;
  p.row_shift = 15 + extra;
  p.trim_h = trim_h;
  p.trim_w = trim_w;
  p.dshift = dshift;
  if (in_u8)
    launch_level<unsigned char, false, false>(ref, dist, n, h, w, t, p, ref_a, dist_a, sums, stream);
  else if (!row_wide && !col_wide)
    launch_level<int, false, false>(ref, dist, n, h, w, t, p, ref_a, dist_a, sums, stream);
  else if (!col_wide)
    launch_level<int, true, false>(ref, dist, n, h, w, t, p, ref_a, dist_a, sums, stream);
  else if (!row_wide)
    launch_level<int, false, true>(ref, dist, n, h, w, t, p, ref_a, dist_a, sums, stream);
  else
    launch_level<int, true, true>(ref, dist, n, h, w, t, p, ref_a, dist_a, sums, stream);
  return static_cast<int>(cudaGetLastError());
}

// bad: one int64, zeroed by the caller; oa_max <= 65536.
int pqa2_adm_quotient_audit(int oa_max, long long* bad, cudaStream_t stream) {
  if (oa_max < 1 || oa_max > 65536) return static_cast<int>(cudaErrorInvalidValue);
  quotient_audit_kernel<<<oa_max, kThreads, 0, stream>>>(bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
