// Integer fixed-point VIF scale pass, fused motion SAD, and the Q11 log2
// table audit — kernels 1 and 2 of pqa2_tpu_torch.
//
// Replaces (pqa2_tpu/ops/pallas_vif_int.py):
//   * vif_int_scale_pallas (pl.pallas_call at :1021, body _make_int_kernel
//     :486): one VIF scale's Q16 moments, sigma planes and the exact
//     Q11-LUT statistic summed per frame; the next scale's 2x-decimated Q8
//     planes; at scale 0 the integer SAD of the 5-tap-blurred reference;
//   * log2_direct_exceptions (pl.pallas_call at :152): the exhaustive audit
//     of the log2 used by the statistic against golden/log2lut.py.
//
// What bounds it on Hopper: the statistic is ALU/f64-bound (one f64
// divide and four f64 multiplies per log-branch pixel, int64 sums), the
// moment pass is bound by shared-memory traffic of the 17-tap window
// (5 products x 17 taps x 2 passes per pixel at scale 0); device-memory
// traffic is one read of each plane per scale. Design: one block stages a
// 64x16 output tile plus its reflect halo of ref and dist in shared memory
// (read once from device memory), runs the vertical pass into shared
// memory and the horizontal pass plus statistic in registers, and reduces
// the seven per-frame accumulators per block before one integer atomic
// each. Hopper has int64, uint64 and f64 natively, so none of the TPU's
// uint32 splitting, long division, double-f32 log engines or the 2^24-px
// envelope is needed: the table is read (__ldg, L1-resident 128 KB).
// Decimation and the motion blur/SAD are separate, simple launches; fusing
// them into the scale pass is later work.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int TW = 64;  // output columns per block
constexpr int TH = 16;  // output rows per block

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

template <int HALF>
__global__ void __launch_bounds__(kThreads)
vif_stat_kernel(const int* __restrict__ ref, const int* __restrict__ dist,
                int H, int W, int in_q, const int* __restrict__ taps_g,
                const int* __restrict__ tab, double gain_limit, double eps,
                i64 nsq, i64* __restrict__ stats) {
  constexpr int K = 2 * HALF + 1;
  constexpr int SW = TW + 2 * HALF;
  constexpr int SH = TH + 2 * HALF;
  __shared__ unsigned s_taps[K];
  __shared__ unsigned s_r[SH][SW];
  __shared__ unsigned s_d[SH][SW];
  __shared__ unsigned v_mu1[TH][SW];
  __shared__ unsigned v_mu2[TH][SW];
  __shared__ unsigned v_xx[TH][SW];
  __shared__ unsigned v_yy[TH][SW];
  __shared__ unsigned v_xy[TH][SW];

  const int n = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int* r = ref + n * plane;
  const int* d = dist + n * plane;
  const int tid = threadIdx.x;

  if (tid < K) s_taps[tid] = static_cast<unsigned>(taps_g[tid]);
  for (int i = tid; i < SH * SW; i += kThreads) {
    const int sy = i / SW, sx = i - (i / SW) * SW;
    const size_t p = static_cast<size_t>(reflect_idx(y0 - HALF + sy, H)) * W +
                     reflect_idx(x0 - HALF + sx, W);
    s_r[sy][sx] = static_cast<unsigned>(__ldg(r + p));
    s_d[sy][sx] = static_cast<unsigned>(__ldg(d + p));
  }
  __syncthreads();

  // Vertical pass: mu rounds to Q8 pixels (>> 8+in_q), products >> 16.
  const int vs = 8 + in_q;
  const u64 vround = 1ull << (vs - 1);
  for (int i = tid; i < TH * SW; i += kThreads) {
    const int ty = i / SW, sx = i - (i / SW) * SW;
    u64 a1 = 0, a2 = 0, p11 = 0, p22 = 0, p12 = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const u64 f = s_taps[t];
      const u64 x = s_r[ty + t][sx];
      const u64 y = s_d[ty + t][sx];
      a1 += f * x;
      a2 += f * y;
      p11 += f * (x * x);
      p22 += f * (y * y);
      p12 += f * (x * y);
    }
    v_mu1[ty][sx] = static_cast<unsigned>((a1 + vround) >> vs);
    v_mu2[ty][sx] = static_cast<unsigned>((a2 + vround) >> vs);
    v_xx[ty][sx] = static_cast<unsigned>((p11 + 32768ull) >> 16);
    v_yy[ty][sx] = static_cast<unsigned>((p22 + 32768ull) >> 16);
    v_xy[ty][sx] = static_cast<unsigned>((p12 + 32768ull) >> 16);
  }
  __syncthreads();

  // Horizontal pass: mu to Q24 (no rounding), products back to Q16
  // pixel^2 (>> 2*in_q), then sigma planes and the statistic.
  const int hs = 2 * in_q;
  const u64 hround = hs ? (1ull << (hs - 1)) : 0ull;
  i64 acc[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int ty = i / TW, tx = i - (i / TW) * TW;
    if (y0 + ty >= H || x0 + tx >= W) continue;
    u64 m1 = 0, m2 = 0, xx = 0, yy = 0, xy = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const u64 f = s_taps[t];
      m1 += f * v_mu1[ty][tx + t];
      m2 += f * v_mu2[ty][tx + t];
      xx += f * v_xx[ty][tx + t];
      yy += f * v_yy[ty][tx + t];
      xy += f * v_xy[ty][tx + t];
    }
    xx = (xx + hround) >> hs;
    yy = (yy + hround) >> hs;
    xy = (xy + hround) >> hs;
    // Trap 1 (uint64 products): mu < 2^32, so mu*mu + 2^31 < 2^64 and
    // (a*b + 2^31) >> 32 is exact in unsigned 64-bit arithmetic.
    const u64 m11 = (m1 * m1 + (1ull << 31)) >> 32;
    const u64 m22 = (m2 * m2 + (1ull << 31)) >> 32;
    const u64 m12 = (m1 * m2 + (1ull << 31)) >> 32;
    vif_pixel(static_cast<i64>(xx) - static_cast<i64>(m11),
              static_cast<i64>(yy) - static_cast<i64>(m22),
              static_cast<i64>(xy) - static_cast<i64>(m12),
              nsq, tab, gain_limit, eps, acc);
  }
  block_atomic_add<7>(acc, stats + static_cast<size_t>(n) * 7);
}

// Separable Q16 blur to Q8 (vertical >> 8+in_q, horizontal >> 16, reflect
// borders), evaluated at every STEP-th row and column: STEP 2 is the VIF
// decimation between scales (golden/vif_int.py:_decimate), STEP 1 with
// the 5-tap window is the motion blur (golden/motion_int.py:blur_int).
template <int HALF, int STEP>
__global__ void __launch_bounds__(kThreads)
blur_q8_kernel(const int* __restrict__ src, int H, int W, int in_q,
               const int* __restrict__ taps_g, int* __restrict__ dst) {
  constexpr int K = 2 * HALF + 1;
  __shared__ unsigned s_taps[K];
  if (threadIdx.x < K) s_taps[threadIdx.x] = static_cast<unsigned>(taps_g[threadIdx.x]);
  __syncthreads();
  const int Ho = (H + STEP - 1) / STEP, Wo = (W + STEP - 1) / STEP;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= Ho * Wo) return;
  const int n = blockIdx.y;
  const int i = idx / Wo, j = idx - (idx / Wo) * Wo;
  const int* s = src + static_cast<size_t>(n) * H * W;
  const int vs = 8 + in_q;
  int rows[K];
#pragma unroll
  for (int t = 0; t < K; ++t) rows[t] = reflect_idx(STEP * i - HALF + t, H);
  u64 hacc = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = reflect_idx(STEP * j - HALF + c, W);
    u64 vacc = 0;
#pragma unroll
    for (int t = 0; t < K; ++t)
      vacc += static_cast<u64>(s_taps[t]) *
              static_cast<unsigned>(__ldg(s + static_cast<size_t>(rows[t]) * W + col));
    hacc += static_cast<u64>(s_taps[c]) * ((vacc + (1ull << (vs - 1))) >> vs);
  }
  dst[static_cast<size_t>(n) * Ho * Wo + idx] = static_cast<int>((hacc + 32768ull) >> 16);
}

// sad[p-1] = sum |blur[p] - blur[p-1]| over the plane, exact in int64.
__global__ void __launch_bounds__(kThreads)
motion_sad_kernel(const int* __restrict__ blur, int HW, i64* __restrict__ sad) {
  const int p = blockIdx.y + 1;
  const int* a = blur + static_cast<size_t>(p) * HW;
  const int* b = a - HW;
  i64 acc[1] = {0};
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < HW;
       idx += gridDim.x * kThreads) {
    const int dd = __ldg(a + idx) - __ldg(b + idx);
    acc[0] += dd < 0 ? -dd : dd;
  }
  block_atomic_add<1>(acc, sad + (p - 1));
}

// For every mantissa m in [2^15, 2^16): the lookup of m itself (shift 0)
// and of a 37-bit value whose truncated mantissa is m (shift 21); -1 where
// the shift is wrong.
__global__ void log2_audit_kernel(const int* __restrict__ tab, int* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 32768) return;
  const u64 m = 32768ull + i;
  int k;
  int v = q11_log2(m, tab, &k);
  out[i] = k == 0 ? v : -1;
  v = q11_log2((m << 21) | (m & 0x1FFFFFull), tab, &k);
  out[32768 + i] = k == 21 ? v : -1;
}

template <int HALF>
void launch_stat(const int* ref, const int* dist, int n, int h, int w, int in_q,
                 const int* taps, const int* tab, double gain_limit, double eps,
                 i64 nsq, i64* stats, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  vif_stat_kernel<HALF><<<grid, kThreads, 0, stream>>>(
      ref, dist, h, w, in_q, taps, tab, gain_limit, eps, nsq, stats);
}

template <int HALF, int STEP>
void launch_blur(const int* src, int n, int h, int w, int in_q, const int* taps,
                 int* dst, cudaStream_t stream) {
  const int ho = (h + STEP - 1) / STEP, wo = (w + STEP - 1) / STEP;
  const dim3 grid((ho * wo + kThreads - 1) / kThreads, n);
  blur_q8_kernel<HALF, STEP><<<grid, kThreads, 0, stream>>>(src, h, w, in_q, taps, dst);
}

}  // namespace

extern "C" {

const char* pqa2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One VIF scale: stats (n, 7) int64 must be zeroed by the caller.
int pqa2_vif_scale(const int* ref, const int* dist, int n, int h, int w,
                   int in_q, int half, const int* taps, const int* tab,
                   double gain_limit, double eps, long long nsq, long long* stats,
                   cudaStream_t stream) {
  switch (half) {
    case 8: launch_stat<8>(ref, dist, n, h, w, in_q, taps, tab, gain_limit, eps, nsq, stats, stream); break;
    case 4: launch_stat<4>(ref, dist, n, h, w, in_q, taps, tab, gain_limit, eps, nsq, stats, stream); break;
    case 2: launch_stat<2>(ref, dist, n, h, w, in_q, taps, tab, gain_limit, eps, nsq, stats, stream); break;
    case 1: launch_stat<1>(ref, dist, n, h, w, in_q, taps, tab, gain_limit, eps, nsq, stats, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Decimate (n, h, w) Q{in_q} codes to (n, ceil(h/2), ceil(w/2)) Q8 with
// the next scale's (2*half+1)-tap window.
int pqa2_vif_decimate(const int* src, int n, int h, int w, int in_q, int half,
                      const int* taps, int* dst, cudaStream_t stream) {
  switch (half) {
    case 4: launch_blur<4, 2>(src, n, h, w, in_q, taps, dst, stream); break;
    case 2: launch_blur<2, 2>(src, n, h, w, in_q, taps, dst, stream); break;
    case 1: launch_blur<1, 2>(src, n, h, w, in_q, taps, dst, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// 5-tap motion blur of (n, h, w) Q{in_q} codes to Q8 planes.
int pqa2_motion_blur(const int* src, int n, int h, int w, int in_q,
                     const int* taps, int* dst, cudaStream_t stream) {
  launch_blur<2, 1>(src, n, h, w, in_q, taps, dst, stream);
  return static_cast<int>(cudaGetLastError());
}

// sad (n-1,) int64, zeroed by the caller.
int pqa2_motion_sad(const int* blur, int n, int h, int w, long long* sad,
                    cudaStream_t stream) {
  const int hw = h * w;
  int bx = (hw + kThreads - 1) / kThreads;
  if (bx > 256) bx = 256;
  motion_sad_kernel<<<dim3(bx, n - 1), kThreads, 0, stream>>>(blur, hw, sad);
  return static_cast<int>(cudaGetLastError());
}

// out (2 * 32768,) int32.
int pqa2_log2_audit(const int* tab, int* out, cudaStream_t stream) {
  log2_audit_kernel<<<32768 / kThreads, kThreads, 0, stream>>>(tab, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
