// One float ADM level — kernel 6 of pqa2_tpu_torch.
//
// Replaces adm_level_pallas (pqa2_tpu/ops/pallas_adm.py, pl.pallas_call at
// :265, body _make_kernel :52): the f32 db2 DWT of ref and dist, the
// decoupling into restoration and additive parts with the 1-degree angle
// test, the Watson CSF factors (csf_rfactors), the 3x3 masking threshold
// (centre doubled, /30), the six cube sums {num_h, den_h, num_v, den_v,
// num_d, den_d} over the trimmed core, and the next level's approximation
// bands. The cbrt and stabiliser tail stays in PyTorch (ops/adm.py).
//
// What bounds it on Hopper: device-memory traffic of the bands — the DWT
// reads each input plane once and writes four band planes per input, the
// pooling pass reads six band planes (the one-band halo mostly from L1/L2)
// — against a few dozen f32 operations per band pixel. Design, following
// adm_int.cu, three launches per level: (a) one thread per band pixel of
// one plane computes a/h/v/d straight from the approximation plane with
// the symmetric 2i-1+f indexing (no host polyphase split, which was a TPU
// layout workaround: pallas_adm.py:230-259); (b) one block per 32x8 core
// tile decouples the tile plus a one-band symmetric halo into shared
// memory (|csf(additive)| of each band: the threshold needs decoupled
// neighbours, and band edges repeat the edge sample as ops/adm.py:66 pads
// them), then each thread thresholds and cubes its pixel, summing in
// float64; (c) the fixed-order pass adds the per-block partials per frame
// and rounds each sum to f32 once, so two runs give the same bits. Every
// f32 product and sum is rounded on its own in ops/adm.py's order
// (__fmul_rn/__fadd_rn, and --fmad=false), so the bands equal the plain
// version's bit for bit.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int PW = 32;  // core pixels per pooling tile, x
constexpr int PH = 8;   // core pixels per pooling tile, y (PW*PH == kThreads)

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

// (a) One band pixel (i, j) of one plane: the row-direction (column) pass
// at the four columns the row pass reads, then the row pass;
// taps = {lo[0..3], hi[0..3]}.
__global__ void __launch_bounds__(kThreads)
adm_dwt_f32_kernel(const float* __restrict__ src, int H, int W,
                   const float* __restrict__ taps_g, float* __restrict__ a,
                   float* __restrict__ hb, float* __restrict__ vb, float* __restrict__ db) {
  __shared__ float f[8];
  if (threadIdx.x < 8) f[threadIdx.x] = taps_g[threadIdx.x];
  __syncthreads();
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= H2 * W2) return;
  const int n = blockIdx.y;
  const int i = idx / W2, j = idx - (idx / W2) * W2;
  const float* s = src + static_cast<size_t>(n) * H * W;
  int rows[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) rows[t] = symmetric_idx(2 * i - 1 + t, H);
  float lo[4], hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = symmetric_idx(2 * j - 1 + c, W);
    const float x0 = __ldg(s + static_cast<size_t>(rows[0]) * W + col);
    float la = fmul(f[0], x0), ha = fmul(f[4], x0);
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      const float x = __ldg(s + static_cast<size_t>(rows[t]) * W + col);
      la = fadd(la, fmul(f[t], x));
      ha = fadd(ha, fmul(f[4 + t], x));
    }
    lo[c] = la;
    hi[c] = ha;
  }
  float aa = fmul(f[0], lo[0]), vv = fmul(f[4], lo[0]);
  float hh = fmul(f[0], hi[0]), dd = fmul(f[4], hi[0]);
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    aa = fadd(aa, fmul(f[c], lo[c]));
    vv = fadd(vv, fmul(f[4 + c], lo[c]));
    hh = fadd(hh, fmul(f[c], hi[c]));
    dd = fadd(dd, fmul(f[4 + c], hi[c]));
  }
  const size_t o = static_cast<size_t>(n) * H2 * W2 + idx;
  a[o] = aa;
  vb[o] = vv;
  hb[o] = hh;
  db[o] = dd;
}

struct LevelParams {
  float csf[3];  // h, v, d
  float gain;
  float cos_sq;
};

// Decoupling of one pixel (ops/adm.py:_decouple) -> rst per band.
__device__ __forceinline__ void decouple(const float (&o)[3], const float (&t)[3],
                                         const LevelParams& p, float (&rst)[3]) {
  const float ot_dp = fadd(fmul(o[0], t[0]), fmul(o[1], t[1]));
  const float o_mag = fadd(fmul(o[0], o[0]), fmul(o[1], o[1]));
  const float t_mag = fadd(fmul(t[0], t[0]), fmul(t[1], t[1]));
  const bool angle = ot_dp >= 0.f && fmul(ot_dp, ot_dp) >= fmul(fmul(p.cos_sq, o_mag), t_mag);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const float ob = o[b], tb = t[b];
    float k = ob != 0.f ? __fdiv_rn(tb, ob) : 0.f;
    k = k < 0.f ? 0.f : (k > 1.f ? 1.f : k);  // torch.clamp(k, 0, 1)
    float r = fmul(k, ob);
    if (angle) {
      const float g = fmul(r, p.gain);
      r = tb > 0.f ? (g < tb ? g : tb) : (tb < 0.f ? (g > tb ? g : tb) : tb);
    }
    rst[b] = r;
  }
}

// (b) Decoupling, CSF, masking and cube sums of one 32x8 core tile ->
// six float64 block partials {num_h, den_h, num_v, den_v, num_d, den_d}.
__global__ void __launch_bounds__(kThreads)
adm_pool_f32_kernel(const float* __restrict__ oh, const float* __restrict__ ov,
                    const float* __restrict__ od, const float* __restrict__ th,
                    const float* __restrict__ tv, const float* __restrict__ td,
                    int H2, int W2, int trim_h, int trim_w, LevelParams p,
                    double* __restrict__ part) {
  __shared__ float s_a[3][PH + 2][PW + 2];  // |csf(additive)| per band
  const int n = blockIdx.z;
  const size_t off = static_cast<size_t>(n) * H2 * W2;
  const int y0 = trim_h + blockIdx.y * PH, x0 = trim_w + blockIdx.x * PW;
  const int y_end = H2 - trim_h, x_end = W2 - trim_w;

  for (int i = threadIdx.x; i < (PH + 2) * (PW + 2); i += kThreads) {
    const int sy = i / (PW + 2), sx = i - (i / (PW + 2)) * (PW + 2);
    const size_t q = off + static_cast<size_t>(symmetric_idx(y0 - 1 + sy, H2)) * W2 +
                     symmetric_idx(x0 - 1 + sx, W2);
    const float o[3] = {__ldg(oh + q), __ldg(ov + q), __ldg(od + q)};
    const float t[3] = {__ldg(th + q), __ldg(tv + q), __ldg(td + q)};
    float rst[3];
    decouple(o, t, p, rst);
#pragma unroll
    for (int b = 0; b < 3; ++b) s_a[b][sy][sx] = fabsf(fmul(__fsub_rn(t[b], rst[b]), p.csf[b]));
  }
  __syncthreads();

  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int ty = threadIdx.x / PW, tx = threadIdx.x - (threadIdx.x / PW) * PW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < y_end && gx < x_end) {
    // Threshold: per band the 3x3 sum in (row, column) order, then the
    // centre once more; bands added h, v, d; one true division by 30.
    float total = 0.f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float s = s_a[b][ty][tx];
#pragma unroll
      for (int k = 1; k < 9; ++k) s = fadd(s, s_a[b][ty + k / 3][tx + k % 3]);
      s = fadd(s, s_a[b][ty + 1][tx + 1]);
      total = b == 0 ? s : fadd(total, s);
    }
    const float mt = __fdiv_rn(total, 30.f);
    const size_t q = off + static_cast<size_t>(gy) * W2 + gx;
    const float o[3] = {__ldg(oh + q), __ldg(ov + q), __ldg(od + q)};
    const float t[3] = {__ldg(th + q), __ldg(tv + q), __ldg(td + q)};
    float rst[3];
    decouple(o, t, p, rst);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float m = __fsub_rn(fabsf(fmul(rst[b], p.csf[b])), mt);
      m = m < 0.f ? 0.f : m;
      acc[2 * b] = static_cast<double>(fmul(fmul(m, m), m));
      const float c = fabsf(fmul(o[b], p.csf[b]));
      acc[2 * b + 1] = static_cast<double>(fmul(fmul(c, c), c));
    }
  }
  block_partials<6>(acc, part);
}

}  // namespace

extern "C" {

// a/h/v/d: (n, ceil(h/2), ceil(w/2)) f32 each; taps {lo[4], hi[4]} f32.
int pqa2_adm_dwt_f32(const float* src, int n, int h, int w, const float* taps,
                     float* a, float* hb, float* vb, float* db, cudaStream_t stream) {
  const int bands = ((h + 1) / 2) * ((w + 1) / 2);
  const dim3 grid((bands + kThreads - 1) / kThreads, n);
  adm_dwt_f32_kernel<<<grid, kThreads, 0, stream>>>(src, h, w, taps, a, hb, vb, db);
  return static_cast<int>(cudaGetLastError());
}

// Partials per frame for a (ch, cw) trimmed core (the wrapper sizes its
// scratch).
int pqa2_adm_f32_blocks(int ch, int cw) {
  return ((cw + PW - 1) / PW) * ((ch + PH - 1) / PH);
}

// Pooling of one level's bands: part scratch n * blocks * 6 doubles; sums
// (n, 6) f32 out.
int pqa2_adm_pool_f32(const float* oh, const float* ov, const float* od,
                      const float* th, const float* tv, const float* td, int n,
                      int h2, int w2, int trim_h, int trim_w, float csf_h, float csf_v,
                      float csf_d, float gain, float cos_sq, double* part, float* sums,
                      cudaStream_t stream) {
  const int ch = h2 - 2 * trim_h, cw = w2 - 2 * trim_w;
  if (ch <= 0 || cw <= 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  LevelParams p;
  p.csf[0] = csf_h;
  p.csf[1] = csf_v;
  p.csf[2] = csf_d;
  p.gain = gain;
  p.cos_sq = cos_sq;
  const dim3 grid((cw + PW - 1) / PW, (ch + PH - 1) / PH, n);
  adm_pool_f32_kernel<<<grid, kThreads, 0, stream>>>(oh, ov, od, th, tv, td, h2, w2,
                                                     trim_h, trim_w, p, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_partials_kernel<6><<<n, kThreads, 0, stream>>>(
      part, static_cast<int>(grid.x * grid.y), sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
