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
// What bounds it on Hopper: f32 issue of unfused multiplies and adds (the
// bands must equal the plain version's bits, so no FMA) once the bands stay
// on the SM; device memory sees one read of each input plane and one write
// of each approximation plane. Design, as adm_int.cu (adm_tile.cuh): one
// launch per level, a block per 61x16 band tile runs the row pass of both
// planes into shared memory and the column pass straight into the
// decoupling, once per pixel, keeping each band's |csf(additive)| in
// shared memory for the threshold, then pools its core pixels in float64;
// the fixed-order pass (common.cuh:finish_partials_kernel) adds the block
// partials per frame and rounds each sum to f32 once, so two runs give the
// same bits. Every f32 product and sum is rounded on its own in
// ops/adm.py's order (__fmul_rn/__fadd_rn, and --fmad=false), so the bands
// equal the plain version's bit for bit; k = t/o is divided only where the
// clamp to [0, 1] does not already decide it.
#include "adm_tile.cuh"

#include <math.h>

using namespace pqa2;
using namespace pqa2::admtile;

namespace {

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

struct Taps {
  float f[8];  // lo[0..3], hi[0..3]
};

struct LevelParams {
  float csf[3];  // h, v, d
  float gain;
  float cos_sq;
  int trim_h, trim_w;
};

// One output of a 1-D pass, taps in order (ops/filters.py:_dwt1d_axis).
__device__ __forceinline__ float dwt4(const float* f, float x0, float x1, float x2, float x3) {
  return fadd(fadd(fadd(fmul(f[0], x0), fmul(f[1], x1)), fmul(f[2], x2)), fmul(f[3], x3));
}

// h, v, d of one plane from its row-pass output at (rr, co); a as well
// where asked.
__device__ __forceinline__ void col_bands(const float (*lo)[SW], const float (*hi)[SW], int rr,
                                          int co, const float* f, float (&hvd)[3], float* a) {
  const Quad<float> l = quad_at(lo[rr], co), h = quad_at(hi[rr], co);
  if (a) *a = dwt4(f, l.x0, l.x1, l.x2, l.x3);
  hvd[0] = dwt4(f, h.x0, h.x1, h.x2, h.x3);
  hvd[1] = dwt4(f + 4, l.x0, l.x1, l.x2, l.x3);
  hvd[2] = dwt4(f + 4, h.x0, h.x1, h.x2, h.x3);
}

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
    // torch.clamp(t / o, 0, 1), 0 where o == 0. The clamp decides k without
    // the division where the signs differ or t is 0 (k <= 0: 0; a signed
    // zero of k only signs a zero r, which no sum sees) and where
    // |t| >= |o| with equal signs (correct rounding is monotone, so t / o
    // >= 1: k = 1).
    float k = 0.f;
    if (ob != 0.f && tb != 0.f && (ob > 0.f) == (tb > 0.f))
      k = fabsf(tb) >= fabsf(ob) ? 1.f : __fdiv_rn(tb, ob);
    float r = fmul(k, ob);
    if (angle) {
      const float g = fmul(r, p.gain);
      r = tb > 0.f ? (g < tb ? g : tb) : (tb < 0.f ? (g > tb ? g : tb) : tb);
    }
    rst[b] = r;
  }
}

// Shared memory of one block (dynamic: above the 48 KB of static shared
// memory).
struct Smem {
  float lo[2][RH][SW];
  float hi[2][RH][SW];
  float A[3][RH][HW];  // |csf(additive)| per band
};

// One level for a 61x16 band tile of one frame -> six float64 block
// partials {num_h, den_h, num_v, den_v, num_d, den_d}.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
adm_level_f32_kernel(const float* __restrict__ ref, const float* __restrict__ dist, int H,
                     int W, const __grid_constant__ Taps taps,
                     const __grid_constant__ LevelParams p, float* __restrict__ ref_a,
                     float* __restrict__ dist_a, double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const Geometry g = geometry(H, W, p.trim_h, p.trim_w);
  row_pass<float>(g, ref, dist, s.lo, s.hi, [&](bool high, float x0, float x1, float x2,
                                                float x3) {
    return dwt4(taps.f + (high ? 4 : 0), x0, x1, x2, x3);
  });
  __syncthreads();

  const size_t band0 = static_cast<size_t>(blockIdx.z) * g.H2 * g.W2;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  float rc[KP][3];  // |csf(rst)| of this thread's pooled pixels
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    int ly, lx;
    const bool mine = tile_slot(k, ly, lx);
    const int i = g.i0 - 1 + ly, j = g.j0 - 1 + lx;
    const bool inside = mine && i < g.H2 && j < g.W2;
    const bool thr = mine && g.pool && thresholded(g, i, j);
    int rr = ly, co = 2 * lx;
    if (thr) band_source(g, ly, lx, rr, co);
    float o[3], t[3], ao, at;
    if (thr) {
      col_bands(s.lo[0], s.hi[0], rr, co, taps.f, o, &ao);
      col_bands(s.lo[1], s.hi[1], rr, co, taps.f, t, &at);
    } else if (inside) {
      const Quad<float> l0 = quad_at(s.lo[0][ly], co), l1 = quad_at(s.lo[1][ly], co);
      ao = dwt4(taps.f, l0.x0, l0.x1, l0.x2, l0.x3);
      at = dwt4(taps.f, l1.x0, l1.x1, l1.x2, l1.x3);
    }
    if (inside) {
      const size_t q = band0 + static_cast<size_t>(i) * g.W2 + j;
      ref_a[q] = ao;
      dist_a[q] = at;
    }
    if (thr) {
      float rst[3];
      decouple(o, t, p, rst);
      const bool pool_px = pooled(g, i, j);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        s.A[b][ly][lx] = fabsf(fmul(__fsub_rn(t[b], rst[b]), p.csf[b]));
        rc[k][b] = fabsf(fmul(rst[b], p.csf[b]));
        if (pool_px) {
          const float c = fabsf(fmul(o[b], p.csf[b]));
          acc[2 * b + 1] += static_cast<double>(fmul(fmul(c, c), c));
        }
      }
    }
  }
  if (g.pool && threadIdx.x < NHALO) {
    int ly, lx;
    halo_slot(threadIdx.x, ly, lx);
    const int i = g.i0 - 1 + ly, j = g.j0 - 1 + lx;
    if (thresholded(g, i, j)) {
      int rr, co;
      float o[3], t[3], rst[3];
      band_source(g, ly, lx, rr, co);
      col_bands(s.lo[0], s.hi[0], rr, co, taps.f, o, nullptr);
      col_bands(s.lo[1], s.hi[1], rr, co, taps.f, t, nullptr);
      decouple(o, t, p, rst);
#pragma unroll
      for (int b = 0; b < 3; ++b) s.A[b][ly][lx] = fabsf(fmul(__fsub_rn(t[b], rst[b]), p.csf[b]));
    }
  }
  __syncthreads();

  if (g.pool) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      int ly, lx;
      const bool mine = tile_slot(k, ly, lx);
      if (!mine || !pooled(g, g.i0 - 1 + ly, g.j0 - 1 + lx)) continue;
      // Threshold: per band the 3x3 sum in (row, column) order, then the
      // centre once more; bands added h, v, d; one true division by 30.
      float total = 0.f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float sum = s.A[b][ly - 1][lx - 1];
#pragma unroll
        for (int q = 1; q < 9; ++q) sum = fadd(sum, s.A[b][ly - 1 + q / 3][lx - 1 + q % 3]);
        sum = fadd(sum, s.A[b][ly][lx]);
        total = b == 0 ? sum : fadd(total, sum);
      }
      const float mt = __fdiv_rn(total, 30.f);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float m = __fsub_rn(rc[k][b], mt);
        m = m < 0.f ? 0.f : m;
        acc[2 * b] += static_cast<double>(fmul(fmul(m, m), m));
      }
    }
  }
  block_partials<6>(acc, part);
}

}  // namespace

extern "C" {

// Block partials per frame of a level whose bands are (h2, w2): the
// wrapper sizes its scratch.
int pqa2_adm_f32_blocks(int h2, int w2) {
  return ((w2 + TW - 1) / TW) * ((h2 + TH - 1) / TH);
}

// One float ADM level. ref/dist (n, h, w) f32; taps host {lo[4], hi[4]};
// ref_a/dist_a (n, ceil(h/2), ceil(w/2)) f32; part scratch n * blocks * 6
// doubles; sums (n, 6) f32 out.
int pqa2_adm_level_f32(const float* ref, const float* dist, int n, int h, int w,
                       const float* taps, float csf_h, float csf_v, float csf_d, float gain,
                       float cos_sq, int trim_h, int trim_w, float* ref_a, float* dist_a,
                       double* part, float* sums, cudaStream_t stream) {
  const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
  if (n < 1 || trim_h < 0 || trim_w < 0 || h2 - 2 * trim_h <= 0 || w2 - 2 * trim_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  for (int k = 0; k < 8; ++k) t.f[k] = taps[k];
  LevelParams p;
  p.csf[0] = csf_h;
  p.csf[1] = csf_v;
  p.csf[2] = csf_d;
  p.gain = gain;
  p.cos_sq = cos_sq;
  p.trim_h = trim_h;
  p.trim_w = trim_w;
  constexpr int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(adm_level_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w2 + TW - 1) / TW, (h2 + TH - 1) / TH, n);
  adm_level_f32_kernel<<<grid, kThreads, bytes, stream>>>(ref, dist, h, w, t, p, ref_a, dist_a,
                                                          part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_partials_kernel<6><<<n, kThreads, 0, stream>>>(
      part, static_cast<int>(grid.x * grid.y), sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
