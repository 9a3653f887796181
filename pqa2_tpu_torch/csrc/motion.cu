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
// What bounds it on Hopper: device-memory reads, one f32 plane per frame
// (282 MB for a 34-frame 1080p chunk, 84 us at 3.35 TB/s), against ~30
// issue slots per pixel for the blur, the difference and its float64 sum.
// Design:
//  - A block owns a 128x32 output tile and walks a run of consecutive
//    frames (at most ``run``; the frames split evenly into runs): the TPU's
//    sequential frame axis becomes a loop inside the block. It blurs the
//    frame before its run first, and each thread keeps the blurred values of
//    its 4x4 pixels of the previous frame in registers, so a frame is read
//    and blurred once per run it belongs to (plus once as the frame before
//    the next run), not twice.
//  - The next frame's tile is copied into the other half of a
//    double-buffered shared tile with cp.async while this one is blurred,
//    behind one barrier per frame. The staged tile is 136x36 for 128x32
//    outputs (2 halo rows each side, 4 halo columns each side to keep
//    16-byte alignment): 16-byte copies where four columns lie inside the
//    plane (and the width is a multiple of 4), 4-byte reflected copies at
//    the borders.
//  - The column pass runs over a thread's own 4 columns (one 16-byte shared
//    load per staged row) and 2 halo columns for the lanes at the tile's
//    edges; the row pass takes the two columns each side from the
//    neighbouring lanes by shuffle. Tap order and one rounding per
//    operation as ops/filters.py, so every blurred value, and so every
//    |diff|, equals the plain version's.
//  - |diff| is summed in float64 per thread, per warp by shuffles and per
//    tile over the warps in order, into one partial per (frame, tile); a
//    second launch adds each frame's partials in tile order and divides by
//    f32(H*W) with __fdiv_rn. No float atomics: a second launch gives the
//    same bits.
#include "common.cuh"

#include <math.h>

using namespace pqa2;

namespace {

constexpr int HALF = 2;
constexpr int K = 2 * HALF + 1;
constexpr int PX = 4;               // a thread's outputs: 4 columns x 4 rows
constexpr int TW = 32 * PX;         // output columns per tile (a warp's lanes)
constexpr int WARPS = kThreads / 32;
constexpr int TH = WARPS * PX;      // output rows per tile (the block's warps)
constexpr int CPAD = 4;             // staged columns each side (16-byte aligned)
constexpr int SW = TW + 2 * CPAD;   // 136 staged columns
constexpr int SH = TH + 2 * HALF;   // 36 staged rows
constexpr int SW4 = SW / 4;        // 16-byte chunks per staged row
constexpr int CHUNKS = (SH * SW4 + kThreads - 1) / kThreads;  // per thread
constexpr int IN = PX + 2 * HALF;   // staged rows and columns one thread reads
static_assert(TW == 32 * PX && TH == WARPS * PX, "one thread per 4x4 outputs");

struct MotionTaps {
  float t[K];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying one frame's staged tile, rows y0-2..y0+TH+1 and columns
// x0-4..x0+TW+3. Interior tiles (every staged row and column inside the
// plane, rows 16-byte aligned) take 16-byte copies at offsets computed
// directly; border tiles reflect per 4-column chunk (golden/filters.py:
// reflect_index), with a 16-byte copy where the chunk lies inside the
// plane and 4-byte copies where it does not.
__device__ __forceinline__ void stage(const float* __restrict__ frame, int H, int W, int x0,
                                      int y0, bool interior, bool vec, float* __restrict__ s) {
  if (interior) {
    const float* base = frame + static_cast<size_t>(y0 - HALF) * W + (x0 - CPAD);
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < SH * SW4) {
        const int row = i / SW4, c4 = i - (i / SW4) * SW4;
        cp_async16(s + 4 * i, base + static_cast<size_t>(row) * W + 4 * c4);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < SH * SW4; i += kThreads) {
    const int row = i / SW4, c4 = i - (i / SW4) * SW4;
    const float* src = frame + static_cast<size_t>(reflect_idx(y0 - HALF + row, H)) * W;
    const int gx = x0 - CPAD + 4 * c4;
    if (vec && gx >= 0 && gx + 4 <= W) {
      cp_async16(s + 4 * i, src + gx);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(s + 4 * i + k, src + reflect_idx(gx + k, W));
    }
  }
}

// Blur a thread's 4x4 outputs (tile rows r0.., columns c0.. of lane
// ``lane``) from the staged tile ``s`` (SH x SW); with ``add``, sum
// |blur - prev| over its pixels inside the plane. Either way ``prev``
// becomes this frame's blurred values.
__device__ __forceinline__ void blur_diff(const float* __restrict__ s, int r0, int c0, int lane,
                                          const MotionTaps& tp, int rows, int cols, bool add,
                                          float (&prev)[PX][PX], double& sad) {
  // Column pass of the thread's own 4 columns and of 2 more: the tile's
  // left halo columns for lane 0, its right ones for lane 31 (the other
  // lanes compute them too and use their neighbours' instead). Staged row
  // r0 + i adds tap i - r to every output row r it reaches, so each value
  // is f0*x0, then + f_t*x_t in tap order.
  constexpr int NC = PX + 2;
  float col[PX][NC];
  const int halo = lane == 31 ? CPAD + TW : CPAD - HALF;
#pragma unroll
  for (int i = 0; i < IN; ++i) {
    const float* row = s + (r0 + i) * SW;
    const float4 a = *reinterpret_cast<const float4*>(row + CPAD + c0);
    const float2 h = *reinterpret_cast<const float2*>(row + halo);
    const float x[NC] = {a.x, a.y, a.z, a.w, h.x, h.y};
#pragma unroll
    for (int r = 0; r < PX; ++r) {
      const int t = i - r;
      if (t < 0 || t >= K) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        col[r][j] = t == 0 ? __fmul_rn(tp.t[0], x[j])
                           : __fadd_rn(col[r][j], __fmul_rn(tp.t[t], x[j]));
    }
  }
  // Row pass over columns c0-2..c0+5 (the outer two each side from the
  // neighbouring lanes, or the halo at the tile's edge), then the
  // difference from the previous frame.
#pragma unroll
  for (int r = 0; r < PX; ++r) {
    const float l2 = __shfl_up_sync(0xffffffffu, col[r][2], 1);
    const float l1 = __shfl_up_sync(0xffffffffu, col[r][3], 1);
    const float r1 = __shfl_down_sync(0xffffffffu, col[r][0], 1);
    const float r2 = __shfl_down_sync(0xffffffffu, col[r][1], 1);
    const float v[IN] = {lane == 0 ? col[r][4] : l2,  lane == 0 ? col[r][5] : l1,
                         col[r][0], col[r][1], col[r][2], col[r][3],
                         lane == 31 ? col[r][4] : r1, lane == 31 ? col[r][5] : r2};
#pragma unroll
    for (int c = 0; c < PX; ++c) {
      float acc = __fmul_rn(tp.t[0], v[c]);
#pragma unroll
      for (int t = 1; t < K; ++t) acc = __fadd_rn(acc, __fmul_rn(tp.t[t], v[c + t]));
      if (add && r < rows && c < cols)
        sad += static_cast<double>(fabsf(__fsub_rn(acc, prev[r][c])));
      prev[r][c] = acc;
    }
  }
}

// Frame f's partial of this tile: its 8 warp sums in warp order.
__device__ __forceinline__ void write_partial(const double* red, double* part, int f,
                                              int ntiles, int tile) {
  double a = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) a += red[w];
  part[static_cast<size_t>(f) * ntiles + tile] = a;
}

__global__ void __launch_bounds__(kThreads, 3)
motion_sad_f32_kernel(const float* __restrict__ frames, int N, int H, int W, int vec,
                      const __grid_constant__ MotionTaps taps, double* __restrict__ part) {
  __shared__ __align__(16) float s[2][SH * SW];
  __shared__ double red[2][WARPS];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int ntiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  // This block's run: frames [f0, f1), after the frame before it; the
  // first N % runs runs take one frame more.
  const int per = N / gridDim.z, more = N - per * gridDim.z, z = blockIdx.z;
  const int f0 = z * per + min(z, more);
  const int f1 = f0 + per + (z < more ? 1 : 0);
  const int first = f0 > 0 ? f0 - 1 : 0;
  const size_t plane = static_cast<size_t>(H) * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * PX, c0 = lane * PX;
  const int rows = H - (y0 + r0), cols = W - (x0 + c0);  // outputs inside the plane
  const bool interior = vec != 0 && x0 >= CPAD && x0 + TW + CPAD <= W && y0 >= HALF &&
                        y0 + TH + HALF <= H;
  // Frame 0 pairs with itself: its SAD is exactly 0.
  if (f0 == 0 && threadIdx.x == 0) part[tile] = 0.0;

  stage(frames + first * plane, H, W, x0, y0, interior, vec != 0, s[0]);
  cp_async_commit();
  float prev[PX][PX];
  for (int f = first; f < f1; ++f) {
    const int b = (f - first) & 1;
    cp_async_wait_all();
    // One barrier per frame: frame f's tile is in s[b] for every thread,
    // every thread is done with s[b ^ 1] and has put frame f-1's warp sum
    // in red[b ^ 1].
    __syncthreads();
    if (threadIdx.x == 0 && f - 1 > first) write_partial(red[b ^ 1], part, f - 1, ntiles, tile);
    if (f + 1 < f1) {
      stage(frames + (f + 1) * plane, H, W, x0, y0, interior, vec != 0, s[b ^ 1]);
      cp_async_commit();
    }
    double sad = 0.0;
    blur_diff(s[b], r0, c0, lane, taps, rows, cols, f > first, prev, sad);
    sad = warp_sum(sad);
    if (lane == 0) red[b][warp] = sad;
  }
  __syncthreads();
  if (threadIdx.x == 0 && f1 - 1 > first)
    write_partial(red[(f1 - 1 - first) & 1], part, f1 - 1, ntiles, tile);
}

// sad[n] = f32(sum of frame n's partials, in tile order) / f32(H*W).
__global__ void __launch_bounds__(kThreads)
motion_finish_kernel(const double* __restrict__ part, int ntiles, float hw,
                     float* __restrict__ sad) {
  const int n = blockIdx.x;
  double a = 0.0;
  for (int i = threadIdx.x; i < ntiles; i += kThreads)
    a += part[static_cast<size_t>(n) * ntiles + i];
  a = block_sum(a);
  if (threadIdx.x == 0) sad[n] = __fdiv_rn(static_cast<float>(a), hw);
}

}  // namespace

extern "C" {

// Partials per frame for an (h, w) plane (the wrapper sizes its scratch).
int pqa2_motion_f32_tiles(int h, int w) {
  return ((w + TW - 1) / TW) * ((h + TH - 1) / TH);
}

// frames (n, h, w) f32; taps 5 f32 in host memory; run: the most frames a
// block walks (the frames split evenly into ceil(n / run) runs); part
// scratch n * pqa2_motion_f32_tiles(h, w) doubles; sad (n,) f32 out.
int pqa2_motion_sad_f32(const float* frames, int n, int h, int w, const float* taps, int run,
                        double* part, float* sad, cudaStream_t stream) {
  if (h <= HALF || w <= HALF || n < 1 || run < 1 || !taps)
    return static_cast<int>(cudaErrorInvalidValue);
  MotionTaps t;
  for (int k = 0; k < K; ++k) t.t[k] = taps[k];
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (n + run - 1) / run);
  motion_sad_f32_kernel<<<grid, kThreads, 0, stream>>>(frames, n, h, w, vec, t, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  motion_finish_kernel<<<n, kThreads, 0, stream>>>(
      part, static_cast<int>(grid.x * grid.y), static_cast<float>(static_cast<double>(h) * w),
      sad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
