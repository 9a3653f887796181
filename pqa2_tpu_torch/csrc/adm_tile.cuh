// The tiling shared by the two fused ADM level kernels (adm_int.cu: integer,
// adm.cu: f32). One block owns TH x TW band pixels of one frame and computes
// everything of the level for them in shared memory:
//
//   * the row pass (along H) of the db2 DWT for the tile's band rows plus a
//     one-band halo, at every input column the column pass reads: each task
//     slides a 4-tap window down one input column of one plane, reading the
//     plane once (L2 serves the neighbouring tiles' overlap), and writes
//     the low- and high-pass rows into shared memory;
//   * the column pass at each slot of the tile plus its halo, straight into
//     registers: a (tile pixels only, stored: the next level needs the whole
//     plane), h, v, d of both planes, then decoupling, the CSF and the
//     threshold's term, once per pixel;
//   * after one barrier, each tile pixel of the trimmed core reads its 3x3
//     threshold neighbourhood from shared memory and is pooled.
//
// Band positions outside the plane mirror symmetrically (edge repeated,
// golden/filters.py:symmetric_index) into it; mirrored positions lie in the
// block's own row-pass output, so no block reads another's bands.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace pqa2 {
namespace admtile {

constexpr int TW = 61;               // band columns per block
constexpr int TH = 16;               // band rows per block
constexpr int RH = TH + 2;           // band rows of the row pass: the tile and its halo
constexpr int SW = 2 * TW + 6;       // input columns the column pass reads (128)
constexpr int RG = RH / 2;           // band rows per row-pass task: two tasks per column
constexpr int HW = TW + 2;           // band columns of the tile and its halo
constexpr int KP = TH / 4;           // tile slots per thread: 64 lanes x 4 row groups
constexpr int NHALO = RH * HW - TH * TW;  // halo slots, one per thread

// Blocks per SM the register budget must allow: 4 blocks of 256 threads
// (64 registers a thread) keep the row pass's loads of one block in flight
// while others compute; the shared memory (41.8 KB integer, 50.5 KB f32)
// allows them. On the H100 this ran faster than 1-3 blocks (74-86
// registers), for both kernels.
constexpr int kMinBlocks = 4;

static_assert(2 * 2 * SW == 2 * kThreads, "the row pass is two full rounds of the block");
static_assert(RH % 2 == 0 && TW <= 64 && TH * 64 == KP * kThreads && NHALO <= kThreads,
              "slot layout");

struct Geometry {
  int H, W;      // the level's input plane
  int H2, W2;    // its bands
  int i0, j0;    // the tile's first band row and column
  int th, tw;    // trims of the pooled core
  bool pool;     // the tile meets the pooled core
};

__device__ __forceinline__ Geometry geometry(int H, int W, int th, int tw) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.H2 = (H + 1) / 2;
  g.W2 = (W + 1) / 2;
  g.i0 = blockIdx.y * TH;
  g.j0 = blockIdx.x * TW;
  g.th = th;
  g.tw = tw;
  g.pool = g.i0 < g.H2 - th && g.i0 + TH > th && g.j0 < g.W2 - tw && g.j0 + TW > tw;
  return g;
}

// Slots are (ly, lx) in the frame of the tile and its halo: band position
// (i0 - 1 + ly, j0 - 1 + lx). Tile slot k of this thread: a warp covers 32
// neighbouring columns of one row. Lanes past TW own no tile slot.
__device__ __forceinline__ bool tile_slot(int k, int& ly, int& lx) {
  lx = 1 + (threadIdx.x & 63);
  ly = 1 + (threadIdx.x >> 6) + 4 * k;
  return (threadIdx.x & 63) < TW;
}

// Halo slot t < NHALO: the top row, the bottom row, the left and the right
// column.
__device__ __forceinline__ void halo_slot(int t, int& ly, int& lx) {
  if (t < 2 * HW) {
    ly = t < HW ? 0 : RH - 1;
    lx = t < HW ? t : t - HW;
  } else {
    t -= 2 * HW;
    ly = 1 + (t < TH ? t : t - TH);
    lx = t < TH ? 0 : HW - 1;
  }
}

// A pixel of the pooled core: its cube sums are taken.
__device__ __forceinline__ bool pooled(const Geometry& g, int i, int j) {
  return i >= g.th && i < g.H2 - g.th && j >= g.tw && j < g.W2 - g.tw;
}

// A pixel the pooled core's 3x3 thresholds read.
__device__ __forceinline__ bool thresholded(const Geometry& g, int i, int j) {
  return i >= g.th - 1 && i <= g.H2 - g.th && j >= g.tw - 1 && j <= g.W2 - g.tw;
}

// Where slot (ly, lx) reads its bands, its position mirrored into the
// plane: the row of the row pass's output and the offset of the first of
// the four input columns its column taps read.
__device__ __forceinline__ void band_source(const Geometry& g, int ly, int lx, int& rr,
                                            int& co) {
  rr = symmetric_idx(g.i0 - 1 + ly, g.H2) - g.i0 + 1;
  co = 2 * (symmetric_idx(g.j0 - 1 + lx, g.W2) - g.j0) + 2;
}

// The four values one column tap set reads, at co (even) of a row of the
// row pass's output: two 8-byte shared loads, conflict-free across a warp.
template <typename V>
struct Quad {
  V x0, x1, x2, x3;
};

template <typename V>
__device__ __forceinline__ Quad<V> quad_at(const V* row, int co) {
  typedef typename std::conditional<std::is_same<V, float>::value, float2, int2>::type V2;
  const V2 a = *reinterpret_cast<const V2*>(row + co);
  const V2 b = *reinterpret_cast<const V2*>(row + co + 2);
  return {a.x, a.y, b.x, b.y};
}

// The row pass of both planes (ref, dist; (n, H, W) of In) into lo/hi
// [plane][RH][SW] of V: row rr holds band row i0 - 1 + rr at input columns
// 2*j0 - 3 .. 2*j0 + 2*TW + 2 (mirrored into the plane). filter(high, x0..x3)
// is one output of the 1-D pass; the high-pass rows are needed only where
// the tile pools. Rows of band positions outside the plane are computed and
// never read.
template <typename V, typename In, typename Filter>
__device__ __forceinline__ void row_pass(const Geometry& g, const In* __restrict__ ref,
                                         const In* __restrict__ dist, V (*lo)[RH][SW],
                                         V (*hi)[RH][SW], Filter filter) {
  constexpr int NX = 2 * RG + 2;
  for (int task = threadIdx.x; task < 4 * SW; task += kThreads) {
    const int c = task % SW, grp = (task / SW) & 1, pl = task / (2 * SW);
    const In* s = (pl ? dist : ref) + static_cast<size_t>(blockIdx.z) * g.H * g.W +
                  symmetric_idx(2 * g.j0 - 3 + c, g.W);
    const int r0 = 2 * (g.i0 - 1 + grp * RG) - 1;  // first input row of the task
    V x[NX];
    if (r0 >= 0 && r0 + NX <= g.H) {
      const In* p = s + static_cast<size_t>(r0) * g.W;
#pragma unroll
      for (int k = 0; k < NX; ++k) x[k] = static_cast<V>(__ldg(p + static_cast<size_t>(k) * g.W));
    } else {
#pragma unroll
      for (int k = 0; k < NX; ++k)
        x[k] = static_cast<V>(__ldg(s + static_cast<size_t>(symmetric_idx(r0 + k, g.H)) * g.W));
    }
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      lo[pl][grp * RG + r][c] = filter(false, x[2 * r], x[2 * r + 1], x[2 * r + 2], x[2 * r + 3]);
      if (g.pool)
        hi[pl][grp * RG + r][c] = filter(true, x[2 * r], x[2 * r + 1], x[2 * r + 2], x[2 * r + 3]);
    }
  }
}

}  // namespace admtile
}  // namespace pqa2
