# Frozen copy of the NumPy oracle golden/ssim.py of the port, imports pointed
# at this package: the benchmark's reference imports nothing of the program.
"""SSIM — oracle matching ffmpeg's ssim filter (the x264 8x8-block variant).

The reference runs ``ffmpeg -lavfi ssim=stats_file=...`` as a separate pass
(app/vmaf_analyzer.py:1057-1075). ffmpeg's implementation is NOT the textbook
Gaussian-window SSIM: it computes integer sums over 4x4 blocks, then evaluates
SSIM on every overlapping 8x8 window placed on a 4-pixel grid (a 2x2 group of
4x4 blocks), averaging ((w>>2)-1)*((h>>2)-1) window results per plane:

    c1 = round(0.01^2 * 255^2 * 64)       = 416
    c2 = round(0.03^2 * 255^2 * 64 * 63)  = 235963
    for each 8x8 window (sums s1=sum(ref), s2=sum(dist),
                         ss=sum(ref^2+dist^2), s12=sum(ref*dist)):
        vars  = ss * 64 - s1^2 - s2^2
        covar = s12 * 64 - s1 * s2
        ssim += (2*s1*s2 + c1) * (2*covar + c2)
              / ((s1^2 + s2^2 + c1) * (vars + c2))

Frame "All" value = plane values weighted by sample counts (Y*4 + U + V over
6 for 4:2:0). dB form = -10*log10(1 - ssim).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)  # 416
SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 + 0.5)  # 235963


def ssim_constants(bit_depth: int = 8):
    """ffmpeg's c1/c2 from the native max code value (ssim_end1x takes
    ``max=(1<<bitdepth)-1`` for >8-bit input; 8-bit uses the macros
    above — this reproduces both)."""
    mx = (1 << bit_depth) - 1
    c1 = int(0.01 * 0.01 * mx * mx * 64 + 0.5)
    c2 = int(0.03 * 0.03 * mx * mx * 64 * 63 + 0.5)
    return c1, c2


def _block_sums(plane: np.ndarray):
    """Sums over non-overlapping 4x4 blocks. Returns s1-style arrays
    (h//4, w//4) as float64 (integer-valued for uint8 input)."""
    h4, w4 = plane.shape[0] // 4, plane.shape[1] // 4
    p = plane[: h4 * 4, : w4 * 4].astype(np.float64)
    return p.reshape(h4, 4, w4, 4).sum(axis=(1, 3))


def ssim_plane(ref: np.ndarray, dist: np.ndarray, bit_depth: int = 8) -> float:
    """Inputs are NATIVE codes at ``bit_depth`` (ffmpeg's >8-bit ssim path
    sums native 16-bit codes in int64 and scales c1/c2 with the native
    max; float64 holds those sums exactly)."""
    c1, c2 = ssim_constants(bit_depth)
    r = ref.astype(np.float64)
    d = dist.astype(np.float64)
    s1 = _block_sums(r)
    s2 = _block_sums(d)
    ss = _block_sums(r * r) + _block_sums(d * d)
    s12 = _block_sums(r * d)

    # 2x2 groups of 4x4 blocks -> overlapping 8x8 windows on a 4px grid.
    def group(a):
        return a[:-1, :-1] + a[:-1, 1:] + a[1:, :-1] + a[1:, 1:]

    fs1, fs2, fss, fs12 = group(s1), group(s2), group(ss), group(s12)
    vars_ = fss * 64.0 - fs1 * fs1 - fs2 * fs2
    covar = fs12 * 64.0 - fs1 * fs2
    num = (2.0 * fs1 * fs2 + c1) * (2.0 * covar + c2)
    den = (fs1 * fs1 + fs2 * fs2 + c1) * (vars_ + c2)
    return float(np.mean(num / den))


def ssim_db(ssim: float) -> float:
    if ssim >= 1.0:
        return float("inf")
    return float(-10.0 * np.log10(1.0 - ssim))


def ssim_frame(ref: Dict[str, np.ndarray], dist: Dict[str, np.ndarray],
               bit_depth: int = 8) -> Dict[str, float]:
    """Per-frame SSIM for planar YUV dicts: Y/U/V/All (+ dB)."""
    out: Dict[str, float] = {}
    total = 0.0
    total_w = 0
    for plane in ("y", "u", "v"):
        v = ssim_plane(ref[plane], dist[plane], bit_depth=bit_depth)
        out[f"ssim_{plane}"] = v
        w = ref[plane].size
        total += v * w
        total_w += w
    out["ssim_all"] = total / total_w
    out["ssim_db"] = ssim_db(out["ssim_all"])
    return out
