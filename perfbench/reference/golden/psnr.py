# Frozen copy of the NumPy oracle golden/psnr.py of the port, imports pointed
# at this package: the benchmark's reference imports nothing of the program.
"""PSNR — oracle matching ffmpeg's psnr filter semantics.

The reference runs ``ffmpeg -lavfi psnr=stats_file=...`` as a separate pass
(app/vmaf_analyzer.py:1027-1045) and regex-parses the "average" line of the
log (app/vmaf_analyzer.py:693-711). Semantics reproduced here:

  * per-plane MSE over uint samples; psnr = 10*log10(MAX^2 / mse)
  * mse_avg pools the *summed squared error* over all planes divided by the
    total sample count (so chroma subsampling weights itself naturally)
  * mse == 0 -> psnr = inf (ffmpeg prints "inf")
  * clip-level "average" PSNR is computed from accumulated MSE across frames,
    not by averaging per-frame PSNR values
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _psnr_from_mse(mse: float, peak: float) -> float:
    if mse <= 0.0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def psnr_frame(ref: Dict[str, np.ndarray], dist: Dict[str, np.ndarray],
               max_value: int = 255) -> Dict[str, float]:
    """Per-frame PSNR stats for planar YUV dicts. Returns mse_*/psnr_* keys."""
    out: Dict[str, float] = {}
    total_sse = 0.0
    total_n = 0
    for plane in ("y", "u", "v"):
        r = ref[plane].astype(np.float64)
        d = dist[plane].astype(np.float64)
        sse = float(np.sum((r - d) ** 2))
        n = r.size
        mse = sse / n
        out[f"mse_{plane}"] = mse
        out[f"psnr_{plane}"] = _psnr_from_mse(mse, max_value)
        total_sse += sse
        total_n += n
    mse_avg = total_sse / total_n
    out["mse_avg"] = mse_avg
    out["psnr_avg"] = _psnr_from_mse(mse_avg, max_value)
    return out


def psnr_pooled(per_frame: Sequence[Dict[str, float]],
                max_value: int = 255) -> Dict[str, float]:
    """Clip-level stats the way ffmpeg's summary line computes them."""
    out: Dict[str, float] = {}
    for key in ("y", "u", "v", "avg"):
        mse = float(np.mean([f[f"mse_{key}"] for f in per_frame]))
        out[f"psnr_{key}"] = _psnr_from_mse(mse, max_value)
    vals = [f["psnr_avg"] for f in per_frame]
    finite = [v for v in vals if np.isfinite(v)]
    out["psnr_min"] = float(min(vals)) if vals else 0.0
    out["psnr_max"] = float(max(finite)) if finite else float("inf")
    return out
