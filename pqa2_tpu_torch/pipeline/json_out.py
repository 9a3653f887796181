"""libvmaf-compatible JSON output (port of pqa2_tpu/pipeline/json_out.py).

For the same ``ClipScores`` the bytes are identical to the JAX package's
writer except the ``"version"`` string.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from pqa2_tpu_torch import __version__
from pqa2_tpu_torch.pipeline.scoring import ClipScores, bootstrap_ci
from pqa2_tpu_torch.utils.profiling import span


def _metric_key(name: str, integer_features: bool) -> str:
    """libvmaf prefixes feature metrics with integer_/float_ by extractor."""
    if name in ("vmaf",) or name.startswith("vmaf_"):
        return name
    prefix = "integer_" if integer_features else "float_"
    return prefix + name


def clip_scores_to_json(
    scores: ClipScores,
    *,
    fps: Optional[float] = None,
    integer_features: Optional[bool] = None,
) -> Dict:
    """ClipScores -> libvmaf-log-shaped dict (frames + pooled_metrics)."""
    if integer_features is None:
        integer_features = scores.uses_integer_features
    n = scores.n_frames
    feat_keys = {k: _metric_key(k, integer_features) for k in scores.features}
    if scores.bootstrap is not None:
        ci_lo, ci_hi, ci_std = bootstrap_ci(scores.bootstrap)
        bagging = scores.bootstrap.mean(axis=0)
    frames = []
    for i in range(n):
        metrics = {feat_keys[k]: round(float(v[i]), 6)
                   for k, v in scores.features.items()}
        metrics["vmaf"] = round(float(scores.vmaf[i]), 6)
        if scores.bootstrap is not None:
            metrics["vmaf_bagging"] = round(float(bagging[i]), 6)
            metrics["vmaf_stddev"] = round(float(ci_std[i]), 6)
            metrics["vmaf_ci_p95_lo"] = round(float(ci_lo[i]), 6)
            metrics["vmaf_ci_p95_hi"] = round(float(ci_hi[i]), 6)
        if scores.psnr is not None:
            for p in ("y", "u", "v"):
                metrics[f"psnr_{p}"] = round(float(scores.psnr[f"psnr_{p}"][i]), 6)
        if scores.ssim is not None:
            metrics["float_ssim"] = round(float(scores.ssim["ssim_all"][i]), 6)
        frames.append({"frameNum": i * scores.frame_step,
                       "metrics": _json_safe(metrics)})

    pooled = {
        name: {m: round(_finite(v), 6) for m, v in per.items()}
        for name, per in scores.pooled_all().items()
    }
    pooled = {feat_keys.get(k, k): v for k, v in pooled.items()}

    return {
        "version": f"pqa2_tpu_torch {__version__}",
        "params": {"model": scores.model_name, "qualityWidth": None,
                   "qualityHeight": None},
        "fps": round(fps, 2) if fps else None,
        "frames": frames,
        "pooled_metrics": pooled,
    }


def _finite(v: float) -> float:
    if isinstance(v, float) and not np.isfinite(v):
        return 1e9 if v > 0 else -1e9
    return float(v)


def _json_safe(metrics: Dict) -> Dict:
    return {k: _finite(v) for k, v in metrics.items()}


def write_vmaf_json(
    scores: ClipScores,
    path: str,
    *,
    fps: Optional[float] = None,
    integer_features: Optional[bool] = None,
) -> Dict:
    """Write the libvmaf-schema log to ``path`` and return its dict (span
    ``app.write_vmaf_json``)."""
    with span("app.write_vmaf_json"):
        obj = clip_scores_to_json(scores, fps=fps, integer_features=integer_features)
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)
        return obj
