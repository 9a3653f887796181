"""Clip-level results and pooling (numpy only).

Port of the framework-free parts of ``pqa2_tpu/pipeline/scoring.py``:
``ClipScores`` (:33), ``pool_metric`` (:79), ``bootstrap_ci`` (:95) and
``iter_chunks`` (:130). The JAX module cannot be imported without JAX, so
these live here; they are value-for-value the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

DEFAULT_CHUNK_SIZE = 32

POOL_METHODS = ("mean", "min", "max", "harmonic_mean")


@dataclasses.dataclass
class ClipScores:
    """Per-frame metrics + model metadata for one scored clip."""

    model_name: str
    feature_names: tuple
    features: Dict[str, np.ndarray]  # per-frame feature arrays (N,)
    vmaf: np.ndarray  # (N,) per-frame VMAF scores
    bootstrap: Optional[np.ndarray] = None  # (M, N) per-sub-model scores
    psnr: Optional[Dict[str, np.ndarray]] = None
    ssim: Optional[Dict[str, np.ndarray]] = None
    # Native PSNR peak (255 for 8-bit, 1023 for 10-bit, ...): the scale the
    # stored mse_* values live on.
    peak: float = 255.0
    # Whether the model was trained on the integer_* feature extractors
    # (drives the metric key prefix in the libvmaf-schema JSON).
    uses_integer_features: bool = True
    # Distance between scored frames in source-frame indices (n_subsample).
    frame_step: int = 1

    @property
    def n_frames(self) -> int:
        return int(self.vmaf.shape[0])

    def pooled_all(self) -> Dict[str, Dict[str, float]]:
        """libvmaf-style pooled_metrics: {metric: {min/max/mean/harmonic_mean}}."""
        metrics = {"vmaf": self.vmaf, **self.features}
        if self.bootstrap is not None:
            lo, hi, stddev = bootstrap_ci(self.bootstrap)
            metrics["vmaf_bagging"] = self.bootstrap.mean(axis=0)
            metrics["vmaf_stddev"] = stddev
            metrics["vmaf_ci_p95_lo"] = lo
            metrics["vmaf_ci_p95_hi"] = hi
        return {
            name: {m: pool_metric(vals, m) for m in POOL_METHODS}
            for name, vals in metrics.items()
        }


def pool_metric(values: np.ndarray, method: str = "mean") -> float:
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return 0.0
    if method == "mean":
        return float(values.mean())
    if method == "min":
        return float(values.min())
    if method == "max":
        return float(values.max())
    if method == "harmonic_mean":
        # libvmaf's harmonic mean shifts by 1 to tolerate zeros.
        return float(values.size / np.sum(1.0 / (1.0 + values)) - 1.0)
    raise ValueError(f"unknown pool method {method!r}")


def bootstrap_ci(scores: np.ndarray, alpha: float = 0.95):
    """(M, N) bootstrap sub-model scores -> (ci_lo, ci_hi, stddev) per frame:
    mean +/- 1.96 * stddev of models 1..M-1 (model 0 is the primary)."""
    boot = scores[1:] if scores.shape[0] > 1 else scores
    mean = boot.mean(axis=0)
    std = boot.std(axis=0, ddof=1) if boot.shape[0] > 1 else np.zeros_like(mean)
    z = 1.959963984540054
    return mean - z * std, mean + z * std, std


def iter_chunks(n: int, chunk_size: int):
    """Yield (start, stop, has_prev, has_next) chunk bounds over n frames."""
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        yield start, stop, start > 0, stop < n
