# Copy of pqa2_tpu/golden/vif.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""VIF (Visual Information Fidelity), 4-scale pixel-domain variant — oracle.

The features ``vif_scale0..3`` consumed by every shipped VMAF model
(models/vmaf_v0.6.1.json feature_dict; enabled in the reference via the
libvmaf lavfi filter, app/vmaf_analyzer.py:406). Per scale s:

  1. (s > 0) blur ref/dist with the scale-s Gaussian window and decimate 2x
  2. local moments through the same window:
       mu1, mu2, E[x^2], E[y^2], E[xy] -> sigma1^2, sigma2^2, sigma12
  3. per-pixel information accumulation:
       sigma1^2 >= sigma_nsq (=2):
           g     = sigma12 / sigma1^2          (0 if sigma12 <= 0)
           sv^2  = sigma2^2 - g * sigma12      (unclamped gain)
           g     = min(g, vif_enhn_gain_limit) (NEG models)
           num  += log2(1 + g^2 * sigma1^2 / (sv^2 + sigma_nsq))
           den  += log2(1 + sigma1^2 / sigma_nsq)
       else (flat reference region):
           num  += 1 - sigma2^2 * sigma_max_inv   (sigma_max_inv = 4/255^2)
           den  += 1
  4. vif_scale{s} = num / den

The flat-region branch mirrors libvmaf's integer-path statistic (the default
``VMAF_integer_feature_vif*`` extractors); ``variant="classic"`` selects the
older float-path statistic for the float models. See docs/CALIBRATION.md.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pqa2_tpu_torch.golden.filters import sep_filter2d, vif_filter

SIGMA_NSQ = 2.0
SIGMA_MAX_INV = 4.0 / (255.0 * 255.0)
EPS = 1e-10


def _vif_statistic_default(
    mu1, mu2, xx, yy, xy, gain_limit: float
):
    sigma1_sq = np.maximum(xx - mu1 * mu1, 0.0)
    sigma2_sq = np.maximum(yy - mu2 * mu2, 0.0)
    sigma12 = xy - mu1 * mu2

    log_branch = sigma1_sq >= SIGMA_NSQ

    g = np.where(sigma12 > 0.0, sigma12 / np.maximum(sigma1_sq, EPS), 0.0)
    # sv uses the UNclamped gain; the NEG enhancement limit only caps the
    # gain credited to the numerator (libvmaf order — the clamp sits right
    # before num_val in vif.c; fixed round 3, was clamp-before).
    sv_sq = np.maximum(sigma2_sq - g * sigma12, 0.0)
    g = np.minimum(g, gain_limit)
    num_log = np.log2(1.0 + g * g * sigma1_sq / (sv_sq + SIGMA_NSQ))
    den_log = np.log2(1.0 + sigma1_sq / SIGMA_NSQ)

    num_flat = 1.0 - sigma2_sq * SIGMA_MAX_INV
    num = np.where(log_branch, num_log, num_flat)
    den = np.where(log_branch, den_log, 1.0)
    return float(num.sum()), float(den.sum())


def _vif_statistic_classic(mu1, mu2, xx, yy, xy, gain_limit: float):
    """Older float-path statistic (vif_tools-style g/sv_sq epsilon cascade)."""
    sigma1_sq = xx - mu1 * mu1
    sigma2_sq = yy - mu2 * mu2
    sigma12 = xy - mu1 * mu2

    g = sigma12 / (sigma1_sq + EPS)
    sv_sq = sigma2_sq - g * sigma12

    low1 = sigma1_sq < EPS
    g = np.where(low1, 0.0, g)
    sv_sq = np.where(low1, sigma2_sq, sv_sq)
    sigma1_sq = np.where(low1, 0.0, sigma1_sq)

    low2 = sigma2_sq < EPS
    g = np.where(low2, 0.0, g)
    sv_sq = np.where(low2, 0.0, sv_sq)

    neg = g < 0.0
    sv_sq = np.where(neg, sigma2_sq, sv_sq)
    g = np.where(neg, 0.0, g)
    sv_sq = np.maximum(sv_sq, EPS)
    g = np.minimum(g, gain_limit)

    num = np.log2(1.0 + g * g * sigma1_sq / (sv_sq + SIGMA_NSQ))
    den = np.log2(1.0 + sigma1_sq / SIGMA_NSQ)
    return float(num.sum()), float(den.sum())


def vif_features(
    ref: np.ndarray,
    dist: np.ndarray,
    gain_limit: float = np.inf,
    variant: str = "default",
) -> List[float]:
    """Per-scale VIF scores [vif_scale0..3] for one luma pair (float64)."""
    stat = _vif_statistic_default if variant == "default" else _vif_statistic_classic
    ref = ref.astype(np.float64)
    dist = dist.astype(np.float64)
    scores = []
    for scale in range(4):
        taps = vif_filter(scale)
        if scale > 0:
            ref = sep_filter2d(ref, taps)[::2, ::2]
            dist = sep_filter2d(dist, taps)[::2, ::2]
        mu1 = sep_filter2d(ref, taps)
        mu2 = sep_filter2d(dist, taps)
        xx = sep_filter2d(ref * ref, taps)
        yy = sep_filter2d(dist * dist, taps)
        xy = sep_filter2d(ref * dist, taps)
        num, den = stat(mu1, mu2, xx, yy, xy, gain_limit)
        scores.append(num / den if den > 0 else 1.0)
    return scores
