"""Float VIF over four scales — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/vif.py`` (the XLA twin of the TPU's
``vif_scale_pallas``) and the plain twin of kernel 5 (``csrc/vif.cu``,
wrapper ``ops/cuda_vif.py:vif_scale``). Per scale, in f32: the five
Gaussian moments (column pass, then row pass, reflect borders), the
per-pixel statistic — ``default`` (the integer-path form, flat regions
counted apart) or ``classic`` (the float models' form) — with the optional
NEG gain limit, the per-frame ``num``/``den`` sums, and the next scale's
input, blurred with the next scale's taps and decimated to the even rows and
columns.

Every per-pixel operation is one f32 rounding in the JAX package's order,
so the kernel's filtered and decimated planes equal these bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pqa2_tpu_torch.golden.filters import vif_filter
from pqa2_tpu_torch.golden.vif import EPS, SIGMA_MAX_INV, SIGMA_NSQ
from pqa2_tpu_torch.ops.filters import sep_filter_batched


def _moments(ref, dist, taps):
    mu1 = sep_filter_batched(ref, taps)
    mu2 = sep_filter_batched(dist, taps)
    xx = sep_filter_batched(ref * ref, taps)
    yy = sep_filter_batched(dist * dist, taps)
    xy = sep_filter_batched(ref * dist, taps)
    return mu1, mu2, xx, yy, xy


def _limit(g: torch.Tensor, gain_limit: float) -> torch.Tensor:
    """min(g, gain_limit); an infinite limit is no clamp at all
    (pqa2_tpu/ops/pallas_vif.py:61)."""
    return torch.clamp(g, max=gain_limit) if math.isfinite(gain_limit) else g


def _statistic_default(mu1, mu2, xx, yy, xy, gain_limit: float):
    """Integer-path statistic -> per-frame (num, den) sums
    (pqa2_tpu/ops/vif.py:35)."""
    sigma1_sq = torch.clamp(xx - mu1 * mu1, min=0.0)
    sigma2_sq = torch.clamp(yy - mu2 * mu2, min=0.0)
    sigma12 = xy - mu1 * mu2
    log_branch = sigma1_sq >= SIGMA_NSQ
    g = torch.where(sigma12 > 0.0, sigma12 / torch.clamp(sigma1_sq, min=EPS), 0.0)
    # NEG clamp after sv (libvmaf order; golden/vif.py).
    sv_sq = torch.clamp(sigma2_sq - g * sigma12, min=0.0)
    g = _limit(g, gain_limit)
    num_log = torch.log2(1.0 + g * g * sigma1_sq / (sv_sq + SIGMA_NSQ))
    den_log = torch.log2(1.0 + sigma1_sq / SIGMA_NSQ)
    num = torch.where(log_branch, num_log, 1.0 - sigma2_sq * SIGMA_MAX_INV)
    den = torch.where(log_branch, den_log, 1.0)
    return num.sum(dim=(-2, -1)), den.sum(dim=(-2, -1))


def _statistic_classic(mu1, mu2, xx, yy, xy, gain_limit: float):
    """Float-path statistic -> per-frame (num, den) sums
    (pqa2_tpu/ops/vif.py:56)."""
    sigma1_sq = xx - mu1 * mu1
    sigma2_sq = yy - mu2 * mu2
    sigma12 = xy - mu1 * mu2
    g = sigma12 / (sigma1_sq + EPS)
    sv_sq = sigma2_sq - g * sigma12
    low1 = sigma1_sq < EPS
    g = torch.where(low1, 0.0, g)
    sv_sq = torch.where(low1, sigma2_sq, sv_sq)
    sigma1_sq = torch.where(low1, 0.0, sigma1_sq)
    low2 = sigma2_sq < EPS
    g = torch.where(low2, 0.0, g)
    sv_sq = torch.where(low2, 0.0, sv_sq)
    neg = g < 0.0
    sv_sq = torch.where(neg, sigma2_sq, sv_sq)
    g = torch.where(neg, 0.0, g)
    sv_sq = torch.clamp(sv_sq, min=EPS)
    g = _limit(g, gain_limit)
    num = torch.log2(1.0 + g * g * sigma1_sq / (sv_sq + SIGMA_NSQ))
    den = torch.log2(1.0 + sigma1_sq / SIGMA_NSQ)
    return num.sum(dim=(-2, -1)), den.sum(dim=(-2, -1))


_STATISTICS = {"default": _statistic_default, "classic": _statistic_classic}
VARIANTS = tuple(_STATISTICS)


def decimate_next(x: torch.Tensor, scale: int) -> torch.Tensor:
    """The input of scale ``scale``: blur with its taps, keep the even rows
    and columns -> (N, ceil(H/2), ceil(W/2))."""
    return sep_filter_batched(x, vif_filter(scale))[:, ::2, ::2]


def vif_scale_plain(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    scale: int,
    gain_limit: float = float("inf"),
    variant: str = "classic",
    emit_next: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One VIF scale, the plain twin of kernel 5.

    ref/dist (N, H, W) f32 at this scale's resolution -> ``(num (N,),
    den (N,), next_ref, next_dist)``: the per-frame f32 sums of the
    statistic and, with ``emit_next``, the next scale's (N, ceil(H/2),
    ceil(W/2)) f32 inputs (else None)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown VIF variant {variant!r}")
    num, den = _STATISTICS[variant](*_moments(ref, dist, vif_filter(scale)), gain_limit)
    if not emit_next:
        return num, den, None, None
    return num, den, decimate_next(ref, scale + 1), decimate_next(dist, scale + 1)


def vif_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Per-frame vif_scale value: num / den, 1 where den is 0."""
    return torch.where(den > 0, num / den, 1.0)


def vif_features_batched(
    ref: torch.Tensor,
    dist: torch.Tensor,
    gain_limit: float = float("inf"),
    variant: str = "default",
) -> torch.Tensor:
    """(N, H, W) luma pair -> (N, 4) [vif_scale0..3] (pqa2_tpu/ops/vif.py:86)."""
    ref = ref.float()
    dist = dist.float()
    feats = []
    for scale in range(4):
        num, den, ref, dist = vif_scale_plain(ref, dist, scale=scale, gain_limit=gain_limit,
                                              variant=variant, emit_next=scale < 3)
        feats.append(vif_ratio(num, den))
    return torch.stack(feats, dim=-1)
