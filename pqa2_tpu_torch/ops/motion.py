"""Float motion / motion2 — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/motion.py``: ``motion2[t] = min(sad(t-1, t),
sad(t, t+1))`` on 5-tap Gaussian-blurred reference luma, reflect borders.
:func:`motion_sad_plain` is the plain twin of kernel 7 (``csrc/motion.cu``,
wrapper ``ops/cuda_motion.py:motion_sad``), which replaces the TPU's
``motion_sad_pallas``: the per-frame mean |blur(f[n]) - blur(f[n-1])|, 0 at
n = 0, a sum divided by H*W as pqa2_tpu/ops/pallas_motion.py:153 does.

:func:`features_from_sad_prev` is the halo contract shared with the
integer family (``ops/motion_int.py`` imports it from here).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pqa2_tpu_torch.golden.filters import motion_filter
from pqa2_tpu_torch.ops.filters import sep_filter_batched

_TAPS = motion_filter()


def blur_batched(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W) luma -> 5-tap Gaussian blur (the motion pre-filter), f32."""
    return sep_filter_batched(frames.float(), _TAPS)


def sad_pairs(blurred_a: torch.Tensor, blurred_b: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference per frame pair: (N,H,W),(N,H,W) -> (N,)."""
    return (blurred_a - blurred_b).abs().mean(dim=(-2, -1))


def motion_sad_plain(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W) f32 luma -> (N,) f32 ``sum |blur(f[n]) - blur(f[n-1])| /
    (H*W)``, 0 at n = 0 (frame 0 pairs with itself): kernel 7's contract."""
    n, h, w = frames.shape
    b = blur_batched(frames)
    sad = torch.zeros(n, dtype=torch.float32, device=frames.device)
    if n > 1:
        sad[1:] = (b[1:] - b[:-1]).abs().sum(dim=(-2, -1)) / float(h * w)
    return sad


def features_from_sad_prev(
    sad_prev: torch.Tensor,
    n: int,
    has_prev: bool = False,
    has_next: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n-1,) consecutive-frame SADs -> (motion, motion2) for core frames
    (pqa2_tpu/ops/motion.py:55, same halo contract).

    With halos, ``n`` counts the extra leading frame (has_prev) and the
    extra trailing frame (has_next); at a true clip start motion = 0 and
    motion2 = 0, at a true clip end the forward term is absent."""
    lead = 1 if has_prev else 0
    if has_prev:
        motion = sad_prev[lead - 1: (n - 2 if has_next else n - 1)]
    else:
        motion = torch.cat([torch.zeros(1, dtype=sad_prev.dtype,
                                        device=sad_prev.device),
                            sad_prev[: n - 2 if has_next else n - 1]])
    n_core = n - lead - (1 if has_next else 0)
    fwd_valid = n_core - (0 if has_next else 1)
    fwd = sad_prev[lead: lead + max(fwd_valid, 0)]
    if fwd_valid < n_core:
        fwd = torch.cat([fwd, torch.full((n_core - fwd_valid,), float("inf"),
                                         dtype=sad_prev.dtype,
                                         device=sad_prev.device)])
    motion2 = torch.minimum(motion, fwd)
    if not has_prev:
        motion2 = motion2.clone()
        motion2[0] = 0.0
    return motion, motion2


def motion_features(
    frames: torch.Tensor,
    has_prev: bool = False,
    has_next: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) reference luma -> (motion, motion2), each (N_core,) f32
    (pqa2_tpu/ops/motion.py:36)."""
    blurred = blur_batched(frames)
    sad_prev = sad_pairs(blurred[1:], blurred[:-1])
    return features_from_sad_prev(sad_prev, frames.shape[0],
                                  has_prev=has_prev, has_next=has_next)
