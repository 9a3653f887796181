"""Integer fixed-point motion — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/motion_int.py``; the halo semantics are
:func:`pqa2_tpu_torch.ops.motion.features_from_sad_prev`. The blur follows
``pqa2_tpu/golden/motion_int.py``: Q16 5-tap window, vertical
``>> (8 + in_q)``, horizontal ``>> 16``, reflect borders, Q8 planes. The
SAD between consecutive blurred frames is an exact int64; it is the value
the CUDA kernel (``csrc/vif_int.cu``, launched by ``ops/cuda_vif_int.py`` at
scale 0) must reproduce.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pqa2_tpu_torch.golden.fixedpoint import MOTION_FILTER_Q16
from pqa2_tpu_torch.ops.motion import features_from_sad_prev
from pqa2_tpu_torch.ops.vif_int import _filt, to_native_grid


def blur_int_batched(codes: torch.Tensor, in_q: int) -> torch.Tensor:
    """(N, H, W) integer codes (Q{in_q}) -> int64 Q8 blurred planes."""
    x = codes.long()
    tmp = _filt(x, MOTION_FILTER_Q16, -2, 8 + in_q)
    return _filt(tmp, MOTION_FILTER_Q16, -1, 16)


def sad_pairs_int(blurred: torch.Tensor) -> torch.Tensor:
    """(N, H, W) Q8 planes -> (N-1,) int64 ``sum |b[i] - b[i-1]|``."""
    return (blurred[1:] - blurred[:-1]).abs().sum(dim=(-2, -1))


def motion_from_sad(sad: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Exact integer SADs -> mean |diff| in pixel units, f32.

    Evaluated in float64 and rounded once (the oracle's value; the JAX
    package's f32 hi/lo fold differs by ~6e-8 relative)."""
    return (sad.double() / (w * h * 256.0)).float()


def motion_features_int(
    frames: torch.Tensor,
    has_prev: bool = False,
    has_next: bool = False,
    bit_depth: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) reference luma -> (motion, motion2) f32 for core frames,
    plain version (pqa2_tpu/ops/motion_int.py:42)."""
    codes, in_q = to_native_grid(frames, bit_depth)
    sad = sad_pairs_int(blur_int_batched(codes, in_q))
    return features_from_sad_prev(
        motion_from_sad(sad, frames.shape[-2], frames.shape[-1]),
        frames.shape[0], has_prev=has_prev, has_next=has_next)
