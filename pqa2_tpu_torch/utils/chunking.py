"""Chunk padding (port of pqa2_tpu/utils/chunking.py:pad_frames)."""

from __future__ import annotations

import torch


def pad_frames(x: torch.Tensor, size: int) -> torch.Tensor:
    """Pad axis 0 of an (N, ...) tensor up to ``size`` by repeating the
    last frame; the input is returned unchanged when N >= size."""
    n = x.shape[0]
    if n >= size:
        return x
    return torch.cat([x, x[-1:].expand(size - n, *x.shape[1:])])
