"""Batched separable filtering and the db2 DWT — the plain PyTorch versions.

Counterpart of ``pqa2_tpu/ops/filters.py``: the building blocks of the float
VIF, motion and ADM features over frame batches ``(N, H, W)``, f32. Each
filter is a sum of shifted slices times one tap, in tap order, every
product and sum rounded to f32 on its own, so the CUDA kernels
(``csrc/vif.cu``, ``csrc/motion.cu``, ``csrc/adm.cu``) reproduce these
values bit for bit. Taps come from ``pqa2_tpu_torch.golden.filters`` as
float64 and enter the arithmetic rounded to f32, as JAX's weak-typed
scalars do.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pqa2_tpu_torch.golden.filters import DB2_HI, DB2_LO, reflect_index, symmetric_index


def f32_taps(taps) -> list:
    """float64 taps -> Python floats holding their f32 values."""
    return [float(v) for v in np.asarray(taps, dtype=np.float32)]


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _filter_axis(x: torch.Tensor, taps, dim: int, mode: str) -> torch.Tensor:
    """Correlate along ``dim`` with mirrored borders: 'reflect' mirrors
    without repeating the edge (VIF/motion), 'symmetric' repeats it (ADM)."""
    k = len(taps)
    half = k // 2
    n = x.shape[dim]
    index_fn = reflect_index if mode == "reflect" else symmetric_index
    xp = x.index_select(dim, _index(index_fn(np.arange(-half, n + half), n), x.device))
    out = None
    for t, c in enumerate(f32_taps(taps)):
        term = xp.narrow(dim, t, n) * c
        out = term if out is None else out + term
    return out


def sep_filter_batched(x: torch.Tensor, taps, mode: str = "reflect") -> torch.Tensor:
    """Separable 2-D correlation over (N, H, W): the column pass (along H)
    first, then the row pass (along W), as pqa2_tpu/ops/filters.py:44."""
    return _filter_axis(_filter_axis(x, taps, -2, mode), taps, -1, mode)


def _dwt1d_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Filter and decimate along ``dim``: ``out[i] = sum_f taps[f] *
    x[sym(2i-1+f)]`` with symmetric borders (pqa2_tpu/ops/filters.py:57)."""
    n = x.shape[dim]
    n2 = (n + 1) // 2
    out = None
    for t, c in enumerate(f32_taps(taps)):
        idx = _index(symmetric_index(2 * np.arange(n2) - 1 + t, n), x.device)
        term = x.index_select(dim, idx) * c
        out = term if out is None else out + term
    return out


def dwt2_batched(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One db2 DWT level over (N, H, W) -> dict(a, h, v, d), each
    (N, ceil(H/2), ceil(W/2)); h is the row-highpass band
    (pqa2_tpu/ops/filters.py:76)."""
    lo_r = _dwt1d_axis(x, DB2_LO, -2)
    hi_r = _dwt1d_axis(x, DB2_HI, -2)
    return {
        "a": _dwt1d_axis(lo_r, DB2_LO, -1),
        "v": _dwt1d_axis(lo_r, DB2_HI, -1),
        "h": _dwt1d_axis(hi_r, DB2_LO, -1),
        "d": _dwt1d_axis(hi_r, DB2_HI, -1),
    }
