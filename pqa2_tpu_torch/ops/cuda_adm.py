"""Kernel 6 of the port: one float ADM level, ``csrc/adm.cu``.

Replaces ``adm_level_pallas`` of ``pqa2_tpu/ops/pallas_adm.py`` (its
``pl.pallas_call`` at :265, kernel body ``_make_kernel`` :52; caller
``adm_features_pallas`` :293). One fused launch per level: a block per
61x16 band tile computes the f32 db2 DWT of ref and dist in shared memory
(read with symmetric ``2i-1+f`` indexing straight from the approximation
plane), decouples each pixel once, thresholds over a one-band halo and
pools the six cube sums of the trimmed core in float64 per block; only the
next level's approximation bands go back to device memory. A fixed-order
pass adds the block partials per frame. The cbrt and stabiliser tail runs
in PyTorch (:func:`pqa2_tpu_torch.ops.adm.adm_from_level_sums`).

The wrapper computes with the plain version (``ops/adm.py``) only for CPU
tensors; for CUDA tensors it launches the kernels or raises.
``adm_level.launches`` counts calls that launched the kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pqa2_tpu_torch import _build
from pqa2_tpu_torch.golden.adm import COS_1DEG_SQ, NUM_LEVELS, csf_rfactors
from pqa2_tpu_torch.golden.filters import DB2_HI, DB2_LO
from pqa2_tpu_torch.ops.adm import _trim, adm_from_level_sums, adm_level_plain_float
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, host_taps

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LEVEL_ARGS = [_P, _P, _I, _I, _I, _P, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P]


def adm_level(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    level: int,
    gain_limit: float = 100.0,
):
    """One float ADM level. ref/dist (N, H, W) f32 contiguous approximation
    planes -> ``(sums (N, 6) f32, a_ref, a_dist)``, the contract of
    :func:`pqa2_tpu_torch.ops.adm.adm_level_plain_float`."""
    device = _check_device(ref, "ref")
    if device is None:
        return adm_level_plain_float(ref, dist, level=level, gain_limit=gain_limit)
    _build.check_tensor(ref, "ref", torch.float32, 3, device)
    _build.check_tensor(dist, "dist", torch.float32, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= level < NUM_LEVELS:
        raise ValueError(f"bad level {level}")
    n, h, w = ref.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    fh, fv, fd = csf_rfactors(level)
    with torch.cuda.device(device):
        a_ref = torch.empty((n, h2, w2), dtype=torch.float32, device=device)
        a_dist = torch.empty_like(a_ref)
        blocks = _build.function("pqa2_adm_f32_blocks", [_I, _I], device)(h2, w2)
        part = torch.empty((n, blocks, 6), dtype=torch.float64, device=device)
        sums = torch.empty((n, 6), dtype=torch.float32, device=device)
        _build.launch(
            "pqa2_adm_level_f32", _LEVEL_ARGS, _build.ptr(ref), _build.ptr(dist), n, h, w,
            host_taps("db2_f32", np.concatenate([DB2_LO, DB2_HI]).astype(np.float32),
                      ctypes.c_float),
            fh, fv, fd, gain_limit, COS_1DEG_SQ, _trim(h2), _trim(w2),
            _build.ptr(a_ref), _build.ptr(a_dist), _build.ptr(part), _build.ptr(sums),
            _build.stream(device))
    _build.count(adm_level)
    return sums, a_ref, a_dist


adm_level.launches = 0


def adm_features(ref: torch.Tensor, dist: torch.Tensor, *,
                 gain_limit: float = 100.0) -> torch.Tensor:
    """(N, H, W) core luma pair -> (N,) f32 adm2 on ``ref.device``: the four
    levels through :func:`adm_level`, then the cbrt and stabiliser tail
    (pqa2_tpu/ops/pallas_adm.py:293)."""
    h, w = ref.shape[-2], ref.shape[-1]
    r = ref.float().contiguous()
    d = dist.float().contiguous()
    sums = []
    for lvl in range(NUM_LEVELS):
        s, r, d = adm_level(r, d, level=lvl, gain_limit=gain_limit)
        sums.append(s)
    return adm_from_level_sums(sums, h, w)
