"""Kernel 6 of the port: one float ADM level, ``csrc/adm.cu``.

Replaces ``adm_level_pallas`` of ``pqa2_tpu/ops/pallas_adm.py`` (its
``pl.pallas_call`` at :265, kernel body ``_make_kernel`` :52; caller
``adm_features_pallas`` :293). Three launches per level: the f32 db2 DWT
of ref and of dist, read with strided symmetric indexing straight from the
approximation plane; the pooling pass (decoupling, CSF, the 3x3 masking
threshold over a one-band halo, the six cube sums over the trimmed core,
in float64 per block); and the fixed-order per-frame sum of the block
partials. The cbrt and stabiliser tail runs in PyTorch
(:func:`pqa2_tpu_torch.ops.adm.adm_from_level_sums`).

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
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, _taps

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DWT_ARGS = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_POOL_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P]


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
    th, tw = _trim(h2), _trim(w2)
    fh, fv, fd = csf_rfactors(level)
    with torch.cuda.device(device):
        st = _build.stream(device)
        taps = _taps(device, "db2", np.concatenate([DB2_LO, DB2_HI]), np.float32)
        bands = []
        for src in (ref, dist):
            out = torch.empty((4, n, h2, w2), dtype=torch.float32, device=device)
            _build.launch("pqa2_adm_dwt_f32", _DWT_ARGS, _build.ptr(src), n, h, w,
                          _build.ptr(taps), _build.ptr(out[0]), _build.ptr(out[1]),
                          _build.ptr(out[2]), _build.ptr(out[3]), st)
            bands.append(out)  # a, h, v, d
        o, t = bands
        blocks = _build.function("pqa2_adm_f32_blocks", [_I, _I], device)(
            h2 - 2 * th, w2 - 2 * tw)
        part = torch.empty((n, blocks, 6), dtype=torch.float64, device=device)
        sums = torch.empty((n, 6), dtype=torch.float32, device=device)
        _build.launch(
            "pqa2_adm_pool_f32", _POOL_ARGS,
            _build.ptr(o[1]), _build.ptr(o[2]), _build.ptr(o[3]),
            _build.ptr(t[1]), _build.ptr(t[2]), _build.ptr(t[3]),
            n, h2, w2, th, tw, fh, fv, fd, gain_limit,
            COS_1DEG_SQ, _build.ptr(part), _build.ptr(sums), st)
    adm_level.launches += 1
    return sums, o[0], t[0]


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
