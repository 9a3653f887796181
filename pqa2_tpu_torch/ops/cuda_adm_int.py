"""Kernel 3 of the port: one integer ADM level, ``csrc/adm_int.cu``.

Replaces ``adm_int_level_pallas`` of ``pqa2_tpu/ops/pallas_adm_int.py``
(its ``pl.pallas_call`` at :381, kernel body ``_make_int_kernel`` :60,
drivers ``adm_pooled_digit_sums_pallas`` :415 / ``adm_features_int_pallas``
:458). Two launches per level:

  (a) the Q15 db2 DWT of ref and dist, read with strided symmetric
      indexing straight from the approximation plane (no host polyphase
      split), writing a/h/v/d int32 bands;
  (b) decoupling, CSF, the 3x3 ``trunc(S/30)`` threshold and cube pooling
      over the trimmed core into six int64 sums per frame.

The wrapper computes with the plain version (``ops/adm_int.py``) only for
CPU tensors; for CUDA tensors it launches the kernels or raises.
``adm_int_level.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pqa2_tpu_torch.golden.adm import COS_1DEG_SQ
from pqa2_tpu_torch.golden.fixedpoint import ADM_TAIL_TABLES, DB2_HI_Q15, DB2_LO_Q15
from pqa2_tpu_torch import _build
from pqa2_tpu_torch.ops.adm_int import (
    adm_cascade,
    adm_from_digit_sums,
    adm_level_plain,
    band_geometry,
    digits_from_sums,
)
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, _taps

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DWT_ARGS = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]
_POOL_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
              _F, _I, _P, _P]


def adm_int_level(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    level: int,
    extra_row_shift: int,
    gain_limit: float,
):
    """One ADM level. Same contract as
    :func:`pqa2_tpu_torch.ops.adm_int.adm_level_plain`:

    ref/dist (N, H, W) int32 contiguous approximation planes ->
    ``(sums (N, 3, 2) int64, ref_a, dist_a)``."""
    device = _check_device(ref, "ref")
    if device is None:
        return adm_level_plain(ref, dist, level=level,
                               extra_row_shift=extra_row_shift,
                               gain_limit=gain_limit)
    _build.check_tensor(ref, "ref", torch.int32, 3, device)
    _build.check_tensor(dist, "dist", torch.int32, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= extra_row_shift <= 8:
        raise ValueError(f"extra_row_shift {extra_row_shift} outside [0, 8]")
    n, h, w = ref.shape
    h2, w2, th, tw, dshift = band_geometry(h, w)
    irf, _ = ADM_TAIL_TABLES[level]
    with torch.cuda.device(device):
        st = _build.stream(device)
        taps = _taps(device, "db2", np.concatenate([DB2_LO_Q15, DB2_HI_Q15]))
        bands = {}
        for name, src in (("o", ref), ("t", dist)):
            out = torch.empty((4, n, h2, w2), dtype=torch.int32, device=device)
            _build.launch("pqa2_adm_dwt", _DWT_ARGS, _build.ptr(src), n, h, w,
                          extra_row_shift, _build.ptr(taps),
                          _build.ptr(out[0]), _build.ptr(out[1]),
                          _build.ptr(out[2]), _build.ptr(out[3]), st)
            bands[name] = out  # a, h, v, d
        sums = torch.zeros((n, 3, 2), dtype=torch.int64, device=device)
        o, t = bands["o"], bands["t"]
        _build.launch(
            "pqa2_adm_pool", _POOL_ARGS,
            _build.ptr(o[1]), _build.ptr(o[2]), _build.ptr(o[3]),
            _build.ptr(t[1]), _build.ptr(t[2]), _build.ptr(t[3]),
            n, h2, w2, th, tw, int(irf[0]), int(irf[1]), int(irf[2]),
            float(np.float32(gain_limit)), int(float(gain_limit) == 1.0),
            float(np.float32(COS_1DEG_SQ)), dshift, _build.ptr(sums), st)
    adm_int_level.launches += 1
    return sums, o[0], t[0]


adm_int_level.launches = 0


def adm_features_int(ref: torch.Tensor, dist: torch.Tensor, *,
                     gain_limit: float = 100.0, bit_depth: int = 8) -> torch.Tensor:
    """(N, H, W) core luma pair -> (N,) f32 adm2 on ``ref.device``: the four
    levels through :func:`adm_int_level`, the f32 tail on the host."""
    sums = adm_cascade(ref, dist, gain_limit=gain_limit, bit_depth=bit_depth,
                       level_fn=adm_int_level)
    adm = adm_from_digit_sums(digits_from_sums(sums), ref.shape[-2], ref.shape[-1])
    return torch.as_tensor(adm, device=ref.device)
