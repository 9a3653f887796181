"""Kernels 1 and 2 of the port: the integer VIF scale pass (with the fused
motion SAD at scale 0) and the Q11 log2-table audit, ``csrc/vif_int.cu``.

Counterpart of ``pqa2_tpu/ops/pallas_vif_int.py``:

  * :func:`vif_int_scale` replaces ``vif_int_scale_pallas`` (its
    ``pl.pallas_call`` at pallas_vif_int.py:1021, kernel body
    ``_make_int_kernel`` :486) — one scale's Q16 moments, sigma planes,
    exact LUT statistic to per-frame integer accumulators, the next scale's
    decimated planes, and at scale 0 the motion SAD;
  * :func:`log2_table_audit` replaces ``log2_direct_exceptions``
    (pallas_call at :152) — on Hopper the statistic reads the table, so
    the audit checks the device lookup against ``golden/log2lut.py`` over
    all 32768 mantissas.

Each wrapper computes with its plain version (``ops/vif_int.py``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises. ``launches``
on each wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from pqa2_tpu_torch.golden.fixedpoint import (
    MOTION_FILTER_Q16,
    SIGMA_NSQ_Q16,
    VIF_FILTERS_Q16,
)
from pqa2_tpu_torch.golden.log2lut import log2_table
from pqa2_tpu_torch.golden.vif_int import VIF_INT_EPS
from pqa2_tpu_torch import _build
from pqa2_tpu_torch._device import require_cuda
from pqa2_tpu_torch.ops.vif_int import (
    STATS,
    log2_table_device,
    q11_log2_plain,
    vif_cascade,
    vif_int_scale_plain,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_VIF_ARGS = [_P, _P, _I, _I, _I, _I, _I, _P, _P, ctypes.c_double,
             ctypes.c_double, ctypes.c_longlong, _P, _P]
_DEC_ARGS = [_P, _I, _I, _I, _I, _I, _P, _P, _P]
_BLUR_ARGS = [_P, _I, _I, _I, _I, _P, _P, _P]
_SAD_ARGS = [_P, _I, _I, _I, _P, _P]
_AUDIT_ARGS = [_P, _P, _P]

_TAPS = {}


def _taps(device: torch.device, key, values, dtype=np.int32) -> torch.Tensor:
    """A filter table from pqa2_tpu_torch.golden (Q16 int32, or f32 for the
    float kernels), uploaded once per device."""
    k = (str(device), key, np.dtype(dtype).name)
    if k not in _TAPS:
        _TAPS[k] = torch.as_tensor(np.asarray(values, dtype=dtype), device=device)
    return _TAPS[k]


def _check_device(t: torch.Tensor, name: str) -> Optional[torch.device]:
    """None for CPU tensors (plain version), the device for CUDA tensors;
    any other device raises."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernel needs a CUDA "
                         f"tensor (or a CPU tensor for the plain version)")
    return t.device


def vif_int_scale(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    scale: int,
    in_q: int,
    gain_limit: float,
    decimate: bool,
    motion_ref: Optional[torch.Tensor] = None,
):
    """One integer VIF scale. Same contract as
    :func:`pqa2_tpu_torch.ops.vif_int.vif_int_scale_plain`:

    ref/dist (N, H, W) int32 contiguous codes (Q{in_q}, < 2^16) ->
    ``(stats (N, 7) int64, next_ref, next_dist, sad)``."""
    device = _check_device(ref, "ref")
    if device is None:
        return vif_int_scale_plain(ref, dist, scale=scale, in_q=in_q,
                                   gain_limit=gain_limit, decimate=decimate,
                                   motion_ref=motion_ref)
    _build.check_tensor(ref, "ref", torch.int32, 3, device)
    _build.check_tensor(dist, "dist", torch.int32, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= scale < 4 or (decimate and scale == 3):
        raise ValueError(f"bad scale {scale} (decimate={decimate})")
    if not 0 <= in_q <= 8:
        raise ValueError(f"in_q {in_q} outside [0, 8]")
    n, h, w = ref.shape
    half = len(VIF_FILTERS_Q16[scale]) // 2
    if h <= half or w <= half:
        raise ValueError(f"{h}x{w} plane too small for the {2 * half + 1}-tap window")
    with torch.cuda.device(device):
        st = _build.stream(device)
        stats = torch.zeros((n, len(STATS)), dtype=torch.int64, device=device)
        _build.launch(
            "pqa2_vif_scale", _VIF_ARGS,
            _build.ptr(ref), _build.ptr(dist), n, h, w, in_q, half,
            _build.ptr(_taps(device, ("vif", scale), VIF_FILTERS_Q16[scale])),
            _build.ptr(log2_table_device(device)),
            float(gain_limit), float(VIF_INT_EPS), int(SIGMA_NSQ_Q16),
            _build.ptr(stats), st)
        next_ref = next_dist = sad = None
        if decimate:
            h2, w2 = (h + 1) // 2, (w + 1) // 2
            taps = _taps(device, ("vif", scale + 1), VIF_FILTERS_Q16[scale + 1])
            next_ref = torch.empty((n, h2, w2), dtype=torch.int32, device=device)
            next_dist = torch.empty_like(next_ref)
            for src, dst in ((ref, next_ref), (dist, next_dist)):
                _build.launch("pqa2_vif_decimate", _DEC_ARGS, _build.ptr(src),
                              n, h, w, in_q, len(VIF_FILTERS_Q16[scale + 1]) // 2,
                              _build.ptr(taps), _build.ptr(dst), st)
        if motion_ref is not None:
            _build.check_tensor(motion_ref, "motion_ref", torch.int32, 3, device)
            m = motion_ref.shape[0]
            if tuple(motion_ref.shape[1:]) != (h, w):
                raise ValueError("motion_ref frames differ in size from ref")
            blurred = torch.empty_like(motion_ref)
            _build.launch("pqa2_motion_blur", _BLUR_ARGS, _build.ptr(motion_ref),
                          m, h, w, in_q,
                          _build.ptr(_taps(device, "motion", MOTION_FILTER_Q16)),
                          _build.ptr(blurred), st)
            sad = torch.zeros((max(m - 1, 0),), dtype=torch.int64, device=device)
            if m > 1:
                _build.launch("pqa2_motion_sad", _SAD_ARGS, _build.ptr(blurred),
                              m, h, w, _build.ptr(sad), st)
    vif_int_scale.launches += 1
    return stats, next_ref, next_dist, sad


vif_int_scale.launches = 0


def vif_motion_features_int(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    core: slice,
    gain_limit: float = float("inf"),
    bit_depth: int = 8,
):
    """(N, H, W) chunk luma (halos included) -> ``(vif (N_core, 4) f32,
    sad (N-1,) int64)``: VIF on the core frames, the motion SAD over every
    frame (the driver of pqa2_tpu/ops/pallas_vif_int.py:1055)."""
    return vif_cascade(ref[core], dist[core], gain_limit=gain_limit,
                       bit_depth=bit_depth, scale_fn=vif_int_scale,
                       motion_ref=ref)


def _audit_plain(device: torch.device) -> torch.Tensor:
    m = torch.arange(32768, 65536, dtype=torch.int64, device=device)
    direct, k0 = q11_log2_plain(m)
    shifted, k21 = q11_log2_plain((m << 21) | (m & 0x1FFFFF))
    bad = torch.full_like(direct, -1)
    return torch.cat([torch.where(k0 == 0, direct, bad),
                      torch.where(k21 == 21, shifted, bad)]).to(torch.int32)


def log2_table_audit(device) -> int:
    """Exhaustive audit of the statistic's Q11 log2 lookup on ``device``.

    For every mantissa m in [2^15, 2^16) the device evaluates the lookup
    the VIF kernel uses, for m itself and for a 37-bit value whose
    truncated mantissa is m (normalisation shift 21); both must equal
    ``golden.log2lut.log2_table()[m]``. Returns the mismatch count (0) or
    raises RuntimeError. CPU audits the plain lookup."""
    device = torch.device(device)
    if device.type == "cpu":
        got = _audit_plain(device)
    else:
        if device.type != "cuda":
            raise ValueError(f"log2 audit needs a CUDA or CPU device, got {device}")
        device = require_cuda(device)
        with torch.cuda.device(device):
            got = torch.empty(2 * 32768, dtype=torch.int32, device=device)
            _build.launch("pqa2_log2_audit", _AUDIT_ARGS,
                          _build.ptr(log2_table_device(device)), _build.ptr(got),
                          _build.stream(device))
        log2_table_audit.launches += 1
    want = np.tile(log2_table()[32768:65536].astype(np.int32), 2)
    mismatches = int(np.count_nonzero(got.cpu().numpy() != want))
    if mismatches:
        raise RuntimeError(
            f"Q11 log2 lookup on {device} disagrees with golden/log2lut.py at "
            f"{mismatches} of {2 * 32768} audited values")
    return mismatches


log2_table_audit.launches = 0
