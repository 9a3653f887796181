"""Kernels 1, 1f and 2 of the port: the integer VIF scale pass (with the
fused motion SAD at scale 0) in its exact and its fast form, and the Q11
log2-table audit, ``csrc/vif_int.cu``.

Counterpart of ``pqa2_tpu/ops/pallas_vif_int.py``:

  * :func:`vif_int_scale` replaces ``vif_int_scale_pallas`` (its
    ``pl.pallas_call`` at pallas_vif_int.py:1021, kernel body
    ``_make_int_kernel`` :486) — one scale's Q16 moments, sigma planes,
    exact LUT statistic to per-frame integer accumulators, the next scale's
    decimated planes, and at scale 0 the motion SAD; with ``exact=False``
    the same kernel's fast body (``exact_fused=False``, statistic
    ``_statistic_int`` :467, ``precision="integer_fast"``): the same planes
    and the smooth f32-log statistic, summed per frame as {num, den};
  * :func:`log2_table_audit` replaces ``log2_direct_exceptions``
    (pallas_call at :152) — on Hopper the statistic reads the table, so
    the audit checks the device lookup against ``golden/log2lut.py`` over
    all 32768 mantissas. The kernel compares on the card and counts the
    mismatches (one int32 comes back); a passed audit is cached per device,
    so the first integer clip of a process audits and later ones do not.

Each wrapper computes with its plain version (``ops/vif_int.py``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises. ``launches``
on each wrapper counts its calls that launch (one per scale);
``vif_int_scale.fast_launches`` counts those of the fast form apart.

Design (``csrc/vif_int.cu``): one launch per scale stages a 48x32 tile of
ref and dist with the filter's halo in shared memory (8-bit luma as its
bytes), runs the register-tiled column and row passes, the statistic, the
next scale's decimation and, at scale 0, the motion blur of the core
frames; a small launch blurs the chunk's halo frames and one more sums the
SADs. With 8-bit codes every filter runs in uint32, wider codes widen only
the products. What bounds it on the H100 is integer and f64 issue, not
memory: PERF.md §6 has its time beside the bound.
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
    scale0_codes,
    vif_cascade,
    vif_int_scale_plain,
)
from pqa2_tpu_torch.utils.profiling import span, to_host

_P = ctypes.c_void_p
_I = ctypes.c_int
_VIF_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_double,
             ctypes.c_double, ctypes.c_longlong, _I, _P, _P, _P, _P, _P, _P, _I, _P]
_BLUR_ARGS = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
_SAD_ARGS = [_P, _I, _I, _I, _P, _P]
_AUDIT_ARGS = [_P, _P, _P, _P]

_HOST_TAPS = {}
#: Expected audit values per device, and the devices whose audit passed.
_EXPECTED = {}
_AUDITED = set()


def host_taps(key, values, ctype=ctypes.c_int):
    """A filter table as a ctypes array in host memory: the launchers copy
    it into the kernel's parameters."""
    k = (key, ctype)
    if k not in _HOST_TAPS:
        _HOST_TAPS[k] = (ctype * len(values))(*np.asarray(values).tolist())
    return _HOST_TAPS[k]


def _check_device(t: torch.Tensor, name: str) -> Optional[torch.device]:
    """None for CPU tensors (plain version), the device for CUDA tensors;
    any other device raises."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernel needs a CUDA "
                         f"tensor (or a CPU tensor for the plain version)")
    return t.device


def _check_8bit(*planes: torch.Tensor) -> None:
    """At in_q == 0 the kernel filters in uint32, exact for 8-bit codes
    only: int32 planes must hold values in [0, 255] (one reduction, one
    sync; uint8 planes need no check)."""
    lims = torch.stack([torch.stack(t.aminmax()) for t in planes])
    lo, hi = to_host(lims[:, 0].min()).item(), to_host(lims[:, 1].max()).item()
    if lo < 0 or hi > 255:
        raise ValueError(f"in_q 0 needs 8-bit codes; the planes hold {lo}..{hi}")


def _frame_offset(ref: torch.Tensor, motion_ref: torch.Tensor) -> Optional[int]:
    """Index of ref's first frame in motion_ref when ref is a run of
    motion_ref's frames (a view of the same memory, as the core frames of
    a chunk are), else None."""
    if (ref.dtype != motion_ref.dtype
            or ref.untyped_storage().data_ptr() != motion_ref.untyped_storage().data_ptr()):
        return None
    frame = ref[0].numel() * ref.element_size()
    off, rem = divmod(ref.data_ptr() - motion_ref.data_ptr(), frame)
    if rem or off < 0 or off + ref.shape[0] > motion_ref.shape[0]:
        return None
    return off


def vif_int_scale(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    scale: int,
    in_q: int,
    gain_limit: float,
    decimate: bool,
    motion_ref: Optional[torch.Tensor] = None,
    exact: bool = True,
):
    """One integer VIF scale. Same contract as
    :func:`pqa2_tpu_torch.ops.vif_int.vif_int_scale_plain`:

    ref/dist (N, H, W) contiguous codes -> ``(stats, next_ref, next_dist,
    sad)``, ``stats`` the (N, 7) int64 accumulators of the exact statistic
    or, with ``exact=False``, the (N, 2) f32 {num, den} sums of the fast
    one (a second, fixed-order launch adds the blocks' float64 partials,
    so the sums have the same bits on every run). On the card the planes
    are int32 (Q{in_q}, < 2^16;
    below 2^8 at in_q 0) or, at in_q 0, uint8 (the bytes the source
    holds); ``motion_ref`` likewise. One launch computes the moments, the
    statistic, the next scale's Q8 planes and, when ref's frames are a run
    of motion_ref's frames (the core of a chunk), their motion blur; a
    small launch blurs motion_ref's other frames and one more sums the
    SADs."""
    device = _check_device(ref, "ref")
    if device is None:
        return vif_int_scale_plain(ref, dist, scale=scale, in_q=in_q,
                                   gain_limit=gain_limit, decimate=decimate,
                                   motion_ref=motion_ref, exact=exact)
    if ref.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"ref has dtype {ref.dtype}, expected torch.int32 or torch.uint8")
    _build.check_tensor(ref, "ref", ref.dtype, 3, device)
    _build.check_tensor(dist, "dist", ref.dtype, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= scale < 4 or (decimate and scale == 3):
        raise ValueError(f"bad scale {scale} (decimate={decimate})")
    if not 0 <= in_q <= 8:
        raise ValueError(f"in_q {in_q} outside [0, 8]")
    if ref.dtype == torch.uint8 and in_q != 0:
        raise ValueError(f"uint8 planes are 8-bit codes (in_q 0), not in_q {in_q}")
    n, h, w = ref.shape
    half = len(VIF_FILTERS_Q16[scale]) // 2
    if h <= half or w <= half:
        raise ValueError(f"{h}x{w} plane too small for the {2 * half + 1}-tap window")
    if motion_ref is not None:
        if motion_ref.dtype not in (torch.int32, torch.uint8):
            raise TypeError(f"motion_ref has dtype {motion_ref.dtype}")
        _build.check_tensor(motion_ref, "motion_ref", motion_ref.dtype, 3, device)
        if tuple(motion_ref.shape[1:]) != (h, w):
            raise ValueError("motion_ref frames differ in size from ref")
        if motion_ref.dtype == torch.uint8 and in_q != 0:
            raise ValueError(f"uint8 motion_ref is 8-bit codes (in_q 0), not in_q {in_q}")
    if in_q == 0 and ref.dtype == torch.int32:
        _check_8bit(ref, dist)
    with torch.cuda.device(device):
        st = _build.stream(device)
        stats = part = sums = None
        if exact:
            stats = torch.zeros((n, len(STATS)), dtype=torch.int64, device=device)
        else:
            blocks = _build.function("pqa2_vif_int_blocks", [_I, _I], device)(h, w)
            part = torch.empty((n, blocks, 2), dtype=torch.float64, device=device)
            sums = torch.empty((n, 2), dtype=torch.float32, device=device)
        next_ref = next_dist = sad = blurred = None
        if decimate:
            next_ref = torch.empty((n, (h + 1) // 2, (w + 1) // 2), dtype=torch.int32,
                                   device=device)
            next_dist = torch.empty_like(next_ref)
        off = None
        if motion_ref is not None:
            m = motion_ref.shape[0]
            # uint16 Q8 frames, kept in int16 storage.
            blurred = torch.empty((m, h, w), dtype=torch.int16, device=device)
            off = _frame_offset(ref, motion_ref) if half >= 2 else None
        motion_taps = host_taps("motion", MOTION_FILTER_Q16)
        _build.launch(
            "pqa2_vif_scale", _VIF_ARGS,
            _build.ptr(ref), _build.ptr(dist), int(ref.dtype == torch.uint8), n, h, w,
            in_q, half, host_taps(("vif", scale), VIF_FILTERS_Q16[scale]),
            host_taps(("vif", scale + 1), VIF_FILTERS_Q16[scale + 1]) if decimate else None,
            motion_taps, _build.ptr(log2_table_device(device) if exact else None),
            float(gain_limit), float(VIF_INT_EPS), int(SIGMA_NSQ_Q16), int(not exact),
            _build.ptr(stats), _build.ptr(part), _build.ptr(sums),
            _build.ptr(next_ref), _build.ptr(next_dist),
            _build.ptr(blurred if off is not None else None), off or 0, st)
        if motion_ref is not None:
            lo, hi = (off, off + n) if off is not None else (0, 0)
            _build.launch("pqa2_motion_blur", _BLUR_ARGS, _build.ptr(motion_ref),
                          int(motion_ref.dtype == torch.uint8), m, h, w, in_q, lo, hi,
                          motion_taps, _build.ptr(blurred), st)
            sad = torch.zeros((max(m - 1, 0),), dtype=torch.int64, device=device)
            if m > 1:
                _build.launch("pqa2_motion_sad", _SAD_ARGS, _build.ptr(blurred),
                              m, h, w, _build.ptr(sad), st)
    if exact:
        _build.count(vif_int_scale)
        return stats, next_ref, next_dist, sad
    _build.count(vif_int_scale, "fast_launches")
    return sums, next_ref, next_dist, sad


vif_int_scale.launches = 0
vif_int_scale.fast_launches = 0


def vif_motion_features_int(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    core: slice,
    gain_limit: float = float("inf"),
    bit_depth: int = 8,
    exact: bool = True,
):
    """(N, H, W) chunk luma (halos included) -> ``(vif (N_core, 4) f32,
    sad (N-1,) int64)``: VIF on the core frames, the motion SAD over every
    frame (as pqa2_tpu/ops/pallas_vif_int.py:1055 does; ``exact``
    picks the statistic). The chunk becomes codes once, so the core frames
    stay a view of it and the scale-0 launch blurs them for the SAD.
    Span ``features.vif_int``."""
    with span("features.vif_int"):
        codes, _ = scale0_codes(ref, bit_depth)
        return vif_cascade(codes[core], dist[core], gain_limit=gain_limit,
                           bit_depth=bit_depth, scale_fn=vif_int_scale,
                           motion_ref=codes, exact=exact)


def _log2_expected(device) -> torch.Tensor:
    """What the audit must find: ``golden.log2lut.log2_table()[32768:65536]``
    for shift 0 and again for shift 21, (65536,) int32 on ``device``.
    Uploaded once per device, apart from the table the lookup reads
    (:func:`log2_table_device`), so a corrupted table upload cannot pass."""
    key = str(torch.device(device))
    if key not in _EXPECTED:
        want = np.tile(log2_table()[32768:65536].astype(np.int32), 2)
        _EXPECTED[key] = torch.as_tensor(want, device=device)
    return _EXPECTED[key]


def _audit_plain(device: torch.device) -> torch.Tensor:
    m = torch.arange(32768, 65536, dtype=torch.int64, device=device)
    direct, k0 = q11_log2_plain(m)
    shifted, k21 = q11_log2_plain((m << 21) | (m & 0x1FFFFF))
    bad = torch.full_like(direct, -1)
    return torch.cat([torch.where(k0 == 0, direct, bad),
                      torch.where(k21 == 21, shifted, bad)]).to(torch.int32)


def _audit_mismatches_plain(device, want: Optional[torch.Tensor] = None) -> int:
    """The plain audit: the lookups of :func:`_audit_plain` that differ from
    ``want`` (default :func:`_log2_expected`)."""
    want = _log2_expected(device) if want is None else want
    return int(torch.count_nonzero(_audit_plain(torch.device(device)) != want))


def _log2_audit_launch(device, want: Optional[torch.Tensor] = None) -> int:
    """One launch of the audit kernel on a CUDA ``device``, never cached: it
    compares every lookup with ``want`` (default :func:`_log2_expected`)
    on the card and returns the mismatch count, the one int32 copied back.
    Counted in ``log2_table_audit.launches``."""
    device = require_cuda(device)
    want = _log2_expected(device) if want is None else want
    _build.check_tensor(want, "want", torch.int32, 1, device)
    if want.numel() != 2 * 32768:
        raise ValueError(f"want has {want.numel()} values, expected {2 * 32768}")
    with torch.cuda.device(device):
        bad = torch.zeros(1, dtype=torch.int32, device=device)
        _build.launch("pqa2_log2_audit", _AUDIT_ARGS,
                      _build.ptr(log2_table_device(device)), _build.ptr(want),
                      _build.ptr(bad), _build.stream(device))
    _build.count(log2_table_audit)
    return int(bad.item())


def log2_table_audit(device) -> int:
    """Exhaustive audit of the statistic's Q11 log2 lookup on ``device``,
    once per device: a passed audit is cached, as the JAX package caches
    ``log2_direct_exceptions`` per backend.

    For every mantissa m in [2^15, 2^16) the device evaluates the lookup
    the VIF kernel uses, for m itself and for a 37-bit value whose
    truncated mantissa is m (normalisation shift 21); both must equal
    ``golden.log2lut.log2_table()[m]``. The card compares and counts
    (:func:`_log2_audit_launch`); the CPU audits the plain lookup. Returns
    0, or raises RuntimeError on any mismatch, at every call until an
    audit passes."""
    device = torch.device(device)
    if device.type == "cuda":
        device = require_cuda(device)
    elif device.type != "cpu":
        raise ValueError(f"log2 audit needs a CUDA or CPU device, got {device}")
    key = str(device)
    if key in _AUDITED:
        return 0
    mismatches = (_log2_audit_launch(device) if device.type == "cuda"
                  else _audit_mismatches_plain(device))
    if mismatches:
        raise RuntimeError(
            f"Q11 log2 lookup on {device} disagrees with golden/log2lut.py at "
            f"{mismatches} of {2 * 32768} audited values")
    _AUDITED.add(key)
    return 0


log2_table_audit.launches = 0
