"""Kernel 3 of the port: one integer ADM level, ``csrc/adm_int.cu``.

Replaces ``adm_int_level_pallas`` of ``pqa2_tpu/ops/pallas_adm_int.py``
(its ``pl.pallas_call`` at :381, kernel body ``_make_int_kernel`` :60,
drivers ``adm_pooled_digit_sums_pallas`` :415 / ``adm_features_int_pallas``
:458). One launch per level: a block per 61x16 band tile computes the Q15
db2 DWT of ref and dist in shared memory (read with symmetric ``2i-1+f``
indexing straight from the approximation plane, 8-bit luma as its bytes
at level 0), decouples each pixel once, thresholds with ``trunc(S/30)``
and pools the trimmed core into six int64 sums per frame; only the next
level's approximation bands go back to device memory. The DWT runs in
int32 wherever :func:`pqa2_tpu_torch.ops.adm_int.dwt_envelope` bounds its
accumulators below 2^31, and the decoupling's quotient needs no divide
(:func:`quotient_audit` checks it on the card).

The wrapper computes with the plain version (``ops/adm_int.py``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
``adm_int_level.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pqa2_tpu_torch.golden.adm import COS_1DEG_SQ
from pqa2_tpu_torch.golden.fixedpoint import (
    ADM_BAND_Q,
    ADM_TAIL_TABLES,
    DB2_HI_Q15,
    DB2_LO_Q15,
)
from pqa2_tpu_torch import _build
from pqa2_tpu_torch._device import require_cuda
from pqa2_tpu_torch.ops.adm_int import (
    adm_cascade,
    adm_from_digit_sums,
    adm_level_plain,
    band_geometry,
    digits_from_sums,
    dwt_wide_passes,
    is_luma8,
)
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, host_taps

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LEVEL_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _F, _I, _F,
               _I, _I, _I, _P, _P, _P, _P]
_AUDIT_ARGS = [_I, _P, _P]

#: The decoupling's quotient is audited for every |o| up to this (2^16): the
#: envelope's largest h/v/d band is below it (ops/adm_int.py:dwt_envelope).
QUOTIENT_OA_MAX = 1 << 16


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

    ref/dist (N, H, W) contiguous int32 codes in the level's envelope (Q4
    codes below 2^(12 + extra_row_shift) at level 0, the previous level's
    approximation after it), or at level 0 uint8 8-bit luma ->
    ``(sums (N, 3, 2) int64, ref_a, dist_a)``."""
    device = _check_device(ref, "ref")
    if device is None:
        return adm_level_plain(ref, dist, level=level,
                               extra_row_shift=extra_row_shift,
                               gain_limit=gain_limit)
    if ref.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"ref has dtype {ref.dtype}, expected torch.int32 or torch.uint8")
    _build.check_tensor(ref, "ref", ref.dtype, 3, device)
    _build.check_tensor(dist, "dist", ref.dtype, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= level < len(ADM_TAIL_TABLES):
        raise ValueError(f"bad level {level}")
    if not 0 <= extra_row_shift <= 8:
        raise ValueError(f"extra_row_shift {extra_row_shift} outside [0, 8]")
    in_u8 = is_luma8(ref, level, extra_row_shift)
    n, h, w = ref.shape
    h2, w2, th, tw, dshift = band_geometry(h, w)
    irf, _ = ADM_TAIL_TABLES[level]
    row_wide, col_wide = dwt_wide_passes(level, extra_row_shift)
    with torch.cuda.device(device):
        ref_a = torch.empty((n, h2, w2), dtype=torch.int32, device=device)
        dist_a = torch.empty_like(ref_a)
        sums = torch.zeros((n, 3, 2), dtype=torch.int64, device=device)
        _build.launch(
            "pqa2_adm_int_level", _LEVEL_ARGS, _build.ptr(ref), _build.ptr(dist),
            int(in_u8), n, h, w, ADM_BAND_Q[0] if in_u8 else 0, extra_row_shift,
            int(row_wide), int(col_wide),
            host_taps("db2_q15", np.concatenate([DB2_LO_Q15, DB2_HI_Q15])),
            int(irf[0]), int(irf[1]), int(irf[2]), float(np.float32(gain_limit)),
            int(float(gain_limit) == 1.0), float(np.float32(COS_1DEG_SQ)), th, tw, dshift,
            _build.ptr(ref_a), _build.ptr(dist_a), _build.ptr(sums),
            _build.stream(device))
    _build.count(adm_int_level)
    return sums, ref_a, dist_a


adm_int_level.launches = 0


def adm_features_int(ref: torch.Tensor, dist: torch.Tensor, *,
                     gain_limit: float = 100.0, bit_depth: int = 8) -> torch.Tensor:
    """(N, H, W) core luma pair -> (N,) f32 adm2 on ``ref.device``: the four
    levels through :func:`adm_int_level`, the f32 tail on the host."""
    sums = adm_cascade(ref, dist, gain_limit=gain_limit, bit_depth=bit_depth,
                       level_fn=adm_int_level)
    adm = adm_from_digit_sums(digits_from_sums(sums), ref.shape[-2], ref.shape[-1])
    return torch.as_tensor(adm, device=ref.device)


def quotient_q15_plain(num: np.ndarray, oa: np.ndarray) -> np.ndarray:
    """The decoupling's quotient floor(num / oa) for num < oa * 2^15, as the
    kernel computes it (csrc/adm_int.cu:quotient_q15): an f32 estimate of
    the quotient (numpy's f32 division, correctly rounded, standing in for
    the card's approximate one), truncated, then one exact step on the
    remainder."""
    num = np.asarray(num, dtype=np.int64)
    oa = np.asarray(oa, dtype=np.int64)
    q = np.trunc(num.astype(np.float32) / oa.astype(np.float32)).astype(np.int64)
    r = num - q * oa
    return q + (r >= oa).astype(np.int64) - (r < 0).astype(np.int64)


def _directed_cases(oas: np.ndarray):
    """(num, oa, want) of the audit's directed numerators q*oa, q*oa - 1 and
    q*oa + oa - 1 for every quotient q < 2^15."""
    q = np.arange(32768, dtype=np.int64)[None, :]
    oa = np.asarray(oas, dtype=np.int64)[:, None]
    q, oa = np.broadcast_arrays(q, oa)
    num = np.concatenate([(q * oa).ravel(), (q * oa - 1)[:, 1:].ravel(),
                          (q * oa + oa - 1).ravel()])
    want = np.concatenate([q.ravel(), (q - 1)[:, 1:].ravel(), q.ravel()])
    den = np.concatenate([oa.ravel(), oa[:, 1:].ravel(), oa.ravel()])
    return num, den, want


def _quotient_audit_plain() -> int:
    """The audit on the CPU, on a sample: the directed numerators of a few
    |o| across the envelope, and every (|t| << 15, |o|) with |t| < |o| <= 512."""
    num, oa, want = _directed_cases([1, 2, 3, 7, 255, 4095, 32767, 62854, 65535, 65536])
    bad = int(np.count_nonzero(quotient_q15_plain(num, oa) != want))
    oa = np.repeat(np.arange(1, 513), np.arange(0, 512))
    ta = np.concatenate([np.arange(1, k) for k in range(1, 513)])
    num = ta << 15
    return bad + int(np.count_nonzero(quotient_q15_plain(num, oa) != num // oa))


def quotient_audit(device) -> int:
    """Audit of the integer decoupling's quotient routine on ``device``.

    On the card: every (|t| << 15) / |o| with 1 <= |t| < |o| <= 2^16 (every
    quotient the decoupling divides for; where |t| >= |o| the clamp decides
    k), and the directed numerators q*|o|, q*|o| - 1 and q*|o| + |o| - 1 for
    every quotient q < 2^15 and every |o| <= 2^16, each against its exact
    floor. Returns the mismatch count (0) or raises RuntimeError. CPU
    audits the plain routine on a sample."""
    device = torch.device(device)
    if device.type == "cpu":
        bad = _quotient_audit_plain()
    else:
        if device.type != "cuda":
            raise ValueError(f"quotient audit needs a CUDA or CPU device, got {device}")
        device = require_cuda(device)
        with torch.cuda.device(device):
            out = torch.zeros(1, dtype=torch.int64, device=device)
            _build.launch("pqa2_adm_quotient_audit", _AUDIT_ARGS, QUOTIENT_OA_MAX,
                          _build.ptr(out), _build.stream(device))
            bad = int(out.item())
    if bad:
        raise RuntimeError(f"the ADM quotient routine on {device} is wrong for {bad} inputs")
    return bad
