"""Kernel 5 of the port: the float VIF scale pass, ``csrc/vif.cu``.

Replaces ``vif_scale_pallas`` of ``pqa2_tpu/ops/pallas_vif.py`` (its
``pl.pallas_call`` at :404, kernel body ``_make_kernel`` :92; caller
``vif_features_pallas`` :451): one scale's five Gaussian moments, the
``default`` or ``classic`` statistic with the optional NEG gain limit, the
per-frame num/den sums and, with ``emit_next``, the next scale's decimated
inputs. The TPU kernel's fused motion term is kernel 7: with
``motion_ref`` the scale-0 call launches :func:`ops.cuda_motion.motion_sad
<pqa2_tpu_torch.ops.cuda_motion.motion_sad>` on the reference chunk, halo
frames included, and returns ``sad`` as ``vif_features_pallas(...,
with_motion=True)`` does (pallas_vif.py:451-501).

The wrapper computes with the plain version (``ops/vif.py``) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
``vif_scale.launches`` counts kernel launches.

Design (``csrc/vif.cu``): one block per 48x32 tile stages both planes with
the filter's halo in shared memory, then register-tiled column and row
passes (each staged value read once per moment, x*x, y*y, x*y rounded once
per staged value, the taps in the kernel's parameters), the statistic, and
the next scale's planes from the same tile. The planes must equal the
plain version's bit for bit, so every product and sum is rounded on its
own: no FMA, no regrouping. What bounds it on the H100 is f32 issue of
those unfused multiplies and adds, about twice the instructions an
FMA-rate bound counts (PERF.md §6).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from pqa2_tpu_torch import _build
from pqa2_tpu_torch.golden.filters import vif_filter
from pqa2_tpu_torch.golden.vif import EPS, SIGMA_MAX_INV, SIGMA_NSQ
from pqa2_tpu_torch.ops.cuda_motion import motion_sad
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, host_taps
from pqa2_tpu_torch.ops.vif import VARIANTS, vif_ratio, vif_scale_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_VIF_ARGS = [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P]


def vif_scale(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    scale: int,
    gain_limit: float = float("inf"),
    variant: str = "classic",
    emit_next: bool = False,
    motion_ref: Optional[torch.Tensor] = None,
):
    """One float VIF scale. ref/dist (N, H, W) f32 contiguous at this
    scale's resolution -> ``(num (N,), den (N,), next_ref, next_dist,
    sad)``: the contract of :func:`pqa2_tpu_torch.ops.vif.vif_scale_plain`
    plus, with ``motion_ref`` (M, H, W), the (M,) motion SAD of kernel 7
    (else None)."""
    device = _check_device(ref, "ref")
    if device is None:
        out = vif_scale_plain(ref, dist, scale=scale, gain_limit=gain_limit,
                              variant=variant, emit_next=emit_next)
        return (*out, motion_sad(motion_ref) if motion_ref is not None else None)
    _build.check_tensor(ref, "ref", torch.float32, 3, device)
    _build.check_tensor(dist, "dist", torch.float32, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    if not 0 <= scale < 4 or (emit_next and scale == 3):
        raise ValueError(f"bad scale {scale} (emit_next={emit_next})")
    if variant not in VARIANTS:
        raise ValueError(f"unknown VIF variant {variant!r}")
    n, h, w = ref.shape
    half = len(vif_filter(scale)) // 2
    if h <= half or w <= half:
        raise ValueError(f"{h}x{w} plane too small for the {2 * half + 1}-tap window")
    taps = vif_filter(scale)
    if emit_next:
        taps = np.concatenate([taps, vif_filter(scale + 1)])
    with torch.cuda.device(device):
        blocks = _build.function("pqa2_vif_f32_blocks", [_I, _I], device)(h, w)
        part = torch.empty((n, blocks, 2), dtype=torch.float64, device=device)
        sums = torch.empty((n, 2), dtype=torch.float32, device=device)
        next_ref = next_dist = None
        if emit_next:
            next_ref = torch.empty((n, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32,
                                   device=device)
            next_dist = torch.empty_like(next_ref)
        finite = math.isfinite(gain_limit)
        _build.launch(
            "pqa2_vif_scale_f32", _VIF_ARGS,
            _build.ptr(ref), _build.ptr(dist), n, h, w, half, int(emit_next),
            host_taps(("vif_f32", scale, emit_next), np.asarray(taps, np.float32), _F),
            int(variant == "classic"), int(finite), gain_limit if finite else 0.0,
            EPS, SIGMA_NSQ, SIGMA_MAX_INV,
            _build.ptr(part), _build.ptr(sums), _build.ptr(next_ref),
            _build.ptr(next_dist), _build.stream(device))
    _build.count(vif_scale)
    sad = motion_sad(motion_ref) if motion_ref is not None else None
    return sums[:, 0], sums[:, 1], next_ref, next_dist, sad


vif_scale.launches = 0


def vif_features(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    gain_limit: float = float("inf"),
    variant: str = "classic",
    motion_ref: Optional[torch.Tensor] = None,
):
    """(N, H, W) luma pair -> ``(vif (N, 4) f32, sad)``: the four-scale
    cascade through :func:`vif_scale`, each scale emitting the next one's
    inputs; ``sad`` is the (M,) motion SAD of ``motion_ref`` (M, H, W) from
    the scale-0 call, or None."""
    r = ref.float().contiguous()
    d = dist.float().contiguous()
    m = motion_ref.float().contiguous() if motion_ref is not None else None
    feats = []
    sad = None
    for scale in range(4):
        num, den, nr, nd, s = vif_scale(r, d, scale=scale, gain_limit=gain_limit,
                                        variant=variant, emit_next=scale < 3,
                                        motion_ref=m if scale == 0 else None)
        if scale == 0:
            sad = s
        feats.append(vif_ratio(num, den))
        r, d = nr, nd
    return torch.stack(feats, dim=-1), sad

