"""Kernel 4 of the port: SSIM and the plane SSE in one pass, ``csrc/ssim.cu``.

Replaces ``ssim_sse_pallas`` of ``pqa2_tpu/ops/pallas_ssim.py`` (its
``pl.pallas_call`` at :225, kernel body ``_make_kernel`` :43; also
``ssim_plane_pallas`` :246). One thread evaluates one 8x8 window from 4x4
block sums staged in shared memory; per-block partial sums go to a scratch
tensor and a second launch sums them per frame in a fixed order, so the
result does not depend on block scheduling.

The wrapper computes with the plain version (``ops/ssim.py``) only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
``ssim_sse_plane.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pqa2_tpu_torch import _build
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device
from pqa2_tpu_torch.ops.ssim import scaled_ssim_constants, ssim_sse_plane_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SSIM_ARGS = [_P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P]

# Windows per block (csrc/ssim.cu: SWX x SWY).
_SWX, _SWY = 32, 8


def ssim_sse_plane(ref: torch.Tensor, dist: torch.Tensor, bit_depth: int = 8):
    """(N, H, W) f32 pair on the 8-bit scale -> ((N,) f32 SSIM, (N,)
    float64 SSE). Same contract as
    :func:`pqa2_tpu_torch.ops.ssim.ssim_sse_plane_plain`."""
    device = _check_device(ref, "ref")
    if device is None:
        return ssim_sse_plane_plain(ref, dist, bit_depth)
    _build.check_tensor(ref, "ref", torch.float32, 3, device)
    _build.check_tensor(dist, "dist", torch.float32, 3, device)
    if ref.shape != dist.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != dist {tuple(dist.shape)}")
    n, h, w = ref.shape
    nwy, nwx = h // 4 - 1, w // 4 - 1
    if nwy < 1 or nwx < 1:
        raise ValueError(f"{h}x{w} plane has no 8x8 SSIM window")
    c1, c2 = (float(np.float32(c)) for c in scaled_ssim_constants(bit_depth))
    nblocks = -(-nwx // _SWX) * -(-nwy // _SWY)
    with torch.cuda.device(device):
        part = torch.empty((2, n, nblocks), dtype=torch.float64, device=device)
        ssim = torch.empty((n,), dtype=torch.float32, device=device)
        sse = torch.empty((n,), dtype=torch.float64, device=device)
        _build.launch("pqa2_ssim_sse", _SSIM_ARGS, _build.ptr(ref),
                      _build.ptr(dist), n, h, w, c1, c2, _build.ptr(part[0]),
                      _build.ptr(part[1]), _build.ptr(ssim), _build.ptr(sse),
                      _build.stream(device))
    _build.count(ssim_sse_plane)
    return ssim, sse


ssim_sse_plane.launches = 0
