"""Kernel 7 of the port: the float motion SAD, ``csrc/motion.cu``.

Replaces ``motion_sad_pallas`` of ``pqa2_tpu/ops/pallas_motion.py`` (its
``pl.pallas_call`` at :137, kernel body ``_make_kernel`` :41): per frame the
mean |blur5(f[n]) - blur5(f[n-1])|, 0 at n = 0. The float VIF wrapper
(``ops/cuda_vif.py``) launches it on its scale-0 call, where the TPU fused
the same term into ``vif_scale_pallas``.

Design (``csrc/motion.cu``): a block owns a 128x32 output tile and walks a
run of at most :data:`RUN` consecutive frames, keeping the previous frame's
blurred pixels in registers, so each frame is read and blurred once per run
(plus once as the frame before the next run); the next frame's tile is
copied into shared memory while this one is blurred. A second launch adds
the per-tile partials in a fixed order and divides by H*W.

The wrapper computes with the plain version (``ops/motion.py``) only for
CPU tensors; for CUDA tensors it launches the kernel or raises.
``motion_sad.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pqa2_tpu_torch import _build
from pqa2_tpu_torch.golden.filters import motion_filter
from pqa2_tpu_torch.ops.cuda_vif_int import _check_device, host_taps
from pqa2_tpu_torch.ops.motion import motion_sad_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SAD_ARGS = [_P, _I, _I, _I, _P, _I, _P, _P, _P]

#: The most consecutive frames one block walks; the frames split evenly
#: into ceil(N / RUN) runs (a 34-frame chunk: 12, 11 and 11 frames, 3 x 510
#: blocks at 1080p).
RUN = 16


def motion_sad(frames: torch.Tensor) -> torch.Tensor:
    """(N, H, W) f32 contiguous luma -> (N,) f32 mean |blur(f[n]) -
    blur(f[n-1])|, 0 at n = 0. Same contract as
    :func:`pqa2_tpu_torch.ops.motion.motion_sad_plain`."""
    device = _check_device(frames, "frames")
    if device is None:
        return motion_sad_plain(frames)
    _build.check_tensor(frames, "frames", torch.float32, 3, device)
    n, h, w = frames.shape
    if n < 1 or h <= 2 or w <= 2:
        raise ValueError(f"frames {tuple(frames.shape)}: need N >= 1 and H, W > 2")
    with torch.cuda.device(device):
        tiles = _build.function("pqa2_motion_f32_tiles", [_I, _I], device)(h, w)
        part = torch.empty((n, tiles), dtype=torch.float64, device=device)
        sad = torch.empty((n,), dtype=torch.float32, device=device)
        _build.launch("pqa2_motion_sad_f32", _SAD_ARGS, _build.ptr(frames), n, h, w,
                      host_taps("motion_f32", np.asarray(motion_filter(), np.float32),
                                ctypes.c_float),
                      RUN, _build.ptr(part), _build.ptr(sad), _build.stream(device))
    _build.count(motion_sad)
    return sad


motion_sad.launches = 0
