"""Colorspace / pixel-format conversions (port of pqa2_tpu/ops/colorspace.py).

Torch ops on the input's device (a numpy array is taken as a CPU tensor):

  * packed UYVY 4:2:2 <-> planar y/u/v
  * BT.601 / BT.709 limited- and full-range YCbCr <-> RGB matrices
  * chroma up/down-sampling between 4:2:0 / 4:2:2 / 4:4:4

The 3x3 colour products are spelled out as f32 products added in column
order, never a matmul, so TF32 cannot apply (models/svr.py keeps the same
rule). Each division divides by a 0-dim tensor on the input's device:
PyTorch's CUDA kernels multiply by the reciprocal of a Python-number
divisor, one rounding more than the CPU's division. So the card and the CPU
give the same bits. The box averages sum their 2x2 or 2x1 block and then
divide, as ``jnp.mean`` does, so integer inputs give the JAX package's
values exactly. ``uyvy422_to_planar`` assumes an even width, as the JAX
function does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Luma coefficients.
_KR_KB = {"bt601": (0.299, 0.114), "bt709": (0.2126, 0.0722)}


def _matrix(standard: str) -> np.ndarray:
    kr, kb = _KR_KB[standard]
    kg = 1.0 - kr - kb
    # RGB -> YCbCr (analog, [0,1] ranges)
    return np.array([
        [kr, kg, kb],
        [-0.5 * kr / (1 - kb), -0.5 * kg / (1 - kb), 0.5],
        [0.5, -0.5 * kg / (1 - kr), -0.5 * kb / (1 - kr)],
    ])


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device (see the module note)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _apply3(x: torch.Tensor, m: np.ndarray):
    """Rows of ``x @ m.T`` for (..., 3) f32 ``x``: per output channel the
    three f32 products added left to right."""
    m = m.astype(np.float32)
    c = [x[..., i] for i in range(3)]
    return [c[0] * float(r[0]) + c[1] * float(r[1]) + c[2] * float(r[2]) for r in m]


def rgb_to_yuv(rgb, standard: str = "bt709", full_range: bool = False) -> torch.Tensor:
    """(..., 3) RGB in [0,255] -> (..., 3) YCbCr (8-bit levels)."""
    x = _div(_tensor(rgb).to(torch.float32), 255.0)
    y, cb, cr = _apply3(x, _matrix(standard))  # y in [0,1], c in [-.5,.5]
    if full_range:
        y = y * 255.0
        cb = cb * 255.0 + 128.0
        cr = cr * 255.0 + 128.0
    else:
        y = y * 219.0 + 16.0
        cb = cb * 224.0 + 128.0
        cr = cr * 224.0 + 128.0
    return torch.stack([y, cb, cr], dim=-1)


def yuv_to_rgb(yuv, standard: str = "bt709", full_range: bool = False) -> torch.Tensor:
    """(..., 3) YCbCr (8-bit levels) -> (..., 3) RGB in [0,255]."""
    x = _tensor(yuv).to(torch.float32)
    y, cb, cr = (x[..., i] for i in range(3))
    if full_range:
        y = _div(y, 255.0)
        cb = _div(cb - 128.0, 255.0)
        cr = _div(cr - 128.0, 255.0)
    else:
        y = _div(y - 16.0, 219.0)
        cb = _div(cb - 128.0, 224.0)
        cr = _div(cr - 128.0, 224.0)
    rgb = _apply3(torch.stack([y, cb, cr], dim=-1), np.linalg.inv(_matrix(standard)))
    return torch.stack(rgb, dim=-1) * 255.0


def uyvy422_to_planar(packed) -> Dict[str, torch.Tensor]:
    """Packed UYVY 4:2:2 bytes -> planar dict.

    packed: (..., H, 2*W) uint8 laid out U0 Y0 V0 Y1 U2 Y2 V2 Y3 ...
    Returns y (..., H, W), u/v (..., H, W//2) — the capture card's native
    wire format (app/options_manager.py:82).
    """
    packed = _tensor(packed)
    w = packed.shape[-1] // 2
    quads = packed.reshape(*packed.shape[:-1], w // 2, 4)  # U Y V Y
    y = torch.stack([quads[..., 1], quads[..., 3]], dim=-1).reshape(*packed.shape[:-1], w)
    return {"y": y, "u": quads[..., 0], "v": quads[..., 2]}


def planar_to_uyvy422(y, u, v) -> torch.Tensor:
    """Planar 4:2:2 -> packed UYVY bytes (inverse of uyvy422_to_planar)."""
    y, u, v = _tensor(y), _tensor(u), _tensor(v)
    w = y.shape[-1]
    y_pairs = y.reshape(*y.shape[:-1], w // 2, 2)
    quads = torch.stack([u, y_pairs[..., 0], v, y_pairs[..., 1]], dim=-1)
    return quads.reshape(*y.shape[:-1], 2 * w)


def chroma_420_to_444(c) -> torch.Tensor:
    """Nearest-neighbour chroma upsample (ffmpeg default for metrics)."""
    c = _tensor(c)
    return c.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)


def chroma_444_to_420(c) -> torch.Tensor:
    """2x2 box-average chroma downsample."""
    c = _tensor(c)
    h, w = c.shape[-2] // 2 * 2, c.shape[-1] // 2 * 2
    c = c[..., :h, :w].to(torch.float32)
    return c.reshape(*c.shape[:-2], h // 2, 2, w // 2, 2).sum(dim=(-3, -1)) / 4.0


def chroma_422_to_420(c) -> torch.Tensor:
    """Vertical 2x box-average (4:2:2 -> 4:2:0)."""
    c = _tensor(c)
    h = c.shape[-2] // 2 * 2
    c = c[..., :h, :].to(torch.float32)
    return c.reshape(*c.shape[:-2], h // 2, 2, c.shape[-1]).sum(dim=-2) / 2.0
