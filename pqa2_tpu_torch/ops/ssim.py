"""ffmpeg's 8x8-window SSIM and the plane SSE — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/ssim.py`` and the plain twin of the CUDA
kernel in ``csrc/ssim.cu`` (wrapper: ``ops/cuda_ssim.py``). SSIM is the
x264/ffmpeg variant: 4x4 block sums, overlapping 8x8 windows on a 4-pixel
grid, the f32 window formula of ``pqa2_tpu/ops/ssim.py:63-68`` with
ffmpeg's native-max constants mapped onto the 8-bit scale
(:func:`scaled_ssim_constants`). The per-window ratios are f32 as in the
JAX package; their mean is taken in float64 and rounded once. The SSE is
f32 squared differences summed in float64 (exact for sources up to 12
bits).
"""

from __future__ import annotations

import numpy as np
import torch

from pqa2_tpu_torch.golden.ssim import ssim_constants
from pqa2_tpu_torch.ops.psnr import _sse


def scaled_ssim_constants(bit_depth: int = 8):
    """ffmpeg's native-max c1/c2 mapped onto the 8-bit scale
    (pqa2_tpu/ops/ssim.py:24): every sum term scales by div^2."""
    c1, c2 = ssim_constants(bit_depth)
    div2 = float(1 << (bit_depth - 8)) ** 2
    return c1 / div2, c2 / div2


def _block_sums(p: torch.Tensor) -> torch.Tensor:
    n, h, w = p.shape
    h4, w4 = h // 4, w // 4
    return p[:, : h4 * 4, : w4 * 4].reshape(n, h4, 4, w4, 4).sum(dim=(2, 4))


def _group(a: torch.Tensor) -> torch.Tensor:
    return a[:, :-1, :-1] + a[:, :-1, 1:] + a[:, 1:, :-1] + a[:, 1:, 1:]


def ssim_windows(ref: torch.Tensor, dist: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """(N, H, W) pair on the 8-bit scale -> (N, H/4-1, W/4-1) f32 window
    SSIM values, one rounding per operation in the JAX package's order."""
    c1, c2 = (torch.tensor(float(np.float32(c)), dtype=torch.float32,
                           device=ref.device)
              for c in scaled_ssim_constants(bit_depth))
    r = ref.float()
    d = dist.float()
    s1 = _block_sums(r)
    s2 = _block_sums(d)
    ss = _block_sums(r * r) + _block_sums(d * d)
    s12 = _block_sums(r * d)
    fs1, fs2, fss, fs12 = _group(s1), _group(s2), _group(ss), _group(s12)
    vars_ = fss * 64.0 - fs1 * fs1 - fs2 * fs2
    covar = fs12 * 64.0 - fs1 * fs2
    num = (2.0 * fs1 * fs2 + c1) * (2.0 * covar + c2)
    den = (fs1 * fs1 + fs2 * fs2 + c1) * (vars_ + c2)
    return num / den


def ssim_sse_plane_plain(ref: torch.Tensor, dist: torch.Tensor, bit_depth: int = 8):
    """(N, H, W) pair -> ((N,) f32 SSIM, (N,) float64 SSE): the plain twin
    of the ``ssim_sse_plane`` kernel, and the counterpart of both
    ``ssim_plane_batched`` (:49) and ``ssim_sse_plane`` (:88) of
    pqa2_tpu/ops/ssim.py."""
    win = ssim_windows(ref, dist, bit_depth)
    ssim = (win.double().sum(dim=(-2, -1)) / (win.shape[-2] * win.shape[-1])).float()
    return ssim, _sse(ref, dist)


def ssim_db_np(ssim):
    """Host-side dB form, as pqa2_tpu/ops/ssim.py:78."""
    ssim = np.asarray(ssim, dtype=np.float64)
    return np.where(
        ssim >= 1.0, np.inf, -10.0 * np.log10(np.maximum(1.0 - ssim, 1e-30)))
