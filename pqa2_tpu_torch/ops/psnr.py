"""PSNR — plain PyTorch version of ``pqa2_tpu/ops/psnr.py`` (ffmpeg psnr
filter semantics: per-plane MSE, mse_avg pooled over all planes' squared
error). The JAX package runs this in XLA on every backend, so the port runs
it as torch ops; the SSE shared with SSIM comes from ``ops/cuda_ssim.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, H, W) pair -> (N,) float64 sum of squared differences: f32
    differences squared in f32 (exact for 8-bit-scale pixels of sources up
    to 12 bits), summed in float64, where pqa2_tpu/ops/psnr.py:19 sums in
    f32."""
    d = a.float() - b.float()
    return (d * d).double().sum(dim=(-2, -1))


def psnr_from_mse_np(mse, max_value: float = 255.0):
    """Host-side dB from MSE; mse == 0 gives inf (pqa2_tpu/ops/psnr.py:33)."""
    mse = np.asarray(mse, dtype=np.float64)
    return np.where(
        mse > 0.0,
        10.0 * np.log10(max_value * max_value / np.maximum(mse, 1e-30)),
        np.inf,
    )


def psnr_planes_batched(ref_y, ref_u, ref_v, dist_y, dist_u, dist_v,
                        max_value: float = 255.0) -> Dict[str, np.ndarray]:
    """Per-frame mse_{y,u,v,avg} and psnr_{y,u,v,avg} (host numpy, (N,))."""
    out: Dict[str, np.ndarray] = {}
    total_sse = 0.0
    total_n = 0
    for name, r, d in (("y", ref_y, dist_y), ("u", ref_u, dist_u),
                       ("v", ref_v, dist_v)):
        sse = _sse(r, d).cpu().numpy()
        n = r.shape[-2] * r.shape[-1]
        out[f"mse_{name}"] = sse / n
        out[f"psnr_{name}"] = psnr_from_mse_np(sse / n, max_value)
        total_sse = total_sse + sse
        total_n += n
    out["mse_avg"] = total_sse / total_n
    out["psnr_avg"] = psnr_from_mse_np(out["mse_avg"], max_value)
    return out
