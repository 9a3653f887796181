"""Optional motion compensation (port of pqa2_tpu/align/motioncomp.py).

Per-frame *global* translation estimation by phase correlation on
``device`` (``torch.fft``, in chunks of frames) and integer-pixel
compensation on the host. Capture chains misregister by a constant or
slowly-drifting offset (scaler pipelines, HDMI crop), which is exactly the
component a global estimate removes. ``compensate`` and
``motion_compensate_clip`` are the JAX module's numpy code.
"""

from __future__ import annotations

import logging
from typing import Tuple, Union

import numpy as np
import torch

from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

logger = logging.getLogger(__name__)

# Frame pairs correlated at a time: each 1080p pair holds several complex64
# spectra of ~8.3 MB.
CHUNK = 32


def _phase_corr_surface(ref: torch.Tensor, mov: torch.Tensor) -> torch.Tensor:
    """(N, H, W) pairs -> (N, H, W) phase-correlation surfaces, f32."""
    f1 = torch.fft.rfft2(ref.float())
    f2 = torch.fft.rfft2(mov.float())
    cross = f1 * torch.conj(f2)
    cross = cross / (torch.abs(cross) + 1e-9)
    return torch.fft.irfft2(cross, s=ref.shape[-2:])


def estimate_shifts(ref, mov, max_shift: int = 32, *,
                    device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Per-frame (dy, dx) such that shifting `mov` by it aligns to `ref`.

    ``ref``/``mov``: (N, H, W) numpy arrays or tensors (a tensor on
    ``device`` is read where it lies). Returns (N, 2) int array; shifts
    beyond max_shift are treated as spurious peaks and zeroed. Only each
    surface's peak index comes back to the host (the first maximum, as the
    JAX package's argmax takes it).
    """
    device = resolve_device(device)
    h, w = ref.shape[-2:]
    peaks = []
    for s in range(0, ref.shape[0], CHUNK):
        surf = _phase_corr_surface(upload(ref[s : s + CHUNK], device),
                                   upload(mov[s : s + CHUNK], device))
        peaks.append(surf.flatten(1).argmax(dim=1).cpu())
    flat = torch.cat(peaks).numpy()
    dy = flat // w
    dx = flat % w
    # wrap-around -> signed shifts
    dy = np.where(dy > h // 2, dy - h, dy)
    dx = np.where(dx > w // 2, dx - w, dx)
    bad = (np.abs(dy) > max_shift) | (np.abs(dx) > max_shift)
    dy = np.where(bad, 0, dy)
    dx = np.where(bad, 0, dx)
    return np.stack([dy, dx], axis=1).astype(np.int32)


def compensate(frames: np.ndarray, shifts: np.ndarray,
               fill: str = "edge") -> np.ndarray:
    """Shift each (H, W) frame by its (dy, dx); vacated pixels take the edge
    value (roll + edge overwrite) so metric windows see no wrap artefacts."""
    out = np.empty_like(frames)
    for i, (dy, dx) in enumerate(shifts):
        f = np.roll(frames[i], (int(dy), int(dx)), axis=(0, 1))
        if fill == "edge":
            if dy > 0:
                f[:dy, :] = f[dy : dy + 1, :]
            elif dy < 0:
                f[dy:, :] = f[dy - 1 : dy, :]
            if dx > 0:
                f[:, :dx] = f[:, dx : dx + 1]
            elif dx < 0:
                f[:, dx:] = f[:, dx - 1 : dx]
        out[i] = f
    return out


def motion_compensate_clip(
    ref_luma: np.ndarray, cap_luma: np.ndarray, max_shift: int = 32, *,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Compensate an aligned capture window against its reference frames.

    Returns (compensated_capture, shifts). Equal-length inputs required.
    """
    if ref_luma.shape != cap_luma.shape:
        raise ValueError("motion compensation expects aligned equal shapes")
    shifts = estimate_shifts(ref_luma, cap_luma, max_shift=max_shift, device=device)
    if np.any(shifts != 0):
        logger.info(
            "motion compensation: median shift dy=%d dx=%d",
            int(np.median(shifts[:, 0])), int(np.median(shifts[:, 1])),
        )
    return compensate(cap_luma, shifts), shifts
