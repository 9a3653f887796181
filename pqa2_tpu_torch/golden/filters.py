# Copy of pqa2_tpu/golden/filters.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Shared filter-bank definitions for the VMAF feature kernels.

The VIF Gaussian filter bank and the motion blur kernel are normalised
Gaussians with n = 2^(4-scale) + 1 taps and sigma = n/5 — regenerating them
from the formula (rather than hard-coding decimal tables) keeps them exact in
float64 and lets the Pallas kernels share a single source of truth.
"""

from __future__ import annotations

import numpy as np

VIF_NUM_SCALES = 4


def gaussian_taps(n: int, sigma: float, dtype=np.float64) -> np.ndarray:
    """Normalised symmetric Gaussian, matching the classic VIF filter bank."""
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    w /= w.sum()
    return w.astype(dtype)


def vif_filter(scale: int, dtype=np.float64) -> np.ndarray:
    """Per-scale VIF window: 17/9/5/3 taps for scales 0..3."""
    n = 2 ** (4 - scale) + 1
    return gaussian_taps(n, n / 5.0, dtype=dtype)


# 5-tap blur used by the motion feature (same window as VIF scale 2).
def motion_filter(dtype=np.float64) -> np.ndarray:
    return vif_filter(2, dtype=dtype)


# Daubechies-2 orthonormal wavelet pair used by ADM's 4-level DWT.
# h0 = (1+sqrt(3))/(4*sqrt(2)) etc.; these analytic forms equal the familiar
# 0.4829629131/0.8365163037/0.2241438680/-0.1294095226 decimals exactly.
_SQ3 = np.sqrt(3.0)
_DEN = 4.0 * np.sqrt(2.0)
DB2_LO = np.array(
    [(1 + _SQ3) / _DEN, (3 + _SQ3) / _DEN, (3 - _SQ3) / _DEN, (1 - _SQ3) / _DEN],
    dtype=np.float64,
)
# Highpass via alternating-sign flip (quadrature mirror).
DB2_HI = np.array(
    [DB2_LO[3], -DB2_LO[2], DB2_LO[1], -DB2_LO[0]], dtype=np.float64
)


def reflect_index(j: np.ndarray, n: int) -> np.ndarray:
    """Mirror-without-edge-repeat ('reflect'): -1 -> 1, n -> n-2.

    Matches the border convention of the VIF/motion separable convolutions.
    """
    j = np.abs(j)
    j = np.where(j >= n, 2 * n - j - 2, j)
    return np.clip(j, 0, n - 1)


def symmetric_index(j: np.ndarray, n: int) -> np.ndarray:
    """Mirror-with-edge-repeat ('symmetric'): -1 -> 0, n -> n-1.

    Used by the ADM DWT border extension.
    """
    j = np.where(j < 0, -j - 1, j)
    j = np.where(j >= n, 2 * n - j - 1, j)
    return np.clip(j, 0, n - 1)


def filter1d_axis0(img: np.ndarray, taps: np.ndarray, border: str) -> np.ndarray:
    """Correlate along axis 0 with mirrored border handling (float64)."""
    idx_fn = reflect_index if border == "reflect" else symmetric_index
    n = img.shape[0]
    half = len(taps) // 2
    js = np.arange(n)[None, :] + (np.arange(len(taps)) - half)[:, None]
    js = idx_fn(js, n)  # (taps, n)
    return np.einsum("t,tij->ij", taps, img[js, :])


def sep_filter2d(img: np.ndarray, taps: np.ndarray, border: str = "reflect"):
    """Separable 2-D correlation with mirrored borders (float64)."""
    out = img.astype(np.float64, copy=False)
    out = filter1d_axis0(out, taps, border)
    out = filter1d_axis0(out.T, taps, border).T
    return out
