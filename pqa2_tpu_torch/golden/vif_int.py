# Copy of pqa2_tpu/golden/vif_int.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Integer fixed-point VIF — float64-free oracle for the integer path.

Emulates the fixed-point moment pipeline of libvmaf's default
``VMAF_integer_feature_vif_scale{0..3}`` extractors (the features every
integer model names in its feature_dict — models/vmaf_v0.6.1.json; invoked
by the reference via ffmpeg lavfi, app/vmaf_analyzer.py:406):

  * Q16 filter taps (golden/fixedpoint.py), reflect borders.
  * Vertical pass:  mu rounds to Q8 pixels  ((acc + 2^(s-1)) >> s with
    s = 8 + in_q); squared products round with >> 16.
  * Horizontal pass: mu accumulates to Q24 pixels (no rounding); products
    round back to Q16 pixel^2 for Q8 inputs.
  * mu^2 and mu1*mu2 round with (p + 2^31) >> 32 into Q16 pixel^2 —
    the same domain as the filtered products, so the sigma statistics are
    exact int32 differences.
  * Decimation between scales: blur with the next scale's Q16 window,
    rounding to Q8 pixels, keep even rows/columns.

The num/den statistic then follows libvmaf's integer evaluation exactly
(since round 3 — previously the logs ran smooth in float64):

  * per-pixel logs through the Q11 log2 LUT on a truncated 16-bit
    mantissa (golden/log2lut.py), accumulated as integer table values
    plus integer shift counts;
  * the gain ``g = sigma12 / (sigma1 + 65536e-10)`` and the two
    truncations ``sv = (int)(sigma2 - g*sigma12)`` /
    ``(int64)(g*g*sigma1)`` in IEEE double — numpy float64 reproduces the
    C arithmetic (single rounding per op);
  * the NEG enhancement-gain clamp applied AFTER sv — libvmaf computes
    the residual with the unclamped gain and only caps the gain credited
    to the numerator;
  * flat-reference branch (sigma1 < sigma_nsq) accumulating raw integer
    sigma2 with the final /16384/65025 scaling.

All integer arithmetic uses uint64 (bounds are asserted), so this oracle
is exact by construction and pins the device implementation
(ops/vif_int.py). Remaining deviations from a real libvmaf binary are
listed in docs/CALIBRATION.md (compiler FMA contraction inside the three
double expressions; nothing else).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pqa2_tpu_torch.golden.fixedpoint import SIGMA_NSQ_Q16, VIF_FILTERS_Q16
from pqa2_tpu_torch.golden.filters import reflect_index
from pqa2_tpu_torch.golden.log2lut import log2_table, normalize16

_U64 = np.uint64


def _reflect_rows(img: np.ndarray, half: int) -> np.ndarray:
    n = img.shape[0]
    js = reflect_index(np.arange(-half, n + half), n)
    return img[js]


def _filt_v(img: np.ndarray, taps: np.ndarray, shift: int) -> np.ndarray:
    """Vertical Q16 correlation with rounding >> shift. img uint64 (H, W)."""
    half = len(taps) // 2
    xp = _reflect_rows(img, half).astype(_U64)
    h = img.shape[0]
    acc = np.zeros_like(img, dtype=_U64)
    for t, f in enumerate(taps):
        acc += _U64(f) * xp[t : t + h]
    if shift == 0:
        return acc
    return (acc + _U64(1 << (shift - 1))) >> _U64(shift)


def _filt_h(img: np.ndarray, taps: np.ndarray, shift: int) -> np.ndarray:
    return _filt_v(img.T, taps, shift).T


def _decimate(img: np.ndarray, taps: np.ndarray, in_q: int) -> np.ndarray:
    """Blur + 2x decimation, Q{in_q} pixels in -> Q8 pixels out (uint64)."""
    tmp = _filt_v(img, taps, 8 + in_q)  # -> Q8 rows
    out = _filt_h(tmp, taps, 16)  # Q16*Q8 -> Q8
    return out[::2, ::2]


def _moments_int(
    ref: np.ndarray, dist: np.ndarray, taps: np.ndarray, in_q: int
) -> Tuple[np.ndarray, ...]:
    """Integer moment planes in Q16 pixel^2 (+ mu in Q24 pixels)."""
    v_mu_shift = 8 + in_q  # Q16*Qin -> Q8
    v_p_shift = 16  # Q16*Q(2in) -> Q(2in)
    h_p_shift = 2 * in_q  # Q16*Q(2in) -> Q16 pixel^2

    mu1 = _filt_h(_filt_v(ref, taps, v_mu_shift), taps, 0)  # Q24 pixels
    mu2 = _filt_h(_filt_v(dist, taps, v_mu_shift), taps, 0)
    xx = _filt_h(_filt_v(ref * ref, taps, v_p_shift), taps, h_p_shift)
    yy = _filt_h(_filt_v(dist * dist, taps, v_p_shift), taps, h_p_shift)
    xy = _filt_h(_filt_v(ref * dist, taps, v_p_shift), taps, h_p_shift)

    assert mu1.max(initial=0) < (1 << 32) and xx.max(initial=0) < (1 << 32)

    def sq32(a, b):  # (a*b + 2^31) >> 32 -> Q16 pixel^2
        return (a * b + _U64(1 << 31)) >> _U64(32)

    mu1_sq = sq32(mu1, mu1)
    mu2_sq = sq32(mu2, mu2)
    mu12 = sq32(mu1, mu2)
    return mu1_sq, mu2_sq, mu12, xx, yy, xy


def sigma_planes_int(
    ref: np.ndarray, dist: np.ndarray, taps: np.ndarray, in_q: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer sigma planes (int64, Q16 pixel^2 domain)."""
    mu1_sq, mu2_sq, mu12, xx, yy, xy = _moments_int(ref, dist, taps, in_q)
    sigma1 = xx.astype(np.int64) - mu1_sq.astype(np.int64)
    sigma2 = yy.astype(np.int64) - mu2_sq.astype(np.int64)
    sigma12 = xy.astype(np.int64) - mu12.astype(np.int64)
    return sigma1, sigma2, sigma12


#: The epsilon libvmaf adds to sigma1 before the gain division — the exact
#: double value of ``65536 * 1.0e-10``.
VIF_INT_EPS = np.float64(65536.0) * np.float64(1.0e-10)


def _statistic_pixel_terms(sigma1, sigma2, sigma12, gain_limit: float):
    """Per-pixel element stage of the oracle statistic.

    Returns (log_branch, num_branch, den_tab, k_den, num_tab, num_k, s2):
    the exact per-pixel LUT/shift contributions BEFORE reduction — the
    surface tests/test_boundary_flips.py compares against the device's
    ops/vif_int.py:_statistic_element to hunt for epsilon-boundary
    flips pixel by pixel."""
    tab = log2_table().astype(np.int64)
    s1 = np.maximum(sigma1, 0).astype(np.int64)
    s2 = np.maximum(sigma2, 0).astype(np.int64)
    s12 = np.asarray(sigma12, dtype=np.int64)

    log_branch = s1 >= SIGMA_NSQ_Q16
    num_branch = log_branch & (s12 >= 0)

    # --- den term: log2(sigma_nsq + sigma1) - 17, via the LUT ------------
    m_den, k_den = normalize16((SIGMA_NSQ_Q16 + s1).astype(np.uint64))
    den_tab = tab[m_den]

    # --- num term (double g, integer truncations, LUT logs) --------------
    s1f = s1.astype(np.float64)
    s12f = np.where(num_branch, s12, 0).astype(np.float64)
    g = s12f / (s1f + VIF_INT_EPS)
    sv = np.trunc(s2.astype(np.float64) - g * s12f)  # C (int32) cast
    sv = np.maximum(sv, 0.0)
    g = np.minimum(g, gain_limit)  # NEG clamp AFTER sv (libvmaf order)
    numer1 = sv.astype(np.uint64) + np.uint64(SIGMA_NSQ_Q16)
    tmp = np.trunc(g * g * s1f)  # C (int64) cast
    assert float(tmp.max(initial=0.0)) < 2.0**62
    numer1_tmp = tmp.astype(np.uint64) + numer1
    m1, k1 = normalize16(numer1_tmp)
    m2, k2 = normalize16(numer1)
    num_tab = tab[m1] - tab[m2]
    num_k = k1 - k2
    return log_branch, num_branch, den_tab, k_den, num_tab, num_k, s2


def _statistic(sigma1, sigma2, sigma12, gain_limit: float) -> Tuple[float, float]:
    """libvmaf's integer num/den statistic on Q16 sigma planes.

    LUT-quantised logs + integer accumulators; double (float64) gain and
    truncations. See the module docstring for the exact contract."""
    (log_branch, num_branch, den_tab, k_den, num_tab, num_k,
     s2) = _statistic_pixel_terms(sigma1, sigma2, sigma12, gain_limit)

    # --- integer accumulators (exact), combined in double ----------------
    accum_num_log = int(np.sum(np.where(num_branch, num_tab, 0)))
    accum_num_k = int(np.sum(np.where(num_branch, num_k, 0)))
    accum_den_log = int(np.sum(np.where(log_branch, den_tab, 0)))
    accum_den_k = int(np.sum(np.where(log_branch, k_den, 0)))
    n_log = int(np.sum(log_branch))
    n_flat = int(log_branch.size - n_log)
    accum_num_flat = int(np.sum(np.where(log_branch, 0, s2)))

    num = (accum_num_log / 2048.0 + accum_num_k
           + (n_flat - (accum_num_flat / 16384.0) / 65025.0))
    den = (accum_den_log / 2048.0 + accum_den_k - 17.0 * n_log + n_flat)
    return float(num), float(den)


def vif_features_int(
    ref: np.ndarray,
    dist: np.ndarray,
    gain_limit: float = np.inf,
    bit_depth: int = 8,
) -> List[float]:
    """uint8/uint16 luma pair -> [vif_scale0..3], integer fixed-point path.

    Native-grid high bit depth (round 3, full 10..16-bit since round 4):
    >8-bit codes enter scale 0 carrying their extra bits as fixed-point
    fraction (in_q = depth-8 on the 8-bit pixel scale — libvmaf's 16-bit
    profile shape: the scale-0 vertical mu shift becomes ``bpc``, the
    product shifts widen by 2*(depth-8), and the sigma statistic stays in
    the same Q16-pixel^2 domain with sigma_nsq unchanged). At depth 16
    (in_q = 8, codes < 2^16) scale 0 runs the SAME domain as the Q8
    decimated scales, so no new accumulator headroom is needed anywhere.
    No 8-bit-grid rounding loss by construction; rounding placement in
    the low bits is the natural generalisation of the 8-bit schedule
    (a real libvmaf binary to cross-check its 16-bit path does not exist
    here — see docs/CALIBRATION.md).
    """
    if bit_depth > 16:
        raise ValueError(f"bit_depth {bit_depth} > 16 not supported")
    ref = np.asarray(ref)
    dist = np.asarray(dist)
    ref = ref.astype(_U64)
    dist = dist.astype(_U64)

    scores = []
    in_q = max(bit_depth - 8, 0)
    for scale in range(4):
        taps = VIF_FILTERS_Q16[scale]
        if scale > 0:
            ref = _decimate(ref, taps, in_q)
            dist = _decimate(dist, taps, in_q)
            in_q = 8
        num, den = _statistic(
            *sigma_planes_int(ref, dist, taps, in_q), gain_limit
        )
        scores.append(num / den if den > 0 else 1.0)
    return scores
