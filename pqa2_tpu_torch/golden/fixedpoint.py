# Copy of pqa2_tpu/golden/fixedpoint.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Fixed-point constants for the integer feature path.

libvmaf's default extractors are the ``VMAF_integer_feature_*`` family
(models/vmaf_v0.6.1.json feature_dict; invoked by the reference through the
lavfi filter string, app/vmaf_analyzer.py:406): uint pixel pipelines with
Q16 filter taps and explicit rounding shifts.  This module holds the Q16
tables and the rounding-schedule constants shared by the integer oracles
(golden/vif_int.py, golden/motion_int.py, golden/adm_int.py) and the device
ops (ops/*_int.py).

Derivation of the tables: each is the per-scale Gaussian window
(n = 2^(4-scale)+1 taps, sigma = n/5 — golden/filters.py:vif_filter)
quantised to Q16 (round(tap * 65536)) with the centre tap adjusted by +-1..2
so each window sums to exactly 65536 — the scheme libvmaf's integer tables
follow.  ``_check_tables`` asserts both properties against the analytic
filters at import, so the fixed-point bank can never drift from the float
bank.
"""

from __future__ import annotations

import numpy as np

from pqa2_tpu_torch.golden.filters import DB2_HI, DB2_LO, vif_filter

Q16_ONE = 65536

# Q16 VIF filter bank, scales 0..3 (17/9/5/3 taps). The 5-tap scale-2 window
# doubles as the motion blur filter (same sharing as the float bank,
# golden/filters.py:motion_filter).
VIF_FILTERS_Q16 = {
    0: np.array(
        [489, 935, 1640, 2640, 3896, 5274, 6547, 7455, 7784,
         7455, 6547, 5274, 3896, 2640, 1640, 935, 489],
        dtype=np.int64,
    ),
    1: np.array(
        [1244, 3663, 7925, 12590, 14692, 12590, 7925, 3663, 1244],
        dtype=np.int64,
    ),
    2: np.array([3571, 16004, 26386, 16004, 3571], dtype=np.int64),
    3: np.array([10904, 43728, 10904], dtype=np.int64),
}

MOTION_FILTER_Q16 = VIF_FILTERS_Q16[2]

# Q16 pixel^2 representation of the VIF noise floor sigma_nsq = 2.0
# (golden/vif.py:SIGMA_NSQ).
SIGMA_NSQ_Q16 = 2 * Q16_ONE

# Q15 Daubechies-2 pair for the integer ADM DWT: round(tap * 32768) of the
# float bank (golden/filters.py:DB2_LO/DB2_HI) — the same quantisation
# libvmaf's integer ADM tables use.
Q15_ONE = 32768


def _q15(taps: np.ndarray) -> np.ndarray:
    return np.round(taps * Q15_ONE).astype(np.int64)


# Integer ADM DWT Q-schedule: band fractional bits per level (input pixels
# are shifted to Q4; level 3's row pass drops one bit so every accumulation
# Σ |q15 tap| * value stays inside int32 — see golden/adm_int.py).
ADM_BAND_Q = (4, 4, 4, 3)


DB2_LO_Q15 = _q15(DB2_LO)
DB2_HI_Q15 = _q15(DB2_HI)


# -- integer ADM tail (CSF / contrast masking / pooling) schedule -----------
#
# libvmaf's integer_adm runs the whole tail in fixed point (per-scale
# fixed-point rfactors, integer masking accumulation, uint64 cube-sum
# pooling with a float cbrt at the end). This is the same architecture
# with this repo's band-Q schedule; the rounding placement is documented
# here and pinned bit-for-bit between the oracle and the device twins
# (it cannot be cross-checked against a libvmaf binary in this
# environment — docs/CALIBRATION.md).
#
#   icsf   = (band * IRF + 2^12) >> 13            signed, |icsf| < 2^18
#   thr    = trunc(S / 30), S = 3x3 centre-doubled sum of |icsf(add)|
#            over the three bands (S < 30 * 2^18 < 2^23, exact in i32)
#   masked = max(|icsf(rst)| - thr, 0)
#   cube domain: v = (x + 2^(D-1)) >> D, D = ADM_CUBE_SHIFT (+ extra for
#            cores beyond 2^21 px) so v <= 2^14 and sums of v^3 over the
#            border-trimmed core stay under 2^63 (exact uint64).
#   pool   = cbrt_f32(S_f32) * 2^(D - F_level) + stab   (f32; the scale is
#            a power of two so the multiply is exact)
#
# IRF holds round(rfactor * 2^e) per level with e chosen so the binding
# h/v entry lands in [2^14, 2^15); F_level = ADM_BAND_Q[lvl] + e - 13 is
# the fractional precision of icsf on the 8-bit csf scale (11/9/8/6 bits
# for levels 0..3). One shared e per level keeps the three bands on one
# scale so the masking threshold can sum them.

ADM_CSF_SHIFT = 13
ADM_CUBE_SHIFT = 4


def adm_tail_tables():
    """Per level: ((irf_h, irf_v, irf_d), F_level). Derived from the float
    CSF rfactors (golden/adm.py:csf_rfactors) at import so the fixed-point
    tail can never drift from the analytic Watson model."""
    import math

    from pqa2_tpu_torch.golden.adm import NUM_LEVELS, csf_rfactors

    tables = []
    for lvl in range(NUM_LEVELS):
        fh, fv, fd = csf_rfactors(lvl)
        e = 14 - math.floor(math.log2(fh))
        while round(fh * 2.0**e) >= 32768:
            e -= 1
        while round(fh * 2.0**e) < 16384:
            e += 1
        irf = tuple(int(round(f * 2.0**e)) for f in (fh, fv, fd))
        assert max(irf) < 32768 and min(irf) > 0, (lvl, irf)
        tables.append((irf, ADM_BAND_Q[lvl] + e - ADM_CSF_SHIFT))
    return tables


ADM_TAIL_TABLES = adm_tail_tables()


def adm_cube_shift(n_core: int) -> int:
    """Shift from the icsf domain (< 2^18) into the cube domain for a core
    of ``n_core`` pixels: values <= 2^14 keep sum(v^3) < 2^63 for cores up
    to 2^21 - 1 px (any frame <= 2^24 px); larger cores shed extra bits so
    the uint64 envelope is preserved (static per geometry, so the shift is
    a trace-time constant)."""
    return ADM_CUBE_SHIFT + max(0, (int(n_core).bit_length() - 21 + 2) // 3)


def digits4_to_f32(d3, d2, d1, d0):
    """The pinned uint64 -> f32 conversion chain shared by the oracle and
    the device twins: base-2^16 digits folded high-to-low with one f32
    rounding per step (every multiply by 2^16 is exact)."""
    f = np.float32(d3)
    for d in (d2, d1, d0):
        f = np.float32(f * np.float32(65536.0)) + np.float32(d)
    return np.float32(f)


def _check_tables() -> None:
    for scale, q in VIF_FILTERS_Q16.items():
        if int(q.sum()) != Q16_ONE:
            raise AssertionError(f"Q16 VIF table scale {scale} sum {q.sum()}")
        analytic = np.round(vif_filter(scale) * Q16_ONE)
        if np.max(np.abs(q - analytic)) > 2:
            raise AssertionError(
                f"Q16 VIF table scale {scale} drifts from the analytic "
                f"Gaussian: {q - analytic}"
            )


_check_tables()
