# Frozen copy of the NumPy oracle golden/adm_int.py of the port, imports pointed
# at this package: the benchmark's reference imports nothing of the program.
"""Integer fixed-point ADM2 — oracle.

Emulates libvmaf's ``VMAF_integer_feature_adm2`` extractor architecture in
fixed point END TO END — every band-domain stage is deterministic integer
arithmetic with a pinned rounding placement (bit-for-bit identical in
ops/adm_int.py and ops/pallas_adm_int.py):

  * 4-level db2 DWT with Q15 taps (golden/fixedpoint.py:DB2_LO_Q15),
    symmetric borders, (acc + 2^14) >> 15 rounding per 1-D pass.
    Band Q-schedule ADM_BAND_Q = (4,4,4,3): pixels enter at Q4 and level
    3's row pass drops one bit, keeping every accumulation
    sum(|q15 tap|) * |value| < 2^31.
  * decoupling: k = trunc((|t| << 15) / |o|) clipped to [0, 32768] (0 when
    signs differ or o == 0), restoration r = sign(o) * ((k*|o| + 2^14)
    >> 15), additive = t - r.  The < 1-degree angle test runs on the
    integer bands in float (its products need 64+ bits; boundary flips are
    measure-zero).
  * CSF: icsf = (band * IRF + 2^12) >> 13 with the per-level fixed-point
    rfactors IRF (golden/fixedpoint.py:ADM_TAIL_TABLES — round(rfactor *
    2^e), shared e per level so the three bands stay on one scale).
  * contrast masking: thr = trunc(S / 30) where S is the 3x3
    centre-doubled sum of |icsf(additive)| over the three bands (exact in
    int32: S < 30 * 2^18); masked = max(|icsf(rst)| - thr, 0). Because
    icsf(rst) and |icsf(o)| share one cube domain, ref == dist still gives
    adm2 == 1 exactly.
  * pooling: v = (x + 2^(D-1)) >> D into the cube domain (D =
    adm_cube_shift(core px): <= 2^14 so the cube sum over the 10 %
    border-trimmed core is an exact uint64); per (level, band) the pooled
    value is cbrt_f32(f32(sum)) * 2^(D - F_level) + cbrt(n/32), with the
    f32 conversion following the pinned digits4_to_f32 chain and the
    power-of-two scale exact. adm2 = (num + eps) / (den + eps) in f32,
    eps = 1e-10 * (w*h)/(1920*1080).

libvmaf's own integer_adm follows the same schedule shape (fixed-point
rfactors, integer masking, uint64 cube accumulation, float cbrt); its exact
shift placements cannot be cross-checked without a binary in this
environment — see docs/CALIBRATION.md.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from perfbench.reference.golden.adm import COS_1DEG_SQ, NUM_LEVELS
from perfbench.reference.golden.filters import symmetric_index
from perfbench.reference.golden.fixedpoint import (
    ADM_BAND_Q,
    ADM_CSF_SHIFT,
    ADM_TAIL_TABLES,
    DB2_HI_Q15,
    DB2_LO_Q15,
    adm_cube_shift,
    digits4_to_f32,
)

_I64 = np.int64


def _dwt1d_axis0_int(x: np.ndarray, taps: np.ndarray, extra_shift: int = 0):
    """Integer filter + decimate along axis 0 (int64, exact):
    out[i] = (sum_f q15[f] * x[2i-1+f] + 2^(14+e)) >> (15 + e)."""
    n = x.shape[0]
    n2 = (n + 1) // 2
    js = 2 * np.arange(n2)[None, :] - 1 + np.arange(4)[:, None]
    js = symmetric_index(js, n)
    acc = np.zeros((n2,) + x.shape[1:], dtype=_I64)
    for t in range(4):
        acc += _I64(taps[t]) * x[js[t]]
    s = 15 + extra_shift
    return (acc + _I64(1 << (s - 1))) >> _I64(s)


def dwt2_db2_int(x: np.ndarray, extra_row_shift: int = 0):
    """One integer DWT level -> dict(a, h, v, d) (int64 bands)."""
    lo_c = _dwt1d_axis0_int(x, DB2_LO_Q15, extra_row_shift)
    hi_c = _dwt1d_axis0_int(x, DB2_HI_Q15, extra_row_shift)
    return {
        "a": _dwt1d_axis0_int(lo_c.T, DB2_LO_Q15).T,
        "v": _dwt1d_axis0_int(lo_c.T, DB2_HI_Q15).T,
        "h": _dwt1d_axis0_int(hi_c.T, DB2_LO_Q15).T,
        "d": _dwt1d_axis0_int(hi_c.T, DB2_HI_Q15).T,
    }


def dwt_pyramid_int(
    x: np.ndarray, bit_depth: int = 8
) -> List[Dict[str, np.ndarray]]:
    """Luma -> 4 levels of integer bands on the ADM_BAND_Q schedule.

    >8-bit codes carry their extra bits as fixed-point fraction: up to
    12-bit the initial shift narrows to ADM_BAND_Q[0] - (depth-8) so
    level 0 enters at Q4 on the 8-bit pixel scale. Depths 13..16 (round
    4) enter UNSHIFTED at Q(depth-8) and level 0's first 1-D pass folds
    the surplus into its rounding shift (extra = in_q - 4) — one exact
    rounding using every input bit, after which the bands are on the
    standard Q4 schedule. Device twins reproduce this bit-for-bit
    (ops/adm_int.py, ops/pallas_adm_int.py; at depth 16 their level-0
    first pass splits the i32 accumulator — value-identical)."""
    in_q = max(bit_depth - 8, 0)
    assert in_q <= 8, bit_depth
    cur = x.astype(_I64) << _I64(max(ADM_BAND_Q[0] - in_q, 0))
    out = []
    for lvl in range(NUM_LEVELS):
        if lvl:
            drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
        else:
            drop = max(in_q - ADM_BAND_Q[0], 0)
        bands = dwt2_db2_int(cur, extra_row_shift=drop)
        peak = max(max(abs(int(b.min())), int(b.max()))
                   for b in bands.values())
        assert peak < (1 << 16), peak
        out.append(bands)
        cur = bands["a"]
    return out


def decouple_int(
    o: Dict[str, np.ndarray], t: Dict[str, np.ndarray], gain_limit: float
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Integer decoupling on same-Q bands; returns integer (rst, add)."""
    angle_flag = angle_flags_f32(o, t)

    rst: Dict[str, np.ndarray] = {}
    add: Dict[str, np.ndarray] = {}
    for band in ("h", "v", "d"):
        ob = o[band].astype(_I64)
        tb = t[band].astype(_I64)
        oa = np.abs(ob)
        ta = np.abs(tb)
        same_sign = (ob > 0) == (tb > 0)
        k = np.where(
            (oa > 0) & same_sign & (tb != 0),
            np.minimum((ta << _I64(15)) // np.maximum(oa, 1), 32768),
            0,
        )
        r = np.sign(ob) * ((k * oa + _I64(1 << 14)) >> _I64(15))
        if float(gain_limit) == 1.0:
            gained = r
        else:
            gained = np.rint(
                r.astype(np.float32) * np.float32(gain_limit)
            ).astype(_I64)
        r_flag = np.where(tb > 0, np.minimum(gained, tb),
                          np.where(tb < 0, np.maximum(gained, tb), tb))
        r = np.where(angle_flag, r_flag, r)
        rst[band] = r
        add[band] = tb - r
    return rst, add


def angle_flags_f32(
    o: Dict[str, np.ndarray], t: Dict[str, np.ndarray]
) -> np.ndarray:
    """The <1-degree angle test in float32 on the integer bands — the
    documented emulation spec shared by oracle and device (the exact
    products need >64 bits). tests/test_integer.py audits its agreement
    with :func:`exact_angle_flags`."""
    oh, ov = o["h"].astype(np.float32), o["v"].astype(np.float32)
    th, tv = t["h"].astype(np.float32), t["v"].astype(np.float32)
    ot_dp = oh * th + ov * tv
    cos_sq = np.float32(COS_1DEG_SQ)
    return (ot_dp >= 0.0) & (
        ot_dp * ot_dp >= cos_sq * (oh * oh + ov * ov) * (th * th + tv * tv)
    )


def exact_angle_flags(
    o: Dict[str, np.ndarray], t: Dict[str, np.ndarray]
) -> np.ndarray:
    """The <1-degree angle test evaluated with EXACT integer arithmetic.

    ``ot_dp >= 0 and ot_dp^2 >= cos^2(1deg) * |o|^2 * |t|^2`` where both
    sides need up to ~119 bits (bands are < 2^16, cos^2 is a 53-bit dyadic
    rational M/2^53). Python bignums over the flattened bands — an audit
    tool for tests (tests/test_integer.py measures how often the f32
    evaluation the production paths share disagrees with this), not a
    production path."""
    m, e = np.frexp(COS_1DEG_SQ)
    mant = int(m * (1 << 53))  # COS_1DEG_SQ = mant * 2^(e-53), exact
    shift = int(53 - int(e))  # plain int: a numpy shift would coerce int32
    oh = o["h"].astype(object).ravel()
    ov = o["v"].astype(object).ravel()
    th = t["h"].astype(object).ravel()
    tv = t["v"].astype(object).ravel()
    out = np.zeros(oh.shape[0], dtype=bool)
    for i in range(oh.shape[0]):
        dp = int(oh[i]) * int(th[i]) + int(ov[i]) * int(tv[i])
        if dp < 0:
            continue
        omag = int(oh[i]) ** 2 + int(ov[i]) ** 2
        tmag = int(th[i]) ** 2 + int(tv[i]) ** 2
        out[i] = (dp * dp) << shift >= mant * omag * tmag
    return out.reshape(o["h"].shape)


def _icsf(band: np.ndarray, irf: int) -> np.ndarray:
    """Fixed-point CSF: (band * IRF + 2^12) >> 13, signed, |.| < 2^18."""
    return (band * _I64(irf) + _I64(1 << (ADM_CSF_SHIFT - 1))) >> _I64(
        ADM_CSF_SHIFT)


def _cm_thr_int(icsf_a: Dict[str, np.ndarray]) -> np.ndarray:
    """Integer masking threshold: trunc(S / 30) with S the 3x3 sum (centre
    doubled) of |icsf(additive)| over the three bands, symmetric borders.
    S < 30 * 2^18 < 2^23, so the division is the only rounding and it is
    exact truncation (S >= 0)."""
    total = None
    for band in ("h", "v", "d"):
        x = np.abs(icsf_a[band])
        p = np.pad(x, 1, mode="symmetric")
        s = sum(
            p[1 + di : 1 + di + x.shape[0], 1 + dj : 1 + dj + x.shape[1]]
            for di in (-1, 0, 1)
            for dj in (-1, 0, 1)
        )
        s = s + x  # centre counted twice
        total = s if total is None else total + s
    return total // _I64(30)


def _trim(w: int) -> int:
    return max(int(w * 0.1 - 0.5), 0)


def _cube_digits(x: np.ndarray, d_shift: int) -> Tuple[int, ...]:
    """Exact cube-sum pooling: x >= 0 (icsf domain, < 2^18) is rounded into
    the cube domain v = (x + 2^(D-1)) >> D (<= 2^14), cubed and summed over
    the 10 % border-trimmed core. Returns the sum's base-2^16 digits
    (d3, d2, d1, d0) — the bound sum < 2^63 is the adm_cube_shift
    envelope, so the int64 accumulation is exact."""
    h, w = x.shape
    top, left = _trim(h), _trim(w)
    v = (x[top : h - top, left : w - left]
         + _I64(1 << (d_shift - 1))) >> _I64(d_shift)
    s = int(np.sum(v * v * v))
    return ((s >> 48) & 0xFFFF, (s >> 32) & 0xFFFF,
            (s >> 16) & 0xFFFF, s & 0xFFFF)


def adm_pooled_digit_sums(
    ref: np.ndarray, dist: np.ndarray, gain_limit: float = 100.0,
    bit_depth: int = 8,
) -> np.ndarray:
    """Luma pair -> (NUM_LEVELS, 3 bands, 2 num/den, 4 digits) int32 —
    the exact integer pooled cube sums, the bit-pinning surface shared
    with the device twins (tests/test_integer.py)."""
    ref_pyr = dwt_pyramid_int(np.asarray(ref), bit_depth)
    dist_pyr = dwt_pyramid_int(np.asarray(dist), bit_depth)
    out = np.zeros((NUM_LEVELS, 3, 2, 4), dtype=np.int32)
    for lvl in range(NUM_LEVELS):
        o_i, t_i = ref_pyr[lvl], dist_pyr[lvl]
        rst_i, add_i = decouple_int(o_i, t_i, gain_limit)
        irf, _ = ADM_TAIL_TABLES[lvl]
        icsf_o = {b: _icsf(o_i[b], irf[i]) for i, b in enumerate("hvd")}
        icsf_r = {b: _icsf(rst_i[b], irf[i]) for i, b in enumerate("hvd")}
        icsf_a = {b: _icsf(add_i[b], irf[i]) for i, b in enumerate("hvd")}
        thr = _cm_thr_int(icsf_a)
        h2, w2 = o_i["h"].shape
        th, tw = _trim(h2), _trim(w2)
        d = adm_cube_shift((h2 - 2 * th) * (w2 - 2 * tw))
        for i, band in enumerate("hvd"):
            masked = np.maximum(np.abs(icsf_r[band]) - thr, 0)
            out[lvl, i, 0] = _cube_digits(masked, d)
            out[lvl, i, 1] = _cube_digits(np.abs(icsf_o[band]), d)
    return out


def adm_from_digit_sums(
    digits: np.ndarray, h: int, w: int
) -> Tuple[float, List[float], float, float]:
    """(NUM_LEVELS, 3, 2, 4) digit sums + frame dims -> (adm2,
    [level scores], num, den). All arithmetic is f32 in the device twins'
    operation order (cbrt + power-of-two scale + stabiliser per band)."""
    num = np.float32(0.0)
    den = np.float32(0.0)
    level_scores = []
    h2, w2 = h, w
    for lvl in range(NUM_LEVELS):
        h2, w2 = (h2 + 1) // 2, (w2 + 1) // 2
        th, tw = _trim(h2), _trim(w2)
        n_core = (h2 - 2 * th) * (w2 - 2 * tw)
        _, f_level = ADM_TAIL_TABLES[lvl]
        d = adm_cube_shift(n_core)
        scale = np.float32(2.0 ** (d - f_level))
        stab = np.float32(float(n_core / 32.0) ** (1.0 / 3.0))
        num0, den0 = num, den
        for i in range(3):
            sn = digits4_to_f32(*digits[lvl, i, 0])
            sd = digits4_to_f32(*digits[lvl, i, 1])
            num = np.float32(np.float32(num + np.float32(
                np.cbrt(sn) * scale)) + stab)
            den = np.float32(np.float32(den + np.float32(
                np.cbrt(sd) * scale)) + stab)
        dl = float(den - den0)
        level_scores.append(float(num - num0) / dl if dl > 0 else 1.0)
    eps = np.float32(1e-10 * (w * h) / (1920.0 * 1080.0))
    adm2 = np.float32(num + eps) / np.float32(den + eps)
    return float(adm2), level_scores, float(num), float(den)


def adm_features_int(
    ref: np.ndarray, dist: np.ndarray, gain_limit: float = 100.0,
    bit_depth: int = 8,
) -> Tuple[float, List[float], float, float]:
    """Luma pair -> (adm2, [level scores], num, den), integer path."""
    digits = adm_pooled_digit_sums(ref, dist, gain_limit, bit_depth)
    h, w = np.asarray(ref).shape
    return adm_from_digit_sums(digits, h, w)
