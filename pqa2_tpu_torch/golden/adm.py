# Copy of pqa2_tpu/golden/adm.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""ADM2 (Detail Loss Metric) — oracle.

The ``adm2`` feature of every shipped VMAF model (models/*.json
feature_dict; obtained by the reference via libvmaf,
app/vmaf_analyzer.py:406). Pipeline, per frame pair, following the DLM
construction (Li et al., "Image quality assessment by separately evaluating
detail losses and additive impairments") as realised in VMAF:

  1. 4-level Daubechies-2 DWT of ref and dist luma (symmetric border
     extension, output sample i drawing on inputs 2i-1..2i+2).
  2. Decoupling of each distorted detail coefficient t against the reference
     coefficient o into restoration rst and additive impairment add = t-rst:
         k   = clip(t/o, 0, 1)   (k = 0 when o == 0)
         rst = k * o
     where coefficients whose (H,V) gradient vector rotated < 1 degree are
     treated as contrast change (restoration):
         angle_flag: rst = t, except NEG models clamp the enhancement gain:
             t > 0: rst = min(k * o * adm_enhn_gain_limit, t)
             t < 0: rst = max(k * o * adm_enhn_gain_limit, t)
  3. CSF weighting of (a) the reference bands -> denominator and (b) the
     restored bands -> numerator, with per-(level, orientation) sensitivity
     1/Q from Watson's DWT quantisation-step model (a=0.495, k=0.466,
     f0=0.401, g_HV=1.0, g_D=0.534; viewing distance 3 display heights of
     1080 lines).
  4. Contrast masking: threshold map = sum over the three CSF'd *additive*
     bands of a 3x3 neighbourhood sum (centre counted twice) / 30; masked
     numerator coefficients = max(|csf(rst)| - threshold, 0).
  5. Pooling: per band, cbrt(sum of cubes over the central region excluding a
     10% border) + cbrt(N/32) stabiliser; adm2 = (num + eps) / (den + eps),
     eps = 1e-10 * (w*h)/(1920*1080).

Identity invariant: ref == dist gives adm2 == 1 exactly.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from pqa2_tpu_torch.golden.filters import DB2_HI, DB2_LO, symmetric_index

NUM_LEVELS = 4
VIEW_DIST = 3.0
REF_DISPLAY_HEIGHT = 1080
# Watson DWT quantisation-step model parameters (luminance row).
WATSON_A = 0.495
WATSON_K = 0.466
WATSON_F0 = 0.401
WATSON_G_HV = 1.0
WATSON_G_D = 0.534
COS_1DEG_SQ = math.cos(math.pi / 180.0) ** 2
BORDER_FACTOR = 0.1


def dwt_quant_step(level: int, g: float) -> float:
    """Watson et al. formula (1): quantisation step for one subband."""
    r = VIEW_DIST * REF_DISPLAY_HEIGHT * math.pi / 180.0
    temp = math.log10(2.0 ** (level + 1) * WATSON_F0 * g / r)
    return 2.0 * WATSON_A * 10.0 ** (WATSON_K * temp * temp) / g


def csf_rfactors(level: int) -> Tuple[float, float, float]:
    """(h, v, d) CSF multipliers (1/Q) for a 0-based DWT level."""
    f_hv = 1.0 / dwt_quant_step(level, WATSON_G_HV)
    f_d = 1.0 / dwt_quant_step(level, WATSON_G_D)
    return (f_hv, f_hv, f_d)


def _dwt1d_axis0(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Filter + decimate along axis 0: out[i] = sum_f taps[f]*x[2i-1+f]."""
    n = x.shape[0]
    n2 = (n + 1) // 2
    js = 2 * np.arange(n2)[None, :] - 1 + np.arange(4)[:, None]  # (4, n2)
    js = symmetric_index(js, n)
    return np.einsum("t,tij->ij", taps, x[js, :])


def dwt2_db2(x: np.ndarray):
    """One DWT level -> dict(a=, h=, v=, d=) with h/v/d the detail bands."""
    lo_c = _dwt1d_axis0(x, DB2_LO)
    hi_c = _dwt1d_axis0(x, DB2_HI)
    a = _dwt1d_axis0(lo_c.T, DB2_LO).T
    v = _dwt1d_axis0(lo_c.T, DB2_HI).T
    h = _dwt1d_axis0(hi_c.T, DB2_LO).T
    d = _dwt1d_axis0(hi_c.T, DB2_HI).T
    return {"a": a, "h": h, "v": v, "d": d}


def dwt_pyramid(x: np.ndarray, levels: int = NUM_LEVELS) -> List[Dict[str, np.ndarray]]:
    out = []
    cur = x.astype(np.float64)
    for _ in range(levels):
        bands = dwt2_db2(cur)
        out.append(bands)
        cur = bands["a"]
    return out


def decouple(o: Dict[str, np.ndarray], t: Dict[str, np.ndarray],
             gain_limit: float = 100.0):
    """Split distorted detail bands into restoration r and additive a."""
    oh, ov, od = o["h"], o["v"], o["d"]
    th, tv, td = t["h"], t["v"], t["d"]
    ot_dp = oh * th + ov * tv
    o_mag_sq = oh * oh + ov * ov
    t_mag_sq = th * th + tv * tv
    angle_flag = (ot_dp >= 0.0) & (ot_dp * ot_dp >= COS_1DEG_SQ * o_mag_sq * t_mag_sq)

    rst: Dict[str, np.ndarray] = {}
    add: Dict[str, np.ndarray] = {}
    for band, ob, tb in (("h", oh, th), ("v", ov, tv), ("d", od, td)):
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(ob != 0.0, tb / np.where(ob != 0.0, ob, 1.0), 0.0)
        k = np.clip(k, 0.0, 1.0)
        r = k * ob
        gained = r * gain_limit
        r_flag = np.where(tb > 0.0, np.minimum(gained, tb),
                          np.where(tb < 0.0, np.maximum(gained, tb), tb))
        r = np.where(angle_flag, r_flag, r)
        rst[band] = r
        add[band] = tb - r
    return rst, add


def apply_csf(bands: Dict[str, np.ndarray], level: int) -> Dict[str, np.ndarray]:
    fh, fv, fd = csf_rfactors(level)
    return {"h": bands["h"] * fh, "v": bands["v"] * fv, "d": bands["d"] * fd}


def cm_threshold(csf_add: Dict[str, np.ndarray]) -> np.ndarray:
    """Masking threshold: 3x3 sum (centre doubled) of |csf(additive)|,
    accumulated over the three bands, / 30. Symmetric border extension."""
    total = None
    for band in ("h", "v", "d"):
        x = np.abs(csf_add[band])
        p = np.pad(x, 1, mode="symmetric")
        s = sum(
            p[1 + di : 1 + di + x.shape[0], 1 + dj : 1 + dj + x.shape[1]]
            for di in (-1, 0, 1)
            for dj in (-1, 0, 1)
        )
        s = s + x  # centre counted twice
        total = s if total is None else total + s
    return total / 30.0


def _trim(w: int) -> int:
    return max(int(w * BORDER_FACTOR - 0.5), 0)


def sum_cube(x: np.ndarray) -> float:
    """cbrt of the cube-sum over the central region + cbrt(N/32) stabiliser."""
    h, w = x.shape
    top, left = _trim(h), _trim(w)
    bottom, right = h - top, w - left
    core = np.abs(x[top:bottom, left:right])
    n = (bottom - top) * (right - left)
    return float(np.sum(core ** 3) ** (1.0 / 3.0) + (n / 32.0) ** (1.0 / 3.0))


def adm_features(ref: np.ndarray, dist: np.ndarray,
                 gain_limit: float = 100.0):
    """Returns (adm2, [per-level scores], num, den) for one luma pair."""
    ref_pyr = dwt_pyramid(ref)
    dist_pyr = dwt_pyramid(dist)
    num = den = 0.0
    level_scores = []
    for lvl in range(NUM_LEVELS):
        o_bands, t_bands = ref_pyr[lvl], dist_pyr[lvl]
        rst, add = decouple(o_bands, t_bands, gain_limit)
        csf_o = apply_csf(o_bands, lvl)
        csf_r = apply_csf(rst, lvl)
        csf_a = apply_csf(add, lvl)
        mt = cm_threshold(csf_a)
        num_l = den_l = 0.0
        for band in ("h", "v", "d"):
            masked = np.maximum(np.abs(csf_r[band]) - mt, 0.0)
            num_l += sum_cube(masked)
            den_l += sum_cube(csf_o[band])
        num += num_l
        den += den_l
        level_scores.append(num_l / den_l if den_l > 0 else 1.0)
    h, w = ref.shape
    eps = 1e-10 * (w * h) / (1920.0 * 1080.0)
    adm2 = (num + eps) / (den + eps)
    return adm2, level_scores, num, den
