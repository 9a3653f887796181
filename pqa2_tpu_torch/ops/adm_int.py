"""Integer fixed-point ADM2 — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/adm_int.py`` and the plain twin of the CUDA
kernel in ``csrc/adm_int.cu`` (wrapper: ``ops/cuda_adm_int.py``). It follows
the int64 oracle ``pqa2_tpu/golden/adm_int.py`` directly:

  * Q15 db2 DWT, rows first (with ``extra_row_shift``) then columns,
    ``(acc + 2^(s-1)) >> s`` per 1-D pass, symmetric borders with the
    ``2i-1+f`` offset; odd sizes halve as ``(n+1)//2``;
  * integer decoupling with the f32 angle test, fixed-point CSF
    ``(band*IRF + 2^12) >> 13``, the 3x3 centre-doubled ``trunc(S/30)``
    masking threshold over a symmetric one-band halo;
  * cube-sum pooling straight into int64 over the 10 % trimmed core
    (``adm_cube_shift`` keeps each sum below 2^63).

A level produces six int64 sums per frame, shaped (N, 3, 2) as bands h/v/d
x num/den; the kernel emits exactly these. The f32 tail runs on the host in
numpy (:func:`adm_from_digit_sums`): torch has no ``cbrt``, and this is the
oracle's own arithmetic (golden/adm_int.py:270-300).

Trap 5: bands are signed. ``>>`` on int64 tensors is an arithmetic shift
(it floors), as the oracle's numpy shift is.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from pqa2_tpu_torch.golden.adm import COS_1DEG_SQ, NUM_LEVELS
from pqa2_tpu_torch.golden.filters import symmetric_index
from pqa2_tpu_torch.golden.fixedpoint import (
    ADM_BAND_Q,
    ADM_CSF_SHIFT,
    ADM_TAIL_TABLES,
    DB2_HI_Q15,
    DB2_LO_Q15,
    adm_cube_shift,
    digits4_to_f32,
)
from pqa2_tpu_torch.ops.vif_int import to_native_grid

BANDS = ("h", "v", "d")


def _trim(w: int) -> int:
    return max(int(w * 0.1 - 0.5), 0)


def band_geometry(h: int, w: int):
    """A level whose input plane is (h, w) -> (band h2, w2, trims th, tw,
    cube shift) of its h/v/d bands."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    th, tw = _trim(h2), _trim(w2)
    return h2, w2, th, tw, adm_cube_shift((h2 - 2 * th) * (w2 - 2 * tw))


def _dwt1d(x: torch.Tensor, taps: np.ndarray, dim: int,
           extra_shift: int = 0) -> torch.Tensor:
    """out[i] = (sum_f q15[f] * x[sym(2i-1+f)] + 2^(14+e)) >> (15+e)."""
    n = x.shape[dim]
    n2 = (n + 1) // 2
    js = symmetric_index(2 * np.arange(n2)[None, :] - 1 + np.arange(4)[:, None], n)
    acc = None
    for t in range(4):
        idx = torch.as_tensor(js[t], dtype=torch.int64, device=x.device)
        term = x.index_select(dim, idx) * int(taps[t])
        acc = term if acc is None else acc + term
    s = 15 + extra_shift
    return (acc + (1 << (s - 1))) >> s


def dwt2_int_batched(x: torch.Tensor, extra_row_shift: int = 0) -> Dict[str, torch.Tensor]:
    """One integer DWT level over (N, H, W) int64 -> dict(a, h, v, d)."""
    lo_r = _dwt1d(x, DB2_LO_Q15, -2, extra_row_shift)
    hi_r = _dwt1d(x, DB2_HI_Q15, -2, extra_row_shift)
    return {
        "a": _dwt1d(lo_r, DB2_LO_Q15, -1),
        "v": _dwt1d(lo_r, DB2_HI_Q15, -1),
        "h": _dwt1d(hi_r, DB2_LO_Q15, -1),
        "d": _dwt1d(hi_r, DB2_HI_Q15, -1),
    }


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(float(np.float32(v)), dtype=torch.float32)


def angle_flags(o: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The <1-degree test in f32 on the integer bands
    (golden/adm_int.py:angle_flags_f32), every product rounded on its own."""
    oh, ov = o["h"].float(), o["v"].float()
    th, tv = t["h"].float(), t["v"].float()
    ot_dp = oh * th + ov * tv
    cos_sq = _f32(COS_1DEG_SQ).to(oh.device)
    return (ot_dp >= 0.0) & (
        ot_dp * ot_dp >= cos_sq * (oh * oh + ov * ov) * (th * th + tv * tv))


def decouple_int_batched(o: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor],
                         gain_limit: float):
    """Integer decoupling (golden/adm_int.py:decouple_int) -> (rst, add)."""
    angle = angle_flags(o, t)
    rst, add = {}, {}
    for band in BANDS:
        ob, tb = o[band], t[band]
        oa, ta = ob.abs(), tb.abs()
        same_sign = (ob > 0) == (tb > 0)
        k = torch.where(
            (oa > 0) & same_sign & (tb != 0),
            torch.clamp((ta << 15) // oa.clamp_min(1), max=32768),
            torch.zeros_like(oa))
        r = torch.sign(ob) * ((k * oa + (1 << 14)) >> 15)
        if float(gain_limit) == 1.0:
            gained = r
        else:
            gained = torch.round(r.float() * _f32(gain_limit).to(r.device)).long()
        r_flag = torch.where(tb > 0, torch.minimum(gained, tb),
                             torch.where(tb < 0, torch.maximum(gained, tb), tb))
        r = torch.where(angle, r_flag, r)
        rst[band] = r
        add[band] = tb - r
    return rst, add


def _icsf(band: torch.Tensor, irf: int) -> torch.Tensor:
    return (band * int(irf) + (1 << (ADM_CSF_SHIFT - 1))) >> ADM_CSF_SHIFT


def _cm_thr(icsf_a: Dict[str, torch.Tensor]) -> torch.Tensor:
    """trunc(S / 30), S the 3x3 centre-doubled sum of |icsf(add)| over the
    three bands, symmetric one-band halo (golden/adm_int.py:_cm_thr_int)."""
    total = None
    for band in BANDS:
        x = icsf_a[band].abs()
        h, w = x.shape[-2], x.shape[-1]
        ri = torch.as_tensor(symmetric_index(np.arange(-1, h + 1), h), device=x.device)
        ci = torch.as_tensor(symmetric_index(np.arange(-1, w + 1), w), device=x.device)
        p = x.index_select(-2, ri).index_select(-1, ci)
        s = x.clone()
        for di in range(3):
            for dj in range(3):
                s = s + p[:, di: di + h, dj: dj + w]
        total = s if total is None else total + s
    return total // 30


def _cube_sum(x: torch.Tensor, th: int, tw: int, d_shift: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    v = (x[:, th: h - th, tw: w - tw] + (1 << (d_shift - 1))) >> d_shift
    return (v * v * v).sum(dim=(-2, -1))


def adm_level_plain(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    level: int,
    extra_row_shift: int,
    gain_limit: float,
):
    """One ADM level, the plain twin of the ``adm_int_level`` kernel.

    ref/dist: (N, H, W) int32 approximation planes (Q4 codes at level 0).
    Returns ``(sums (N, 3, 2) int64, ref_a, dist_a)``: the cube sums of the
    masked restoration (num) and of |icsf(ref band)| (den) for bands
    h/v/d, and the next level's int32 approximation planes."""
    o = dwt2_int_batched(ref.long(), extra_row_shift)
    t = dwt2_int_batched(dist.long(), extra_row_shift)
    rst, add = decouple_int_batched(o, t, gain_limit)
    irf, _ = ADM_TAIL_TABLES[level]
    icsf_a = {b: _icsf(add[b], irf[i]) for i, b in enumerate(BANDS)}
    thr = _cm_thr(icsf_a)
    _, _, th, tw, d = band_geometry(ref.shape[-2], ref.shape[-1])
    sums = []
    for i, b in enumerate(BANDS):
        masked = (_icsf(rst[b], irf[i]).abs() - thr).clamp_min(0)
        sums.append(torch.stack([_cube_sum(masked, th, tw, d),
                                 _cube_sum(_icsf(o[b], irf[i]).abs(), th, tw, d)],
                                dim=-1))
    return (torch.stack(sums, dim=1), o["a"].to(torch.int32),
            t["a"].to(torch.int32))


def level_input(x: torch.Tensor, bit_depth: int) -> Tuple[torch.Tensor, int]:
    """Luma -> (level-0 int32 input, level-0 extra row shift): native codes
    shifted up to Q4, or folded into level 0's first rounding for depths
    past 12 (golden/adm_int.py:dwt_pyramid_int)."""
    codes, in_q = to_native_grid(x, bit_depth)
    return (codes << max(ADM_BAND_Q[0] - in_q, 0)).contiguous(), max(in_q - ADM_BAND_Q[0], 0)


def adm_cascade(ref: torch.Tensor, dist: torch.Tensor, *, gain_limit: float,
                bit_depth: int, level_fn: Callable) -> np.ndarray:
    """The four-level ADM cascade around a per-level function -> (N,
    NUM_LEVELS, 3, 2) int64 cube sums on the host."""
    r, drop = level_input(ref, bit_depth)
    d, _ = level_input(dist, bit_depth)
    out = []
    for lvl in range(NUM_LEVELS):
        if lvl:
            drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
        sums, r, d = level_fn(r, d, level=lvl, extra_row_shift=drop,
                              gain_limit=gain_limit)
        out.append(sums)
    return torch.stack(out, dim=1).cpu().numpy()


def digits_from_sums(sums: np.ndarray) -> np.ndarray:
    """int64 sums -> base-2^16 digits (..., 4) high to low
    (golden/adm_int.py:_cube_digits)."""
    s = np.asarray(sums, dtype=np.int64)
    return np.stack([(s >> 48) & 0xFFFF, (s >> 32) & 0xFFFF,
                     (s >> 16) & 0xFFFF, s & 0xFFFF], axis=-1)


def adm_from_digit_sums(digits: np.ndarray, h: int, w: int) -> np.ndarray:
    """(N, NUM_LEVELS, 3, 2, 4) digits -> (N,) float32 adm2, the oracle's
    f32 tail vectorised over frames (golden/adm_int.py:adm_from_digit_sums):
    the pinned digit fold, ``np.cbrt`` in float32, the power-of-two scale,
    the stabiliser, one rounding per step.

    Trap 8: torch has no cbrt, and JAX's is ``jnp.cbrt`` in f32; this host
    tail is the oracle's, within a float32 ulp of JAX's (adm2 atol 2e-6)."""
    digits = np.asarray(digits)
    n = digits.shape[0]
    num = np.zeros(n, dtype=np.float32)
    den = np.zeros(n, dtype=np.float32)
    h2, w2 = h, w
    for lvl in range(NUM_LEVELS):
        h2, w2, th, tw, dshift = band_geometry(h2, w2)
        n_core = (h2 - 2 * th) * (w2 - 2 * tw)
        _, f_level = ADM_TAIL_TABLES[lvl]
        scale = np.float32(2.0 ** (dshift - f_level))
        stab = np.float32(float(n_core / 32.0) ** (1.0 / 3.0))
        for i in range(3):
            sn = digits4_to_f32(*np.moveaxis(digits[:, lvl, i, 0], -1, 0))
            sd = digits4_to_f32(*np.moveaxis(digits[:, lvl, i, 1], -1, 0))
            num = (num + (np.cbrt(sn) * scale).astype(np.float32)).astype(np.float32)
            num = (num + stab).astype(np.float32)
            den = (den + (np.cbrt(sd) * scale).astype(np.float32)).astype(np.float32)
            den = (den + stab).astype(np.float32)
    eps = np.float32(1e-10 * (w * h) / (1920.0 * 1080.0))
    return ((num + eps).astype(np.float32) / (den + eps).astype(np.float32)).astype(np.float32)


def adm_features_int_batched(ref: torch.Tensor, dist: torch.Tensor,
                             gain_limit: float = 100.0,
                             bit_depth: int = 8) -> torch.Tensor:
    """(N, H, W) luma pair -> (N,) f32 adm2, plain version
    (pqa2_tpu/ops/adm_int.py:349)."""
    sums = adm_cascade(ref, dist, gain_limit=gain_limit, bit_depth=bit_depth,
                       level_fn=adm_level_plain)
    adm = adm_from_digit_sums(digits_from_sums(sums), ref.shape[-2], ref.shape[-1])
    return torch.as_tensor(adm, device=ref.device)
