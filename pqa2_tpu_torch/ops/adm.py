"""Float ADM2 over four db2 levels — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/adm.py`` (the XLA twin of the TPU's
``adm_level_pallas``) and the plain twin of kernel 6 (``csrc/adm.cu``,
wrapper ``ops/cuda_adm.py:adm_level``). Per level, in f32: the db2 DWT of
ref and dist, decoupling into restoration and additive parts with the
1-degree angle test, the Watson CSF factors, the 3x3 masking threshold
(centre doubled, /30, symmetric borders), and the cube sums of the masked
restoration (num) and of the CSF-weighted reference bands (den) over the
core trimmed by :func:`_trim`.

:func:`adm_level_plain_float` has the kernel's contract; :func:`adm_from_level_sums`
is the cbrt and stabiliser tail of ``pqa2_tpu/ops/pallas_adm.py:293-323``:
the six sums of each level enter the cube root as f32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from pqa2_tpu_torch.golden.adm import BORDER_FACTOR, COS_1DEG_SQ, NUM_LEVELS, csf_rfactors
from pqa2_tpu_torch.golden.filters import symmetric_index
from pqa2_tpu_torch.ops.filters import _index, dwt2_batched

BANDS = ("h", "v", "d")


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true f32 division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead)."""
    return x / x.new_tensor(d)


def _decouple(o: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor], gain_limit: float):
    """Split the distorted detail bands into restoration + additive
    (pqa2_tpu/ops/adm.py:29); the angle flag treats near-parallel (h, v)
    gradient vectors (< 1 degree) as a contrast change."""
    oh, ov = o["h"], o["v"]
    th, tv = t["h"], t["v"]
    ot_dp = oh * th + ov * tv
    o_mag_sq = oh * oh + ov * ov
    t_mag_sq = th * th + tv * tv
    angle_flag = (ot_dp >= 0.0) & (ot_dp * ot_dp >= COS_1DEG_SQ * o_mag_sq * t_mag_sq)

    rst: Dict[str, torch.Tensor] = {}
    add: Dict[str, torch.Tensor] = {}
    for band in BANDS:
        ob, tb = o[band], t[band]
        nz = ob != 0.0
        k = torch.where(nz, tb / torch.where(nz, ob, 1.0), 0.0)
        k = torch.clamp(k, 0.0, 1.0)
        r = k * ob
        gained = r * gain_limit
        r_flag = torch.where(tb > 0.0, torch.minimum(gained, tb),
                             torch.where(tb < 0.0, torch.maximum(gained, tb), tb))
        r = torch.where(angle_flag, r_flag, r)
        rst[band] = r
        add[band] = tb - r
    return rst, add


def _cm_threshold(csf_add: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masking threshold: the 3x3 sum (centre counted twice) of
    |csf(additive)| per band, symmetric borders, summed over the three
    bands and divided by 30 (pqa2_tpu/ops/adm.py:60)."""
    total = None
    for band in BANDS:
        x = csf_add[band].abs()
        h, w = x.shape[-2], x.shape[-1]
        p = _pad1_symmetric(x)
        s = None
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                term = p[:, di: di + h, dj: dj + w]
                s = term if s is None else s + term
        s = s + x  # centre counted twice
        total = s if total is None else total + s
    return _div(total, 30.0)


def _pad1_symmetric(x: torch.Tensor) -> torch.Tensor:
    """x with a one-sample symmetric border on both spatial axes."""
    h, w = x.shape[-2], x.shape[-1]
    ri = _index(symmetric_index(np.arange(-1, h + 1), h), x.device)
    ci = _index(symmetric_index(np.arange(-1, w + 1), w), x.device)
    return x.index_select(-2, ri).index_select(-1, ci)


def _trim(w: int) -> int:
    return max(int(w * BORDER_FACTOR - 0.5), 0)


def _core(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    top, left = _trim(h), _trim(w)
    return x[:, top: h - top, left: w - left]


def _cube_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,) f32 sum of |x|^3 over the trimmed core."""
    c = _core(x).abs()
    return (c * c * c).sum(dim=(-2, -1))


def _stabiliser(h: int, w: int) -> float:
    """(n_core / 32)^(1/3) of an (h, w) band."""
    th, tw = _trim(h), _trim(w)
    return float((h - 2 * th) * (w - 2 * tw) / 32.0) ** (1.0 / 3.0)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of f32 values >= 0, rounded once to f32 (torch has no
    cbrt; the power is taken in float64)."""
    return torch.pow(x.double(), 1.0 / 3.0).float()


def _sum_cube(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N,) cbrt(cube sum over the central region) +
    cbrt(n/32) (pqa2_tpu/ops/adm.py:82)."""
    return cbrt(_cube_sum(x)) + _stabiliser(x.shape[-2], x.shape[-1])


def _level_bands(ref: torch.Tensor, dist: torch.Tensor, level: int, gain_limit: float):
    """One level: the DWT bands, the CSF-weighted masked restoration and
    reference bands per detail band, and the two approximation bands."""
    o = dwt2_batched(ref)
    t = dwt2_batched(dist)
    rst, add = _decouple(o, t, gain_limit)
    factors = dict(zip(BANDS, csf_rfactors(level)))
    mt = _cm_threshold({b: add[b] * factors[b] for b in BANDS})
    out = {}
    for b in BANDS:
        masked = torch.clamp((rst[b] * factors[b]).abs() - mt, min=0.0)
        out[b] = (masked, o[b] * factors[b])
    return out, o["a"], t["a"]


def adm_level_plain_float(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    level: int,
    gain_limit: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ADM level, the plain twin of kernel 6.

    ref/dist (N, H, W) f32 approximation planes entering the level ->
    ``(sums (N, 6) f32, a_ref, a_dist)``: the cube sums in the order
    ``[num_h, den_h, num_v, den_v, num_d, den_d]`` and the next level's
    (N, ceil(H/2), ceil(W/2)) approximation bands."""
    bands, a_ref, a_dist = _level_bands(ref, dist, level, gain_limit)
    sums = []
    for b in BANDS:
        masked, csf_o = bands[b]
        sums += [_cube_sum(masked), _cube_sum(csf_o)]
    return torch.stack(sums, dim=-1), a_ref, a_dist


def adm_from_level_sums(sums: List[torch.Tensor], h: int, w: int) -> torch.Tensor:
    """Per-level (N, 6) f32 cube sums -> (N,) f32 adm2: each sum's cube root
    plus the level's stabiliser, in pqa2_tpu/ops/pallas_adm.py:310-323's
    order."""
    n = sums[0].shape[0]
    num = torch.zeros(n, dtype=torch.float32, device=sums[0].device)
    den = torch.zeros_like(num)
    h2, w2 = h, w
    for s in sums:
        h2, w2 = (h2 + 1) // 2, (w2 + 1) // 2
        stab = _stabiliser(h2, w2)
        for b in range(3):
            num = num + cbrt(s[:, 2 * b]) + stab
            den = den + cbrt(s[:, 2 * b + 1]) + stab
    eps = 1e-10 * (w * h) / (1920.0 * 1080.0)
    return (num + eps) / (den + eps)


def adm_features_batched(
    ref: torch.Tensor, dist: torch.Tensor, gain_limit: float = 100.0
) -> torch.Tensor:
    """(N, H, W) luma pair -> (N,) adm2 (pqa2_tpu/ops/adm.py:92)."""
    ref = ref.float()
    dist = dist.float()
    h, w = ref.shape[-2], ref.shape[-1]
    num = 0.0
    den = 0.0
    cur_r, cur_d = ref, dist
    for lvl in range(NUM_LEVELS):
        bands, cur_r, cur_d = _level_bands(cur_r, cur_d, lvl, gain_limit)
        for b in BANDS:
            masked, csf_o = bands[b]
            num = num + _sum_cube(masked)
            den = den + _sum_cube(csf_o)
    eps = 1e-10 * (w * h) / (1920.0 * 1080.0)
    return (num + eps) / (den + eps)
