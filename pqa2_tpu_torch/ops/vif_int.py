"""Integer fixed-point VIF — the plain PyTorch version.

Counterpart of ``pqa2_tpu/ops/vif_int.py`` and the plain twin of the CUDA
kernel in ``csrc/vif_int.cu`` (wrapper: ``ops/cuda_vif_int.py``). It follows
the uint64 oracle ``pqa2_tpu/golden/vif_int.py`` directly in int64 and
float64, so none of the JAX package's uint32 split arithmetic, long
division or breakpoint tables carry over:

  * Q16 taps (``golden.fixedpoint.VIF_FILTERS_Q16``), reflect borders,
    the oracle's rounding shifts;
  * ``(a*b + 2^31) >> 32`` for the mean products (trap 1, below);
  * the exact statistic: Q11 log2 table lookups on truncated 16-bit
    mantissas (a gather from ``golden.log2lut.log2_table()``), the gain
    chain in float64, integer per-frame accumulators;
  * the final f32 combine in the JAX package's order
    (``pqa2_tpu/ops/vif_int.py:525-537``), so features agree with it bit
    for bit when the integer accumulators do.

A scale produces seven int64 accumulators per frame (``STATS``); both this
module and the kernel emit exactly these, and :func:`combine_stats` turns
them into the feature.

``exact=False`` (``precision="integer_fast"``) keeps the same integer
moments and sigma planes and swaps the LUT statistic for the JAX package's
smooth f32-log one (``pqa2_tpu/ops/vif_int.py:_statistic_fast``): a scale
then produces the per-frame f32 (num, den) sums, and the feature is
``num / den`` (:func:`fast_ratio`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pqa2_tpu_torch.golden.filters import reflect_index
from pqa2_tpu_torch.golden.fixedpoint import SIGMA_NSQ_Q16, VIF_FILTERS_Q16
from pqa2_tpu_torch.golden.log2lut import log2_table
from pqa2_tpu_torch.golden.vif_int import VIF_INT_EPS

#: Per-frame integer accumulators of one scale, in this order.
STATS = ("num_tab", "num_k", "den_tab", "den_k", "n_log", "flat_hi", "flat_lo")

_NSQ = int(SIGMA_NSQ_Q16)
_M32768 = 32768


def to_native_grid(x: torch.Tensor, bit_depth: int = 8) -> Tuple[torch.Tensor, int]:
    """Luma -> (int32 native codes, in_q), as pqa2_tpu/ops/vif_int.py:541.

    Float input is on the 8-bit scale; ``floor(x * 2^in_q + 0.5)`` (f32)
    recovers the exact native code. Integer input is taken as codes."""
    if bit_depth > 16:
        raise ValueError(f"bit_depth {bit_depth} > 16 not supported")
    in_q = max(bit_depth - 8, 0)
    if x.is_floating_point():
        codes = torch.floor(x.float() * float(1 << in_q) + 0.5)
        return codes.clamp(0, (1 << bit_depth) - 1).to(torch.int32), in_q
    return x.to(torch.int32), in_q


def scale0_codes(x: torch.Tensor, bit_depth: int = 8) -> Tuple[torch.Tensor, int]:
    """Scale 0's input: 8-bit luma as it is (uint8, in_q 0: the kernel reads
    the source's bytes and no uint8 -> int32 copy runs), anything else
    through :func:`to_native_grid`."""
    if x.dtype == torch.uint8 and bit_depth <= 8:
        return x, 0
    return to_native_grid(x, bit_depth)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def _filt(x: torch.Tensor, taps: np.ndarray, dim: int, shift: int) -> torch.Tensor:
    """Q16 correlation of int64 ``x`` along ``dim``, reflect borders
    (golden/filters.py:reflect_index), then ``(acc + 2^(s-1)) >> s``."""
    half = len(taps) // 2
    n = x.shape[dim]
    xp = x.index_select(dim, _index(reflect_index(np.arange(-half, n + half), n),
                                    x.device))
    acc = None
    for t, f in enumerate(taps):
        term = xp.narrow(dim, t, n) * int(f)
        acc = term if acc is None else acc + term
    if shift:
        acc = (acc + (1 << (shift - 1))) >> shift
    return acc


def _mul_shift32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``(a*b + 2^31) >> 32`` for 0 <= a, b < 2^32 in int64.

    Trap 1: the product passes 2^63, so a plain int64 multiply overflows
    (torch has no general uint64). Split at 16 bits: every partial product
    is < 2^33 and ``(mid << 16) + lo + 2^31 < 2^50``."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh
    return ah * bh + (((mid << 16) + al * bl + (1 << 31)) >> 32)


def _decimate2(x: torch.Tensor, taps: np.ndarray, in_q: int) -> torch.Tensor:
    """Blur + 2x decimation: Q{in_q} int64 -> Q8 (golden/vif_int.py:78).
    Only the even rows/columns are kept, so only those are filtered."""
    tmp = _filt(x, taps, -2, 8 + in_q)[:, ::2, :]
    return _filt(tmp, taps, -1, 16)[:, :, ::2]


def _sigma_planes(ref: torch.Tensor, dist: torch.Tensor, taps: np.ndarray,
                  in_q: int):
    """int64 sigma planes (Q16 pixel^2) for one scale
    (golden/vif_int.py:_moments_int)."""
    vs = 8 + in_q
    mu1 = _filt(_filt(ref, taps, -2, vs), taps, -1, 0)
    mu2 = _filt(_filt(dist, taps, -2, vs), taps, -1, 0)

    def prod(a, b):
        return _filt(_filt(a * b, taps, -2, 16), taps, -1, 2 * in_q)

    s1 = prod(ref, ref) - _mul_shift32(mu1, mu1)
    s2 = prod(dist, dist) - _mul_shift32(mu2, mu2)
    s12 = prod(ref, dist) - _mul_shift32(mu1, mu2)
    return s1, s2, s12


def _normalize16(x: torch.Tensor):
    """Truncating normalisation of int64 x >= 2^15 into [2^15, 2^16):
    (mantissa, k) with ``x >> k == mantissa`` (golden/log2lut.py)."""
    k = torch.zeros_like(x)
    v = x
    for step in (32, 16, 8, 4, 2, 1):
        over = v >= (1 << (15 + step))
        v = torch.where(over, v >> step, v)
        k = k + over.to(k.dtype) * step
    return v, k


_TABLES = {}


def log2_table_device(device) -> torch.Tensor:
    """``log2_table()[32768:65536]`` as int32 on ``device`` (uploaded once
    per device). Trap 3: the Q11 values run 30720..32768, past int16's
    range, so they are never stored as int16; index with ``m - 32768``
    only for mantissas m >= 32768."""
    key = str(torch.device(device))
    if key not in _TABLES:
        t = log2_table()[_M32768:65536].astype(np.int32)
        _TABLES[key] = torch.as_tensor(t, device=device)
    return _TABLES[key]


def q11_log2_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table value, shift k) of int64 x >= 2^15: log2(x) ~ (value + 2048k)/2048."""
    m, k = _normalize16(x)
    return log2_table_device(x.device).long()[m - _M32768], k


def _statistic_sums(s1i: torch.Tensor, s2i: torch.Tensor, s12i: torch.Tensor,
                    gain_limit: float) -> torch.Tensor:
    """Per-pixel exact statistic (golden/vif_int.py:_statistic_pixel_terms)
    reduced to the (N, 7) int64 accumulators of ``STATS``.

    The gain chain is float64 with one rounding per operation, as numpy
    evaluates it: ``g = s12/(s1+eps)``, ``sv = trunc(s2 - g*s12)``,
    ``trunc((g*g)*s1)``; the NEG clamp applies after sv.

    Trap 7: the JAX twin emulates this chain with a u64/u32 division and
    f32 epsilon-boundary fixes (pqa2_tpu/ops/vif_int.py:490-499), so at an
    epsilon boundary it can differ from the oracle. Real float64 here
    follows the oracle (golden/vif_int.py:147-160)."""
    s1 = s1i.clamp_min(0)
    s2 = s2i.clamp_min(0)
    lb = s1 >= _NSQ
    nb = lb & (s12i >= 0)

    den_tab, k_den = q11_log2_plain(s1 + _NSQ)

    s1f = s1.double()
    s12f = torch.where(nb, s12i, torch.zeros_like(s12i)).double()
    g = s12f / (s1f + float(VIF_INT_EPS))
    sv = torch.trunc(s2.double() - g * s12f).clamp_min(0.0)
    g = torch.clamp(g, max=float(gain_limit))
    numer1 = sv.long() + _NSQ
    tmp = torch.trunc(g * g * s1f)
    t1, k1 = q11_log2_plain(tmp.long() + numer1)
    t2, k2 = q11_log2_plain(numer1)

    zero = torch.zeros((), dtype=torch.int64, device=s1.device)
    flat = torch.where(lb, zero, s2)
    parts = (
        torch.where(nb, t1 - t2, zero),
        torch.where(nb, k1 - k2, zero),
        torch.where(lb, den_tab, zero),
        torch.where(lb, k_den, zero),
        lb.long(),
        flat >> 16,
        flat & 0xFFFF,
    )
    return torch.stack([p.sum(dim=(-2, -1)) for p in parts], dim=-1)


#: 4 / 255^2 of the flat branch, rounded to f32 once as the JAX package's
#: weakly typed constant is.
_FLAT_SCALE = float(np.float32(4.0 / (255.0 * 255.0)))


def _statistic_fast(s1i: torch.Tensor, s2i: torch.Tensor, s12i: torch.Tensor,
                    gain_limit: float) -> torch.Tensor:
    """Per-pixel smooth f32-log statistic (pqa2_tpu/ops/vif_int.py:172)
    reduced to (N, 2) f32 per-frame sums {num, den}.

    Every f32 operation is the JAX package's, in its order: s = sigma /
    65536 (s1, s2 clamped at 0 first); g = s12 / max(s1, 1e-10) where s12 >
    0; sv^2 = max(s2 - g*s12, 0); the gain limit after sv^2 (libvmaf
    order); on the log branch (s1 >= SIGMA_NSQ_Q16) num = log2(1 +
    (g*g)*s1 / (sv^2 + 2)) and den = log2(1 + s1/2), elsewhere num = 1 -
    s2 * 4/255^2 and den = 1. The JAX package casts the int64 sigma planes
    to int32 first; the port keeps int64. A Q16 variance on the 8-bit scale
    is below 2^30 (|covariance| too), so both give the same f32
    (tests/test_torch_fast.py holds it at 16 bits with the largest codes).
    The sums are float64, rounded to f32 once, as the kernel's are."""
    s1 = s1i.clamp_min(0).float() / 65536.0
    s2 = s2i.clamp_min(0).float() / 65536.0
    s12 = s12i.float() / 65536.0
    log_branch = s1i >= _NSQ
    zero = torch.zeros((), dtype=torch.float32, device=s1.device)
    one = torch.ones((), dtype=torch.float32, device=s1.device)
    g = torch.where(s12 > 0.0, s12 / s1.clamp_min(1e-10), zero)
    sv_sq = (s2 - g * s12).clamp_min(0.0)
    g = g.clamp(max=float(gain_limit))
    num_log = torch.log2(1.0 + g * g * s1 / (sv_sq + 2.0))
    den_log = torch.log2(1.0 + s1 / 2.0)
    num = torch.where(log_branch, num_log, 1.0 - s2 * _FLAT_SCALE)
    den = torch.where(log_branch, den_log, one)
    return torch.stack([num.double().sum(dim=(-2, -1)),
                        den.double().sum(dim=(-2, -1))], dim=-1).float()


def fast_ratio(sums: torch.Tensor) -> torch.Tensor:
    """(N, 2) f32 {num, den} sums -> (N,) f32 vif_scale value
    (pqa2_tpu/ops/pallas_vif_int.py:1151)."""
    num, den = sums[:, 0], sums[:, 1]
    return torch.where(den > 0, num / den, torch.ones_like(num))


def _pf(v: torch.Tensor) -> torch.Tensor:
    """int64 sum -> f32 exactly as the JAX package's (hi, lo) pair:
    ``f32(v >> 16) * 65536 + f32(v & 0xFFFF)`` (ops/vif_int.py:525)."""
    return (v >> 16).float() * 65536.0 + (v & 0xFFFF).float()


def combine_stats(stats: torch.Tensor, n_pix: int) -> torch.Tensor:
    """(N, 7) accumulators -> (N,) f32 vif_scale value, in the JAX
    package's f32 operation order (pqa2_tpu/ops/vif_int.py:525-537).

    Trap 8: the ``pf`` folds and the two-step ``acc_flat`` round in this
    order; the flat-branch sigma2 therefore arrives as its high and low
    16-bit sums, not as one int64."""
    n_log = stats[:, 4]
    n_flat = (n_pix - n_log).float()
    acc_flat = _pf(stats[:, 5]) * 65536.0 + _pf(stats[:, 6])
    num = (_pf(stats[:, 0]) / 2048.0
           + stats[:, 1].float()
           + (n_flat - (acc_flat / 16384.0) / 65025.0))
    den = (_pf(stats[:, 2]) / 2048.0
           + stats[:, 3].float()
           - 17.0 * n_log.float()
           + n_flat)
    return torch.where(den > 0, num / den, torch.ones_like(num))


def vif_int_scale_plain(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    scale: int,
    in_q: int,
    gain_limit: float,
    decimate: bool,
    motion_ref: Optional[torch.Tensor] = None,
    exact: bool = True,
):
    """One VIF scale, the plain twin of the ``vif_int_scale`` kernel.

    ref/dist: (N, H, W) int32 codes (Q{in_q}) of the core frames.
    Returns ``(stats, next_ref, next_dist, sad)``: ``stats`` the (N, 7)
    int64 accumulators of ``STATS`` (``exact``) or the (N, 2) f32 {num,
    den} sums of the fast statistic; the next scale's Q8 int32 planes when
    ``decimate`` (else None), and with ``motion_ref`` (M, H, W) int32 codes
    of every chunk frame the (M-1,) int64 SADs of consecutive blurred
    frames (else None)."""
    from pqa2_tpu_torch.ops.motion_int import blur_int_batched, sad_pairs_int

    r = ref.long()
    d = dist.long()
    statistic = _statistic_sums if exact else _statistic_fast
    stats = statistic(*_sigma_planes(r, d, VIF_FILTERS_Q16[scale], in_q), gain_limit)
    next_ref = next_dist = sad = None
    if decimate:
        taps = VIF_FILTERS_Q16[scale + 1]
        next_ref = _decimate2(r, taps, in_q).to(torch.int32)
        next_dist = _decimate2(d, taps, in_q).to(torch.int32)
    if motion_ref is not None:
        sad = sad_pairs_int(blur_int_batched(motion_ref, in_q))
    return stats, next_ref, next_dist, sad


def vif_cascade(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    gain_limit: float,
    bit_depth: int,
    scale_fn: Callable,
    motion_ref: Optional[torch.Tensor] = None,
    exact: bool = True,
):
    """The four-scale VIF cascade around a per-scale function.

    ref/dist: (N, H, W) luma of the core frames (codes, or f32 on the
    8-bit scale). ``motion_ref``: (M, H, W) reference luma of the whole
    chunk, halos included, for the motion SAD fused into scale 0.
    ``exact`` picks the statistic (False: ``precision="integer_fast"``).
    Returns ``(vif (N, 4) f32, sad (M-1,) int64 or None)``."""
    r, in_q = scale0_codes(ref, bit_depth)
    d, _ = scale0_codes(dist, bit_depth)
    mref = (scale0_codes(motion_ref, bit_depth)[0].contiguous()
            if motion_ref is not None else None)
    feats = []
    sad = None
    for scale in range(4):
        stats, nr, nd, s = scale_fn(
            r.contiguous(), d.contiguous(), scale=scale, in_q=in_q,
            gain_limit=gain_limit, decimate=scale < 3,
            motion_ref=mref if scale == 0 else None, exact=exact)
        if scale == 0:
            sad = s
        feats.append(combine_stats(stats, r.shape[-2] * r.shape[-1]) if exact
                     else fast_ratio(stats))
        r, d, in_q = nr, nd, 8
    return torch.stack(feats, dim=-1), sad


def vif_features_int_batched(
    ref: torch.Tensor,
    dist: torch.Tensor,
    gain_limit: float = float("inf"),
    bit_depth: int = 8,
    exact: bool = True,
) -> torch.Tensor:
    """(N, H, W) luma pair -> (N, 4) [vif_scale0..3], plain version
    (pqa2_tpu/ops/vif_int.py:619): the exact LUT statistic, or with
    ``exact=False`` the smooth f32-log one."""
    vif, _ = vif_cascade(ref, dist, gain_limit=gain_limit, bit_depth=bit_depth,
                         scale_fn=vif_int_scale_plain, exact=exact)
    return vif
