"""The PyTorch port's ops against the JAX package and the numpy oracles.

Each kernel module of pqa2_tpu_torch is run here through its plain PyTorch
version (CPU tensors) and held against:

  * the JAX package on the CPU, which runs the XLA twins of its Pallas
    kernels there (pinned bit-identical to the kernels by
    tests/test_pallas_int.py);
  * the uint64/int64 numpy oracles in pqa2_tpu/golden.

Inputs are made from a seed with numpy and handed to both sides. JAX
results are computed once per module and shared (each JAX shape costs a
compile). The kernels themselves run only on an sm_90 card: the tests
marked ``cuda`` compare each against its plain version there (run them on
the card with ``python -m pytest tests/test_torch_ops.py -m cuda
--noconftest``: that machine has no JAX) and skip elsewhere.

Tolerances (each with its reason):
  integer stages            exactly equal (sigma planes, decimated planes,
                            LUT accumulators, SADs, DWT/decoupled bands,
                            pooled cube sums)
  vif_scale*                atol 2e-6 vs the oracle (tests/test_integer.py:80
                            budget: f32 features vs float64 oracle); equal
                            to JAX (same integer sums, same f32 combine order)
  motion/motion2            rtol 1e-6 vs JAX (its f32 hi/lo SAD fold is ~6e-8)
  adm2                      atol 2e-6 (f32 cbrt ulp; the port's tail is numpy's
                            float32 cbrt, JAX's is jnp.cbrt)
  VMAF                      atol 1e-3 (f32 exp and the ~83x inverse rescale)
  SSIM                      atol 1e-6 (f32 window ratios; the mean is float64
                            here, f32 in JAX)
"""

import numpy as np
import pytest
import torch

from pqa2_tpu.golden.fixedpoint import ADM_BAND_Q, VIF_FILTERS_Q16

try:
    import jax
    import jax.numpy as jnp
except ImportError:
    # The card's machine has no JAX; there only the ``cuda`` tests run:
    #   python -m pytest tests/test_torch_ops.py -m cuda --noconftest
    jax = jnp = None

VIF_ATOL = 2e-6
MOTION_RTOL = 1e-6
ADM_ATOL = 2e-6
VMAF_ATOL = 1e-3
SSIM_ATOL = 1e-6


def _smooth_pair(seed, n, h, w, noise=8, blur=1):
    """Smoothed random base (tests/test_integer.py:_pair style), +-noise,
    with a mild blur on the distorted side."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(n, h, w))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base).astype(np.uint8)
    b = ref.astype(np.float64)
    for _ in range(blur):
        b = (b + np.roll(b, 1, -1) + np.roll(b, -1, -1)
             + np.roll(b, 1, -2) + np.roll(b, -1, -2)) / 5.0
    dist = np.clip(np.round(b) + rng.integers(-noise, noise + 1, ref.shape),
                   0, 255).astype(np.uint8)
    return ref, dist


def _extreme_frames(h, w):
    """Trap 1: the mean products (a*b + 2^31) >> 32 pass 2^63 — an all-255
    frame and a 0/255 checkerboard drive mu to its largest values."""
    full = np.full((h, w), 255, np.uint8)
    cb = ((np.indices((h, w)).sum(axis=0) % 2) * 255).astype(np.uint8)
    return (full, full - 3), (cb, np.roll(cb, 1, axis=1))


# -- shared inputs and JAX results ------------------------------------------

VIF_CASES = {
    # name: (h, w, depth)
    "72x96-d8": (72, 96, 8),
    "120x160-d10": (120, 160, 10),
}


def _vif_inputs(name):
    h, w, depth = VIF_CASES[name]
    ref, dist = _smooth_pair(1, 2, h, w)
    if depth == 8:
        (f_r, f_d), (c_r, c_d) = _extreme_frames(h, w)
        ref = np.concatenate([ref, [f_r, c_r]])
        dist = np.concatenate([dist, [f_d, c_d]])
        return ref, dist, ref, dist
    # 10-bit: native codes, and the pipeline's f32 8-bit-scale luma.
    rng = np.random.default_rng(2)
    ref_c = ref.astype(np.uint16) * 4 + rng.integers(0, 4, ref.shape).astype(np.uint16)
    dist_c = dist.astype(np.uint16) * 4 + rng.integers(0, 4, ref.shape).astype(np.uint16)
    return (ref_c, dist_c, (ref_c / 4.0).astype(np.float32),
            (dist_c / 4.0).astype(np.float32))


@pytest.fixture(scope="module")
def vif_jax():
    """JAX vif_features_int_batched once per VIF case (one compile each)."""
    from pqa2_tpu.ops.vif_int import vif_features_int_batched

    out = {}
    for name, (_, _, depth) in VIF_CASES.items():
        _, _, r8, d8 = _vif_inputs(name)
        out[name] = np.asarray(vif_features_int_batched(
            jnp.asarray(r8), jnp.asarray(d8), bit_depth=depth))
    return out


@pytest.mark.parametrize("case", list(VIF_CASES))
def test_vif_sigma_and_decimated_planes_match_jax_and_oracle(case):
    from pqa2_tpu.golden.vif_int import _decimate, sigma_planes_int
    from pqa2_tpu.ops import vif_int as jv
    from pqa2_tpu_torch.ops import vif_int as tv

    h, w, depth = VIF_CASES[case]
    ref_c, dist_c, _, _ = _vif_inputs(case)
    in_q = depth - 8
    r_t = torch.from_numpy(ref_c.astype(np.int64))
    d_t = torch.from_numpy(dist_c.astype(np.int64))
    r_j = jnp.asarray(ref_c.astype(np.uint32))
    d_j = jnp.asarray(dist_c.astype(np.uint32))
    taps = VIF_FILTERS_Q16[0]
    port = tv._sigma_planes(r_t, d_t, taps, in_q)
    jaxp = jv._sigma_planes(r_j, d_j, taps, in_q)
    for i in range(ref_c.shape[0]):
        oracle = sigma_planes_int(ref_c[i].astype(np.uint64),
                                  dist_c[i].astype(np.uint64), taps, in_q)
        for p, j, o in zip(port, jaxp, oracle):
            np.testing.assert_array_equal(p[i].numpy(), o)
            np.testing.assert_array_equal(p[i].numpy(), np.asarray(j)[i])
    taps1 = VIF_FILTERS_Q16[1]
    dec = tv._decimate2(r_t, taps1, in_q).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jv._decimate2(r_j, taps1, in_q)))
    for i in range(ref_c.shape[0]):
        np.testing.assert_array_equal(
            dec[i], _decimate(ref_c[i].astype(np.uint64), taps1, in_q))
    assert dec.shape[-2:] == ((h + 1) // 2, (w + 1) // 2)


@pytest.mark.parametrize("case", list(VIF_CASES))
def test_vif_lut_accumulators_match_oracle(case):
    """The (N, 7) integer accumulators equal the oracle's per-pixel terms
    summed in Python ints, at every scale."""
    from pqa2_tpu.golden.vif_int import (
        _decimate,
        _statistic_pixel_terms,
        sigma_planes_int,
    )
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    _, _, depth = VIF_CASES[case]
    ref_c, dist_c, _, _ = _vif_inputs(case)
    r = torch.from_numpy(ref_c.astype(np.int32))
    d = torch.from_numpy(dist_c.astype(np.int32))
    ro, do = ref_c.astype(np.uint64), dist_c.astype(np.uint64)
    in_q = depth - 8
    for scale in range(4):
        taps = VIF_FILTERS_Q16[scale]
        if scale:
            ro = np.stack([_decimate(x, taps, in_q) for x in ro])
            do = np.stack([_decimate(x, taps, in_q) for x in do])
            in_q = 8
        stats, nr, nd, _ = vif_int_scale_plain(
            r, d, scale=scale, in_q=in_q, gain_limit=float("inf"),
            decimate=scale < 3)
        for i in range(ro.shape[0]):
            lb, nb, den_tab, k_den, num_tab, num_k, s2 = _statistic_pixel_terms(
                *sigma_planes_int(ro[i], do[i], taps, in_q), np.inf)
            flat = np.where(lb, 0, s2)
            want = [int(np.sum(np.where(nb, num_tab, 0))),
                    int(np.sum(np.where(nb, num_k, 0))),
                    int(np.sum(np.where(lb, den_tab, 0))),
                    int(np.sum(np.where(lb, k_den, 0))),
                    int(np.sum(lb)),
                    int(np.sum(flat >> 16)),
                    int(np.sum(flat & 0xFFFF))]
            assert stats[i].tolist() == want, (scale, i)
        if scale < 3:
            r, d = nr, nd


@pytest.mark.parametrize("case", list(VIF_CASES))
def test_vif_features_match_jax_and_oracle(case, vif_jax):
    from pqa2_tpu.golden.vif_int import vif_features_int
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched

    _, _, depth = VIF_CASES[case]
    ref_c, dist_c, r8, d8 = _vif_inputs(case)
    got = vif_features_int_batched(torch.from_numpy(r8), torch.from_numpy(d8),
                                   bit_depth=depth).numpy()
    # Same integer sums and the JAX package's f32 combine order.
    np.testing.assert_allclose(got, vif_jax[case], rtol=0, atol=VIF_ATOL)
    np.testing.assert_array_equal(got, vif_jax[case])
    for i in range(ref_c.shape[0]):
        np.testing.assert_allclose(
            got[i], vif_features_int(ref_c[i], dist_c[i], bit_depth=depth),
            rtol=0, atol=VIF_ATOL)


def test_vif_neg_gain_limit_matches_oracle(vif_jax):
    """The NEG limit 1.0 against the oracle (the JAX twin is pinned to it at
    this limit by tests/test_integer.py; a JAX run here would cost one more
    compile of the cascade)."""
    from pqa2_tpu.golden.vif_int import vif_features_int
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched

    ref, dist, _, _ = _vif_inputs("72x96-d8")
    got = vif_features_int_batched(torch.from_numpy(ref), torch.from_numpy(dist),
                                   gain_limit=1.0).numpy()
    for i in range(ref.shape[0]):
        np.testing.assert_allclose(got[i], vif_features_int(ref[i], dist[i], gain_limit=1.0),
                                   rtol=0, atol=VIF_ATOL)
    # The clamp bites: the NEG features differ from the default ones.
    assert not np.array_equal(got, vif_jax["72x96-d8"])


@pytest.mark.parametrize("frame", ["all255", "checkerboard"])
def test_vif_trap1_extreme_frames(frame, vif_jax):
    """Trap 1 pinned: mean products near 2^64 on the extreme frames."""
    from pqa2_tpu.golden.vif_int import sigma_planes_int, vif_features_int
    from pqa2_tpu_torch.ops.vif_int import _mul_shift32, _sigma_planes

    (f_r, f_d), (c_r, c_d) = _extreme_frames(72, 96)
    r, d, idx = (f_r, f_d, 2) if frame == "all255" else (c_r, c_d, 3)
    # The identity against an exact Python-int product.
    a = torch.tensor([0xFFFF0000, 0xFFFFFFFF, 255 << 24, 12345], dtype=torch.int64)
    got = _mul_shift32(a, a).tolist()
    assert got == [(int(x) * int(x) + (1 << 31)) >> 32 for x in a.tolist()]
    port = _sigma_planes(torch.from_numpy(r[None].astype(np.int64)),
                         torch.from_numpy(d[None].astype(np.int64)),
                         VIF_FILTERS_Q16[0], 0)
    oracle = sigma_planes_int(r.astype(np.uint64), d.astype(np.uint64),
                              VIF_FILTERS_Q16[0], 0)
    for p, o in zip(port, oracle):
        np.testing.assert_array_equal(p[0].numpy(), o)
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched

    feats = vif_features_int_batched(torch.from_numpy(r[None]),
                                     torch.from_numpy(d[None])).numpy()[0]
    np.testing.assert_allclose(feats, vif_features_int(r, d), rtol=0, atol=VIF_ATOL)
    np.testing.assert_array_equal(feats, vif_jax["72x96-d8"][idx])


# -- motion ------------------------------------------------------------------

@pytest.mark.parametrize("has_prev,has_next",
                         [(False, False), (True, True), (True, False), (False, True)])
def test_motion_matches_jax_and_oracle(has_prev, has_next):
    from pqa2_tpu.golden.motion_int import blur_int
    from pqa2_tpu.ops.motion_int import motion_features_int as jax_motion
    from pqa2_tpu_torch.ops.motion_int import (
        blur_int_batched,
        motion_features_int,
        sad_pairs_int,
    )

    ref, _ = _smooth_pair(3, 6, 72, 96)
    ref = np.stack([np.roll(f, 2 * t, axis=1) for t, f in enumerate(ref)])
    sad = sad_pairs_int(blur_int_batched(torch.from_numpy(ref), 0)).tolist()
    blurred = [blur_int(f).astype(np.int64) for f in ref]
    assert sad == [int(np.abs(blurred[i] - blurred[i - 1]).sum()) for i in range(1, 6)]
    assert min(sad) > 0
    got = motion_features_int(torch.from_numpy(ref), has_prev=has_prev,
                              has_next=has_next)
    want = jax_motion(jnp.asarray(ref), has_prev=has_prev, has_next=has_next)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MOTION_RTOL, atol=0)


# -- ADM ---------------------------------------------------------------------

ADM_SHAPE = (3, 71, 97)  # odd sizes: halving as (n+1)//2 at every level


@pytest.fixture(scope="module")
def adm_inputs():
    return _smooth_pair(4, *ADM_SHAPE)


@pytest.fixture(scope="module")
def adm_jax(adm_inputs):
    from pqa2_tpu.ops import adm_int as ja

    ref, dist = adm_inputs
    digits = np.asarray(jax.jit(ja.adm_pooled_digit_sums_batched)(
        jnp.asarray(ref), jnp.asarray(dist)))
    adm2 = np.asarray(ja.adm_from_digit_sums_batched(
        jnp.asarray(digits), ref.shape[-2], ref.shape[-1]))
    return digits, adm2


def test_adm_dwt_and_decoupled_bands_match_jax_and_oracle(adm_inputs):
    from pqa2_tpu.golden import adm_int as go
    from pqa2_tpu.ops import adm_int as ja
    from pqa2_tpu_torch.ops import adm_int as ta

    ref, dist = adm_inputs
    cur_r = ref.astype(np.int64) << ADM_BAND_Q[0]
    cur_d = dist.astype(np.int64) << ADM_BAND_Q[0]
    for lvl in range(4):
        drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl] if lvl else 0
        o = ta.dwt2_int_batched(torch.from_numpy(cur_r), drop)
        t = ta.dwt2_int_batched(torch.from_numpy(cur_d), drop)
        rst, add = ta.decouple_int_batched(o, t, 100.0)
        if lvl == 0:  # JAX's eager ops compile per shape: level 0 only
            oj = ja.dwt2_int_batched(jnp.asarray(cur_r.astype(np.int32)), drop)
            tj = ja.dwt2_int_batched(jnp.asarray(cur_d.astype(np.int32)), drop)
            rj, aj = ja.decouple_int_batched(oj, tj, 100.0)
            for b in "ahvd":
                np.testing.assert_array_equal(o[b].numpy(), np.asarray(oj[b]))
                np.testing.assert_array_equal(t[b].numpy(), np.asarray(tj[b]))
            for b in "hvd":
                np.testing.assert_array_equal(rst[b].numpy(), np.asarray(rj[b]))
                np.testing.assert_array_equal(add[b].numpy(), np.asarray(aj[b]))
        for i in range(ref.shape[0]):
            oo = go.dwt2_db2_int(cur_r[i], drop)
            to = go.dwt2_db2_int(cur_d[i], drop)
            ro, ao = go.decouple_int(oo, to, 100.0)
            for b in "ahvd":
                np.testing.assert_array_equal(o[b][i].numpy(), oo[b])
            for b in "hvd":
                np.testing.assert_array_equal(rst[b][i].numpy(), ro[b])
                np.testing.assert_array_equal(add[b][i].numpy(), ao[b])
        cur_r, cur_d = o["a"].numpy(), t["a"].numpy()
    assert cur_r.shape[-2:] == (5, 7)  # 71x97 -> 36x49 -> 18x25 -> 9x13 -> 5x7


def test_adm_pooled_digits_match_jax_and_oracle(adm_inputs, adm_jax):
    from pqa2_tpu.golden.adm_int import adm_pooled_digit_sums
    from pqa2_tpu_torch.ops.adm_int import adm_cascade, adm_level_plain, digits_from_sums

    ref, dist = adm_inputs
    sums = adm_cascade(torch.from_numpy(ref), torch.from_numpy(dist), gain_limit=100.0,
                       bit_depth=8, level_fn=adm_level_plain)
    digits = digits_from_sums(sums)
    np.testing.assert_array_equal(digits, adm_jax[0])
    for i in range(ref.shape[0]):
        np.testing.assert_array_equal(digits[i], adm_pooled_digit_sums(ref[i], dist[i]))


def test_adm2_matches_jax_and_oracle(adm_inputs, adm_jax):
    from pqa2_tpu.golden.adm_int import adm_features_int
    from pqa2_tpu_torch.ops.adm_int import adm_features_int_batched

    ref, dist = adm_inputs
    got = adm_features_int_batched(torch.from_numpy(ref), torch.from_numpy(dist)).numpy()
    np.testing.assert_allclose(got, adm_jax[1], rtol=0, atol=ADM_ATOL)
    for i in range(ref.shape[0]):
        assert got[i] == np.float32(adm_features_int(ref[i], dist[i])[0])
    assert np.all(got < 0.99)


def test_adm_neg_gain_limit_matches_oracle(adm_inputs):
    from pqa2_tpu.golden.adm_int import adm_features_int
    from pqa2_tpu_torch.ops.adm_int import adm_features_int_batched

    ref, dist = adm_inputs
    got = adm_features_int_batched(torch.from_numpy(ref), torch.from_numpy(dist),
                                   gain_limit=1.0).numpy()
    for i in range(ref.shape[0]):
        assert got[i] == np.float32(adm_features_int(ref[i], dist[i], gain_limit=1.0)[0])


# -- SSIM / SSE --------------------------------------------------------------

@pytest.mark.parametrize("depth", [8, 10])
def test_ssim_sse_match_jax_and_oracle(depth):
    from pqa2_tpu.golden.ssim import ssim_plane
    from pqa2_tpu.ops.psnr import _sse as jax_sse
    from pqa2_tpu.ops.ssim import ssim_plane_batched as jax_ssim
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain

    ref, dist = _smooth_pair(5, 3, 36, 52)  # 36x52: a ragged 4x4 edge
    if depth == 8:
        r8, d8, rn, dn = ref, dist, ref, dist
    else:
        rn = ref.astype(np.uint16) * 4 + 1
        dn = dist.astype(np.uint16) * 4 + 3
        r8, d8 = (rn / 4.0).astype(np.float32), (dn / 4.0).astype(np.float32)
    ssim, sse = ssim_sse_plane_plain(torch.from_numpy(r8), torch.from_numpy(d8), depth)
    np.testing.assert_allclose(ssim.numpy(), np.asarray(jax_ssim(
        jnp.asarray(r8), jnp.asarray(d8), bit_depth=depth)), rtol=0, atol=SSIM_ATOL)
    for i in range(ref.shape[0]):
        np.testing.assert_allclose(ssim[i].item(), ssim_plane(rn[i], dn[i], depth),
                                   rtol=0, atol=SSIM_ATOL)
        diff = r8[i].astype(np.float64) - d8[i].astype(np.float64)
        assert sse[i].item() == float(np.sum(diff * diff))  # exact
    np.testing.assert_allclose(sse.numpy(), np.asarray(jax_sse(jnp.asarray(r8),
                                                               jnp.asarray(d8))),
                               rtol=1e-6)


# -- SVR -----------------------------------------------------------------------

def _svr_features(rng, n, realistic):
    """(n, 6) features in the model's order (adm2, motion2, vif0..3)."""
    if realistic:  # the ranges real distorted content gives
        cols = [(0.8, 1.0), (0.0, 8.0), (0.2, 0.9), (0.6, 1.0), (0.7, 1.0), (0.8, 1.0)]
    else:          # the wide ranges of tests/test_svr.py
        cols = [(0.3, 1.0), (0.0, 25.0), (0.1, 1.0), (0.3, 1.0), (0.5, 1.0), (0.6, 1.0)]
    return np.stack([rng.uniform(lo, hi, n) for lo, hi in cols], axis=-1).astype(np.float32)


@pytest.mark.parametrize("name", ["vmaf_v0.6.1", "vmaf_b_v0.6.3"])
def test_svr_matches_jax_predictor(name):
    """Against the JAX predictor fed the same weights (svr_state_from_model
    carries the loader's arrays) and against a float64 evaluation.

    float64: atol 5e-3 for every sub-model, the JAX package's own budget
    (tests/test_svr.py:48). JAX: VMAF atol 1e-3 for vmaf_v0.6.1. For the
    21-model bootstrap the JAX predictor's own f32 error is ~1.8e-3 against
    float64 on realistic features (the port's ~1.2e-3: the ~83x inverse
    rescale amplifies f32 rounding of sum(K * coef)), so the two f32
    predictors are held to each other at the same 5e-3."""
    import sys
    from pathlib import Path

    from pqa2_tpu.models import get_model
    from pqa2_tpu.models.loader import BootstrapModel
    from pqa2_tpu.models.svr import BootstrapPredictor as JB
    from pqa2_tpu.models.svr import ScorePredictor as JS
    from pqa2_tpu_torch.models.svr import (
        BootstrapPredictor,
        ScorePredictor,
        predictor_for_model,
        svr_state_from_model,
    )

    sys.path.insert(0, str(Path(__file__).parent))
    from test_svr import numpy_predict

    model = get_model(name)
    rng = np.random.default_rng(6)
    pred = predictor_for_model(model)
    assert isinstance(pred, torch.nn.Module)
    state = svr_state_from_model(model)
    subs = model.models if isinstance(model, BootstrapModel) else (model,)
    assert state["sv"].shape[0] == len(subs)
    for realistic in (True, False):
        feats = _svr_features(rng, 48, realistic)
        with torch.no_grad():
            if isinstance(model, BootstrapModel):
                assert isinstance(pred, BootstrapPredictor)
                primary, every = pred(torch.from_numpy(feats))
                jp, jall = JB(model)(jnp.asarray(feats))
                assert every.shape == (len(subs), 48)
            else:
                assert type(pred) is ScorePredictor
                primary = pred(torch.from_numpy(feats))
                every = primary[None]
                jp = JS(model)(jnp.asarray(feats))
                jall = jp[None]
        want = np.stack([numpy_predict(m, feats.astype(np.float64)) for m in subs])
        np.testing.assert_allclose(every.numpy(), want, rtol=0, atol=5e-3)
        atol = 5e-3 if len(subs) > 1 else VMAF_ATOL
        np.testing.assert_allclose(primary.numpy(), np.asarray(jp), rtol=0, atol=atol)
        np.testing.assert_allclose(every.numpy(), np.asarray(jall), rtol=0, atol=atol)
        assert float(primary.min()) < 90.0  # not pinned at the clip


# -- log2 table, dispatch, helpers -------------------------------------------

def test_log2_audit_plain_path():
    from pqa2_tpu_torch.ops.cuda_vif_int import _audit_plain, log2_table_audit

    assert log2_table_audit("cpu") == 0
    got = _audit_plain(torch.device("cpu")).numpy()
    assert got.shape == (65536,) and got.min() == 30720 and got.max() == 32768


def test_log2_audit_caches_a_passed_audit(monkeypatch):
    """A passed audit is cached per device: the second call audits nothing
    and returns 0 (kernel 2 launches once per device, not once per clip)."""
    from pqa2_tpu_torch.ops import cuda_vif_int

    monkeypatch.setattr(cuda_vif_int, "_AUDITED", set())
    launches = cuda_vif_int.log2_table_audit.launches
    assert cuda_vif_int.log2_table_audit("cpu") == 0
    assert cuda_vif_int._AUDITED == {"cpu"}

    def audited_again(device):
        raise AssertionError("a cached audit ran again")

    monkeypatch.setattr(cuda_vif_int, "_audit_plain", audited_again)
    assert cuda_vif_int.log2_table_audit(torch.device("cpu")) == 0
    assert cuda_vif_int.log2_table_audit.launches == launches


def test_log2_audit_mismatch_raises_every_time(monkeypatch):
    """One wrong expected value is one mismatch: the audit raises at every
    call and caches nothing."""
    from pqa2_tpu_torch.ops import cuda_vif_int

    monkeypatch.setattr(cuda_vif_int, "_AUDITED", set())
    want = cuda_vif_int._log2_expected("cpu").clone()
    want[32768 + 12345] += 1
    assert cuda_vif_int._audit_mismatches_plain("cpu", want) == 1
    monkeypatch.setattr(cuda_vif_int, "_log2_expected", lambda device: want)
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"at 1 of 65536 audited values"):
            cuda_vif_int.log2_table_audit("cpu")
    assert not cuda_vif_int._AUDITED


def test_motion_sad_plain_matches_pallas_kernel():
    """Kernel 7's plain version against the JAX kernel itself in interpret
    mode, at 1, 2 and 9 frames of a 40x56 plane: frame 0 exactly 0 on both,
    the rest within 1e-5 relative (f32 sums in another order; XLA may also
    contract the blur's multiply-adds on the CPU, Queue 3 F2)."""
    from pqa2_tpu.ops.pallas_motion import motion_sad_pallas
    from pqa2_tpu_torch.ops.motion import motion_sad_plain

    ref, _ = _smooth_pair(14, 9, 40, 56)
    ref = np.stack([np.roll(f, 3 * t, axis=1) for t, f in enumerate(ref)]).astype(np.float32)
    for n in (1, 2, 9):
        got = motion_sad_plain(torch.from_numpy(ref[:n])).numpy()
        want = np.asarray(motion_sad_pallas(jnp.asarray(ref[:n]), interpret=True))
        assert got.shape == want.shape == (n,)
        assert got[0] == 0.0 and want[0] == 0.0
        assert (got[1:] > 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_wrappers_use_plain_versions_on_cpu():
    from pqa2_tpu_torch.ops import cuda_adm_int, cuda_ssim, cuda_vif_int
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    ref, dist = _smooth_pair(7, 3, 40, 56)
    r = torch.from_numpy(ref.astype(np.int32))
    d = torch.from_numpy(dist.astype(np.int32))
    before = (cuda_vif_int.vif_int_scale.launches, cuda_adm_int.adm_int_level.launches,
              cuda_ssim.ssim_sse_plane.launches)
    fast_before = cuda_vif_int.vif_int_scale.fast_launches
    for exact in (True, False):
        kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True, motion_ref=r,
                  exact=exact)
        got = cuda_vif_int.vif_int_scale(r, d, **kw)
        assert got[0].shape == ((3, 7) if exact else (3, 2))
        for a, b in zip(got, vif_int_scale_plain(r, d, **kw)):
            assert torch.equal(a, b)
    assert cuda_vif_int.vif_int_scale.fast_launches == fast_before
    kw = dict(level=0, extra_row_shift=0, gain_limit=100.0)
    for a, b in zip(cuda_adm_int.adm_int_level(r << 4, d << 4, **kw),
                    adm_level_plain(r << 4, d << 4, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(cuda_ssim.ssim_sse_plane(r.float(), d.float()),
                    ssim_sse_plane_plain(r.float(), d.float())):
        assert torch.equal(a, b)
    # No kernel was launched: the CPU path is not counted.
    assert before == (cuda_vif_int.vif_int_scale.launches,
                      cuda_adm_int.adm_int_level.launches,
                      cuda_ssim.ssim_sse_plane.launches)


def _edge_frames(h, w, depth):
    """4 frames of codes in [0, 2^depth - 1]: all-peak against all-0 and the
    reverse, a 0/peak checkerboard of single pixels and one of 8x8 blocks
    against their inverses (uint8 at 8 bits, else int32)."""
    peak = (1 << depth) - 1
    yy, xx = np.indices((h, w))
    c1 = ((yy + xx) % 2) * peak
    c8 = ((yy // 8 + xx // 8) % 2) * peak
    full, zero = np.full((h, w), peak), np.zeros((h, w), np.int64)
    ref = np.stack([full, zero, c1, c8])
    dist = np.stack([zero, full, peak - c1, peak - c8])
    dt = np.uint8 if depth == 8 else np.int32
    return ref.astype(dt), dist.astype(dt)


@pytest.mark.parametrize("frame", [0, 2, 3], ids=["all-peak", "checkerboard", "8x8-blocks"])
def test_vif_int_uint32_envelope(frame):
    """The kernel filters 8-bit codes (in_q 0) in uint32: on the extreme
    frames the plain version's largest vertical and horizontal tap sums
    (rounding included) stay below 2^32. The same frames as 16-bit codes
    take the products past 2^32 (the kernel widens those) while the mean
    sums stay below it (the kernel keeps those in uint32)."""
    from pqa2_tpu_torch.golden.fixedpoint import VIF_FILTERS_Q16 as taps_q16
    from pqa2_tpu_torch.ops.vif_int import _filt

    taps = taps_q16[0]
    for depth in (8, 16):
        x = torch.from_numpy(_edge_frames(72, 96, depth)[0][frame:frame + 1]).long()
        vs = depth  # 8 + in_q
        vert_mu = _filt(x, taps, -2, 0).max().item() + (1 << (vs - 1))
        vert_xx = _filt(x * x, taps, -2, 0).max().item() + (1 << 15)
        hor_mu = _filt(_filt(x, taps, -2, vs), taps, -1, 0).max().item()
        hor_xx = _filt(_filt(x * x, taps, -2, 16), taps, -1, 0).max().item()
        assert max(vert_mu, hor_mu) < 2 ** 32
        if depth == 8:
            assert max(vert_xx, hor_xx) < 2 ** 32
        else:
            assert min(vert_xx, hor_xx) >= 2 ** 32


def test_vif_int_scale_uint8_equals_int32():
    """uint8 planes (the source's bytes, in_q 0) give what int32 codes give,
    statistic, decimated planes and SAD."""
    from pqa2_tpu_torch.ops.cuda_vif_int import vif_int_scale

    ref, dist = _smooth_pair(14, 3, 40, 56)
    e_r, e_d = _edge_frames(40, 56, 8)
    r8 = torch.from_numpy(np.concatenate([ref, e_r]))
    d8 = torch.from_numpy(np.concatenate([dist, e_d]))
    r32, d32 = r8.to(torch.int32), d8.to(torch.int32)
    kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True)
    got = vif_int_scale(r8[1:6], d8[1:6], motion_ref=r8, **kw)
    want = vif_int_scale(r32[1:6], d32[1:6], motion_ref=r32, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_vif_int_core_frames_are_found_in_the_chunk():
    """The scale-0 launch blurs the core frames for the SAD when they are a
    run of the chunk's frames; 8-bit luma reaches it as it is."""
    from pqa2_tpu_torch.ops.cuda_vif_int import _frame_offset
    from pqa2_tpu_torch.ops.vif_int import scale0_codes

    x = torch.zeros((5, 4, 6), dtype=torch.uint8)
    assert [_frame_offset(x[a:b], x) for a, b in ((0, 5), (1, 4), (4, 5))] == [0, 1, 4]
    assert _frame_offset(x[1:4].clone(), x) is None
    assert _frame_offset(x[1:4].to(torch.int32), x) is None
    codes, in_q = scale0_codes(x, 8)
    assert codes is x and in_q == 0
    codes, in_q = scale0_codes(x.float() * 4.0, 10)
    assert codes.dtype == torch.int32 and in_q == 2


@pytest.mark.parametrize("depth", [8, 10, 12, 16])
def test_adm_int_int32_envelope(depth):
    """The kernel runs a DWT pass in int32 where ops/adm_int.py:dwt_envelope
    bounds its accumulators below 2^31. On the edge frames, over all four
    levels, the plain version's largest accumulator (rounding included)
    stays within the envelope's bound, and below 2^31 in every pass the
    envelope keeps in int32; at 16 bits level 0's row pass passes 2^31, and
    the envelope widens it."""
    from pqa2_tpu_torch.golden.fixedpoint import DB2_HI_Q15, DB2_LO_Q15
    from pqa2_tpu_torch.ops.adm_int import (
        INT32_LIMIT,
        _dwt1d,
        dwt1d_acc,
        dwt2_int_batched,
        dwt_envelope,
        dwt_wide_passes,
        level_codes,
        level_input,
    )

    taps = (DB2_LO_Q15, DB2_HI_Q15)
    over = set()
    for plane in _edge_frames(72, 96, depth):
        cur, drop = level_input(torch.from_numpy(plane), depth)
        for lvl in range(4):
            if lvl:
                drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
            x = level_codes(cur, lvl, drop)
            s = 15 + drop
            row = max(dwt1d_acc(x, f, -2).abs().max().item() for f in taps) + (1 << (s - 1))
            mids = [_dwt1d(x, f, -2, drop) for f in taps]
            col = max(dwt1d_acc(m, f, -1).abs().max().item()
                      for m in mids for f in taps) + (1 << 14)
            env_row, env_col, _ = dwt_envelope(lvl, drop)
            assert row <= env_row and col <= env_col
            for got, wide, name in zip((row, col), dwt_wide_passes(lvl, drop), ("row", "col")):
                if not wide:
                    assert got < INT32_LIMIT, (lvl, name, got)
                elif got >= INT32_LIMIT:
                    over.add((lvl, name))
            cur = dwt2_int_batched(x, drop)["a"].to(torch.int32)
    assert ((0, "row") in over) == (depth == 16)


def test_adm_int_level0_uint8_equals_int32():
    """Level 0 on uint8 8-bit luma (shifted to Q4 as it is read) gives what
    it gives on level_input's int32 Q4 codes: the sums and both
    approximation planes, at gain 100 and 1.0."""
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain, level_input
    from pqa2_tpu_torch.ops.cuda_adm_int import adm_int_level

    ref, dist = _smooth_pair(16, 3, 41, 57)
    e_r, e_d = _edge_frames(41, 57, 8)
    r8 = torch.from_numpy(np.concatenate([ref, e_r]))
    d8 = torch.from_numpy(np.concatenate([dist, e_d]))
    r32, drop = level_input(r8.to(torch.int32), 8)
    d32, _ = level_input(d8.to(torch.int32), 8)
    assert r32.dtype == torch.int32 and drop == 0
    for gain in (100.0, 1.0):
        kw = dict(level=0, extra_row_shift=0, gain_limit=gain)
        want = adm_level_plain(r32, d32, **kw)
        for got in (adm_level_plain(r8, d8, **kw), adm_int_level(r8, d8, **kw)):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="level 0"):
        adm_level_plain(r8, d8, level=1, extra_row_shift=0, gain_limit=100.0)


def test_adm_cascade_hands_8bit_luma_to_level0_as_it_is():
    """The main path runs no uint8 -> int32 copy and no shift pass for ADM:
    8-bit luma reaches level 0 as the same tensor; other depths and float
    luma become int32 Q4 codes."""
    from pqa2_tpu_torch.ops.adm_int import adm_cascade, adm_level_plain

    ref, dist = _smooth_pair(18, 2, 30, 44)
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    for x, y, depth, same in ((r, d, 8, True), (r.float(), d.float(), 8, False),
                              (r.to(torch.int32) * 4, d.to(torch.int32) * 4, 10, False)):
        seen = []

        def level_fn(a, b, **kw):
            seen.append((a, b, kw["extra_row_shift"]))
            return adm_level_plain(a, b, **kw)

        adm_cascade(x, y, gain_limit=100.0, bit_depth=depth, level_fn=level_fn)
        (a0, b0, drop0), rest = seen[0], seen[1:]
        assert ((a0 is x) and (b0 is y)) == same and drop0 == 0
        assert a0.dtype == (torch.uint8 if same else torch.int32)
        assert len(rest) == 3 and all(a.dtype == torch.int32 for a, _, _ in rest)


def test_adm_quotient_audit_plain_path():
    """The decoupling's quotient routine (f32 estimate, one exact
    correction) on the CPU's sample, and the audit's range covers the
    envelope's largest h/v/d band."""
    from pqa2_tpu_torch.ops.adm_int import dwt_envelope
    from pqa2_tpu_torch.ops.cuda_adm_int import QUOTIENT_OA_MAX, quotient_audit

    assert quotient_audit("cpu") == 0
    peak = max(dwt_envelope(lvl, ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl] if lvl else extra)[2]
               for lvl in range(4) for extra in range(5))
    assert peak < QUOTIENT_OA_MAX


def test_pad_frames_and_iter_chunks():
    """Chunk bounds, pooling, and the chunk upload that replaced the JAX
    package's padding: a chunk goes up as it is (the last one unpadded), in
    its source dtype, >8-bit codes brought onto the 8-bit scale there."""
    from pqa2_tpu_torch.pipeline.scoring import iter_chunks, pool_metric, upload

    cpu = torch.device("cpu")
    x = np.arange(12, dtype=np.uint8).reshape(3, 2, 2)
    t = upload(x[1:], cpu)
    assert t.dtype == torch.uint8 and torch.equal(t, torch.from_numpy(x[1:]))
    assert torch.equal(upload([x[0], x[2]], cpu), torch.from_numpy(x[::2]))
    assert upload(t, cpu) is t
    t10 = upload(x.astype(np.uint16) * 4 + 1, cpu, 4.0)
    assert t10.dtype == torch.float32
    assert torch.equal(t10, torch.from_numpy(x).float() + 0.25)
    assert list(iter_chunks(9, 4)) == [(0, 4, False, True), (4, 8, True, True),
                                       (8, 9, True, False)]
    v = np.array([80.0, 90.0, 100.0])
    assert pool_metric(v, "mean") == 90.0
    assert pool_metric(v, "harmonic_mean") == pytest.approx(3 / np.sum(1 / (1 + v)) - 1)


def test_float_family_and_integer_fast_wait_for_q1_10():
    """Both remaining families of ROADMAP Q1.10 run: float and integer_fast
    return the seven features (integer_fast: VIF's smooth-log statistic,
    ADM and motion those of the integer family)."""
    from pqa2_tpu_torch.pipeline.features import extract_features_batched

    x = torch.zeros((2, 24, 24), dtype=torch.uint8)
    names = {"adm2", "motion", "motion2", "vif_scale0", "vif_scale1", "vif_scale2",
             "vif_scale3"}
    for precision in ("float", "integer_fast"):
        feats = extract_features_batched(x, x, precision=precision, vif_variant="classic")
        assert set(feats) == names
        assert all(v.shape == (2,) and v.dtype == torch.float32 for v in feats.values())
    ref, dist = _smooth_pair(9, 3, 40, 56)
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    fast = extract_features_batched(r, d, precision="integer_fast")
    exact = extract_features_batched(r, d, precision="integer")
    for k in ("adm2", "motion", "motion2"):
        assert torch.equal(fast[k], exact[k])
    assert 0 < (fast["vif_scale0"] - exact["vif_scale0"]).abs().max() < 1e-3
    with pytest.raises(ValueError, match="unknown feature precision"):
        extract_features_batched(r, d, precision="integer_exact")


# -- the kernels themselves: on an sm_90 card only ---------------------------

@pytest.fixture()
def cuda_device():
    """The card for the kernel tests; decided here, never at import."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_vif_int_scale_matches_plain(cuda_device):
    from pqa2_tpu_torch.ops.cuda_vif_int import vif_int_scale
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    ref, dist = _smooth_pair(8, 6, 135, 241)
    r = torch.from_numpy(ref[1:5].astype(np.int32)).to(cuda_device)
    d = torch.from_numpy(dist[1:5].astype(np.int32)).to(cuda_device)
    m = torch.from_numpy(ref.astype(np.int32)).to(cuda_device)
    in_q = 0
    for scale in range(4):
        kw = dict(scale=scale, in_q=in_q, gain_limit=float("inf"), decimate=scale < 3,
                  motion_ref=m if scale == 0 else None)
        got = vif_int_scale(r, d, **kw)
        want = vif_int_scale_plain(r, d, **kw)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        r, d, in_q = got[1], got[2], 8


@pytest.mark.cuda
@pytest.mark.parametrize("depth,kind", [(8, "uint8"), (8, "int32"), (10, "int32"),
                                        (16, "int32")])
def test_kernel_vif_int_scale_edges(cuda_device, depth, kind):
    """Kernel 1 at the edges of its arithmetic (uint32 filters at 8 bits,
    the widening path at 10 and 16 bits, the largest codes), 1080p and
    3840x2160, all four scales with the motion SAD: equal to the plain
    version."""
    from pqa2_tpu_torch.ops.cuda_vif_int import vif_int_scale
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    for h, w in ((1080, 1920), (2160, 3840)):
        ref, dist = _edge_frames(h, w, depth)
        dt = torch.uint8 if kind == "uint8" else torch.int32
        r = torch.from_numpy(ref).to(cuda_device, dt)
        d = torch.from_numpy(dist).to(cuda_device, dt)
        m, in_q = r, max(depth - 8, 0)
        for scale in range(4):
            kw = dict(scale=scale, in_q=in_q, gain_limit=float("inf"), decimate=scale < 3,
                      motion_ref=m if scale == 0 else None)
            got = vif_int_scale(r, d, **kw)
            want = vif_int_scale_plain(r, d, **kw)
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b)
            r, d, in_q = got[1], got[2], 8


@pytest.mark.cuda
def test_kernel_vif_int_scale_uint8_chunk(cuda_device):
    """The main path's scale-0 call: uint8 luma, the core frames a view of
    the chunk (their motion blur in the same launch, the halos apart)."""
    from pqa2_tpu_torch.ops.cuda_vif_int import vif_int_scale
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    ref, dist = _smooth_pair(15, 6, 135, 241)
    m = torch.from_numpy(ref).to(cuda_device)
    d = torch.from_numpy(dist).to(cuda_device)
    for core in (slice(1, 5), slice(0, 5), slice(5, 6)):
        kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True, motion_ref=m)
        got = vif_int_scale(m[core], d[core], **kw)
        want = vif_int_scale_plain(m[core], d[core], **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _vif_fast_scales_match(r, d, m, in_q, gain):
    """Kernel 1f at all four scales against its plain version on the card:
    decimated planes and SAD equal, the {num, den} sums within 1e-5
    relative, the features within 2e-6 (the JAX package's kernel-vs-twin
    budget, tests/test_pallas_int.py:20), a second launch the same bits."""
    from pqa2_tpu_torch.ops.cuda_vif_int import vif_int_scale
    from pqa2_tpu_torch.ops.vif_int import fast_ratio, vif_int_scale_plain

    for scale in range(4):
        kw = dict(scale=scale, in_q=in_q, gain_limit=gain, decimate=scale < 3,
                  motion_ref=m if scale == 0 else None, exact=False)
        got = vif_int_scale(r, d, **kw)
        again = vif_int_scale(r, d, **kw)
        want = vif_int_scale_plain(r, d, **kw)
        for a, b in zip(got[1:], want[1:]):
            assert (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(got, again):
            assert (a is None and b is None) or torch.equal(a, b)
        assert got[0].shape == want[0].shape and got[0].dtype == torch.float32
        rel = ((got[0].double() - want[0].double()).abs()
               / want[0].double().abs().clamp_min(1e-30)).max().item()
        assert rel <= 1e-5
        assert (fast_ratio(got[0]) - fast_ratio(want[0])).abs().max().item() <= 2e-6
        r, d, in_q = got[1], got[2], 8


@pytest.mark.cuda
@pytest.mark.parametrize("depth,kind", [(8, "uint8"), (8, "int32"), (10, "int32"),
                                        (16, "int32")])
def test_kernel_vif_int_scale_fast_edges(cuda_device, depth, kind):
    """Kernel 1f on the edge frames of kernel 1 (1080p and 3840x2160, gain
    inf and 1.0, the motion SAD at scale 0)."""
    for h, w in ((1080, 1920), (2160, 3840)):
        ref, dist = _edge_frames(h, w, depth)
        dt = torch.uint8 if kind == "uint8" else torch.int32
        r = torch.from_numpy(ref).to(cuda_device, dt)
        d = torch.from_numpy(dist).to(cuda_device, dt)
        for gain in (float("inf"), 1.0):
            _vif_fast_scales_match(r, d, r, max(depth - 8, 0), gain)


@pytest.mark.cuda
def test_kernel_vif_int_scale_fast_uint8_chunk(cuda_device):
    """Kernel 1f on the main path's scale-0 call: uint8 luma, the core frames
    a view of the chunk."""
    ref, dist = _smooth_pair(16, 6, 135, 241)
    m = torch.from_numpy(ref).to(cuda_device)
    d = torch.from_numpy(dist).to(cuda_device)
    for gain in (float("inf"), 1.0):
        _vif_fast_scales_match(m[1:5], d[1:5], m, 0, gain)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 10, 16])
def test_kernel_vif_scale_edges(cuda_device, depth):
    """Kernel 5 on kernel 1's edge frames as f32 on the 8-bit scale, 1080p
    and 3840x2160, both statistics, gain inf and 1.0: decimated planes equal
    in every bit, num/den within 1e-5 relative."""
    from pqa2_tpu_torch.ops.cuda_vif import vif_scale
    from pqa2_tpu_torch.ops.vif import vif_scale_plain

    for h, w in ((1080, 1920), (2160, 3840)):
        ref, dist = _edge_frames(h, w, depth)
        div = float(1 << (depth - 8))
        ref = torch.from_numpy(ref.astype(np.float32) / div).to(cuda_device)
        dist = torch.from_numpy(dist.astype(np.float32) / div).to(cuda_device)
        for variant in ("classic", "default"):
            for gain in (float("inf"), 1.0):
                r, d = ref, dist
                for scale in range(4):
                    kw = dict(scale=scale, gain_limit=gain, variant=variant,
                              emit_next=scale < 3)
                    got = vif_scale(r, d, **kw)
                    want = vif_scale_plain(r, d, **kw)
                    for a, b in zip(got[:2], want[:2]):
                        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
                    for a, b in zip(got[2:4], want[2:4]):
                        assert (a is None and b is None) or torch.equal(a, b)
                    r, d = got[2], got[3]


@pytest.mark.cuda
def test_kernel_log2_audit(cuda_device, monkeypatch):
    """Kernel 2 compares on the card: 0 mismatches, exactly 1 against one
    wrong expected value; the public call launches once per device."""
    from pqa2_tpu_torch.ops import cuda_vif_int

    assert cuda_vif_int._log2_audit_launch(cuda_device) == 0
    want = cuda_vif_int._log2_expected(cuda_device).clone()
    want[32768 + 12345] += 1
    assert cuda_vif_int._log2_audit_launch(cuda_device, want) == 1
    monkeypatch.setattr(cuda_vif_int, "_AUDITED", set())
    launches = cuda_vif_int.log2_table_audit.launches
    assert cuda_vif_int.log2_table_audit(cuda_device) == 0
    assert cuda_vif_int.log2_table_audit(cuda_device) == 0
    assert cuda_vif_int.log2_table_audit.launches == launches + 1


def _adm_int_levels_match(r, d, drop, gain):
    """Kernel 3 at all four levels from a level-0 input: sums and both
    approximation planes equal to the plain version."""
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain
    from pqa2_tpu_torch.ops.cuda_adm_int import adm_int_level

    for lvl in range(4):
        if lvl:
            drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
        kw = dict(level=lvl, extra_row_shift=drop, gain_limit=gain)
        got = adm_int_level(r, d, **kw)
        want = adm_level_plain(r, d, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        r, d = got[1], got[2]


@pytest.mark.cuda
def test_kernel_adm_int_level_matches_plain(cuda_device):
    from pqa2_tpu_torch.ops.adm_int import level_input

    ref, dist = _smooth_pair(9, 4, 135, 241)
    for dt in (torch.uint8, torch.int32):
        r, drop = level_input(torch.from_numpy(ref).to(cuda_device, dt), 8)
        d, _ = level_input(torch.from_numpy(dist).to(cuda_device, dt), 8)
        _adm_int_levels_match(r, d, drop, 100.0)


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [100.0, 1.0])
@pytest.mark.parametrize("depth", [8, 10, 12, 16])
def test_kernel_adm_int_level_edges(cuda_device, depth, gain):
    """Kernel 3 at the edges of its arithmetic (an int32 DWT up to 12 bits,
    level 0's widened row pass at 16, level 3 widened) on the edge frames
    at 1080p and 3840x2160, all four levels, gain 100 and 1.0 (NEG): equal
    to the plain version; at 8 bits on uint8 luma and on int32 Q4 codes."""
    from pqa2_tpu_torch.ops.adm_int import level_input

    for h, w in ((1080, 1920), (2160, 3840)):
        ref, dist = _edge_frames(h, w, depth)
        for dt in ((torch.uint8, torch.int32) if depth == 8 else (torch.int32,)):
            r, drop = level_input(torch.from_numpy(ref).to(cuda_device, dt), depth)
            d, _ = level_input(torch.from_numpy(dist).to(cuda_device, dt), depth)
            _adm_int_levels_match(r, d, drop, gain)


@pytest.mark.cuda
def test_kernel_adm_int_level_uint8_chunk(cuda_device):
    """The main path's level-0 call: the chunk's uint8 luma, the core frames
    a slice of it (the first chunk, a middle one, a one-frame tail)."""
    from pqa2_tpu_torch.ops.adm_int import level_input

    ref, dist = _smooth_pair(17, 6, 135, 241)
    m = torch.from_numpy(ref).to(cuda_device)
    d = torch.from_numpy(dist).to(cuda_device)
    for core in (slice(1, 5), slice(0, 5), slice(5, 6)):
        r0, drop = level_input(m[core], 8)
        d0, _ = level_input(d[core], 8)
        assert r0.dtype == torch.uint8 and r0.data_ptr() == m[core].data_ptr()
        _adm_int_levels_match(r0, d0, drop, 100.0)


@pytest.mark.cuda
def test_kernel_adm_quotient_audit(cuda_device):
    """The decoupling's quotient routine on the card: every input of the
    envelope and the directed numerators, 0 mismatches."""
    from pqa2_tpu_torch.ops.cuda_adm_int import quotient_audit

    assert quotient_audit(cuda_device) == 0


@pytest.mark.cuda
def test_kernel_ssim_sse_matches_plain(cuda_device):
    from pqa2_tpu_torch.ops.cuda_ssim import ssim_sse_plane
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain

    ref, dist = _smooth_pair(10, 3, 135, 241)
    r = torch.from_numpy(ref).float().to(cuda_device)
    d = torch.from_numpy(dist).float().to(cuda_device)
    s_k, e_k = ssim_sse_plane(r, d, 8)
    s_p, e_p = ssim_sse_plane_plain(r, d, 8)
    assert (s_k.double() - s_p.double()).abs().max().item() <= SSIM_ATOL
    assert torch.equal(e_k, e_p)


def _float_pair(seed, n, h, w, device):
    ref, dist = _smooth_pair(seed, n, h, w)
    return (torch.from_numpy(ref).float().to(device),
            torch.from_numpy(dist).float().to(device))


@pytest.mark.cuda
def test_kernel_vif_scale_matches_plain(cuda_device):
    """Kernel 5 at every scale, both statistics, gain inf and 1.0: decimated
    planes equal in every bit, num/den within 1e-5 relative (f32 sums in
    another order), the motion SAD of kernel 7 within 1e-5 relative, and a
    second launch gives the same bits."""
    from pqa2_tpu_torch.ops.cuda_vif import vif_scale
    from pqa2_tpu_torch.ops.motion import motion_sad_plain
    from pqa2_tpu_torch.ops.vif import vif_scale_plain

    ref, dist = _float_pair(11, 6, 135, 241, cuda_device)
    for variant, gain in (("classic", float("inf")), ("classic", 1.0),
                          ("default", float("inf"))):
        r, d = ref[1:5].contiguous(), dist[1:5].contiguous()
        for scale in range(4):
            kw = dict(scale=scale, gain_limit=gain, variant=variant, emit_next=scale < 3)
            got = vif_scale(r, d, motion_ref=ref if scale == 0 else None, **kw)
            again = vif_scale(r, d, **kw)
            want = vif_scale_plain(r, d, **kw)
            for a, b in zip(got[:2], want[:2]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
            for a, b in zip(got[:4], again[:4]):
                assert (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(got[2:4], want[2:4]):
                assert (a is None and b is None) or torch.equal(a, b)
            if scale == 0:
                torch.testing.assert_close(got[4], motion_sad_plain(ref), rtol=1e-5, atol=0)
            r, d = got[2], got[3]


@pytest.mark.cuda
def test_kernel_adm_level_matches_plain(cuda_device):
    """Kernel 6 at every level, gain 100 and 1.0: approximation bands equal in
    every bit, the six sums within 1e-5 relative, repeatable bits."""
    from pqa2_tpu_torch.ops.adm import adm_level_plain_float
    from pqa2_tpu_torch.ops.cuda_adm import adm_level

    ref, dist = _float_pair(12, 4, 135, 241, cuda_device)
    for gain in (100.0, 1.0):
        r, d = ref, dist
        for lvl in range(4):
            got = adm_level(r, d, level=lvl, gain_limit=gain)
            again = adm_level(r, d, level=lvl, gain_limit=gain)
            want = adm_level_plain_float(r, d, level=lvl, gain_limit=gain)
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
            for a, b in zip(got, again):
                assert torch.equal(a, b)
            assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            r, d = got[1], got[2]


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [100.0, 1.0])
def test_kernel_adm_level_edges(cuda_device, gain):
    """Kernel 6 on kernel 3's edge frames as f32 on the 8-bit scale, 1080p
    and 3840x2160, all four levels: approximation bands equal in every bit,
    the six sums within 1e-5 relative, repeatable bits."""
    from pqa2_tpu_torch.ops.adm import adm_level_plain_float
    from pqa2_tpu_torch.ops.cuda_adm import adm_level

    for h, w in ((1080, 1920), (2160, 3840)):
        for depth in (8, 10, 12, 16):
            ref, dist = _edge_frames(h, w, depth)
            div = float(1 << (depth - 8))
            r = torch.from_numpy(ref.astype(np.float32) / div).to(cuda_device)
            d = torch.from_numpy(dist.astype(np.float32) / div).to(cuda_device)
            for lvl in range(4):
                got = adm_level(r, d, level=lvl, gain_limit=gain)
                again = adm_level(r, d, level=lvl, gain_limit=gain)
                want = adm_level_plain_float(r, d, level=lvl, gain_limit=gain)
                torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
                for a, b in zip(got, again):
                    assert torch.equal(a, b)
                assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                r, d = got[1], got[2]


@pytest.mark.cuda
def test_kernel_motion_sad_matches_plain(cuda_device):
    """Kernel 7: frame 0 exactly 0, the rest within 1e-5 relative, repeatable
    bits; on an odd plane (4-byte copies), at 1 and 2 frames, at RUN + 1
    frames (a run split across blocks), 1080p (34 frames) and 3840x2160."""
    from pqa2_tpu_torch.ops.cuda_motion import RUN, motion_sad
    from pqa2_tpu_torch.ops.motion import motion_sad_plain

    def moving(seed, n, h, w):
        ref, _ = _float_pair(seed, n, h, w, cuda_device)
        return torch.stack([torch.roll(f, 2 * i, dims=1) for i, f in enumerate(ref)])

    cases = [moving(13, 5, 135, 241), moving(15, 2 * RUN + 3, 72, 96)]
    big = moving(16, RUN + 1, 1080, 1920)
    cases += [big[:1], big[:2], big, torch.cat([big, big[:RUN + 1]]),
              moving(17, 3, 2160, 3840)]
    for ref in cases:
        got = motion_sad(ref)
        assert got[0].item() == 0.0 and torch.equal(got, motion_sad(ref))
        torch.testing.assert_close(got, motion_sad_plain(ref), rtol=1e-5, atol=0)
