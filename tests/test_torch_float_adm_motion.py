"""The port's float ADM and motion against the JAX package and the oracles,
and the float chain against the checked-in pins.

Inputs, twins and tolerances as in tests/test_torch_float.py (adm2 atol
5e-5 vs the twin, inside the JAX package's 3e-4 of test_pallas.py:140;
motion rtol 1e-5; the oracles' vif 2e-4, adm2 2e-4, motion 2e-3). Keep this
file below eight tests (see tests/test_torch_float.py).
"""

import numpy as np
import pytest
import torch

from pqa2_tpu.golden import adm as gold_adm
from pqa2_tpu.golden import motion as gold_motion
from test_torch_float import (
    ADM_ATOL,
    MOTION_RTOL,
    ORACLE_ADM,
    ORACLE_MOTION,
    SHAPES,
    _pair,
    _t,
    _twin,
    jnp,
)


# -- ADM -----------------------------------------------------------------------

@pytest.mark.parametrize("shape,gain", [("72x96", 100.0), ("71x97", 100.0),
                                        ("72x96", 1.0)])
def test_adm_matches_jax_and_oracle(shape, gain):
    from pqa2_tpu.ops import adm as ja
    from pqa2_tpu_torch.ops import cuda_adm
    from pqa2_tpu_torch.ops.adm import adm_features_batched

    ref, dist = _pair(SHAPES[shape])
    got = adm_features_batched(_t(ref), _t(dist), gain).numpy()
    want = np.asarray(_twin(ja.adm_features_batched, "gain_limit")(
        jnp.asarray(ref), jnp.asarray(dist), gain_limit=gain))
    np.testing.assert_allclose(got, want, rtol=0, atol=ADM_ATOL)
    # The per-level kernel contract and adm_features_pallas's tail.
    tail = cuda_adm.adm_features(_t(ref), _t(dist), gain_limit=gain).numpy()
    np.testing.assert_allclose(tail, want, rtol=0, atol=ADM_ATOL)
    for i in range(ref.shape[0]):
        oracle = gold_adm.adm_features(ref[i], dist[i], gain_limit=gain)
        oracle = oracle[0] if isinstance(oracle, tuple) else oracle
        np.testing.assert_allclose(got[i], oracle, rtol=0, atol=ORACLE_ADM)
    assert np.all(got < 0.99)


def test_adm_level_contract():
    """(N, 6) sums in [num_h, den_h, num_v, den_v, num_d, den_d] order and
    ceil-halved approximation bands at every level of an odd frame: each
    sum's cube root plus the stabiliser is the oracle's sum_cube (rtol
    1e-5: f32 cube sums against float64)."""
    from pqa2_tpu.golden.adm import apply_csf, cm_threshold, decouple, dwt2_db2, sum_cube
    from pqa2_tpu_torch.ops.adm import _stabiliser, adm_level_plain_float, cbrt

    ref, dist = _pair(SHAPES["71x97"])
    r, d = _t(ref), _t(dist)
    ro, do = ref[0].astype(np.float64), dist[0].astype(np.float64)
    for lvl in range(4):
        sums, r, d = adm_level_plain_float(r, d, level=lvl, gain_limit=100.0)
        o, t = dwt2_db2(ro), dwt2_db2(do)
        assert sums.shape == (3, 6) and r.shape[-2:] == o["a"].shape
        rst, add = decouple(o, t, 100.0)
        mt = cm_threshold(apply_csf(add, lvl))
        csf_r, csf_o = apply_csf(rst, lvl), apply_csf(o, lvl)
        want = []
        for b in "hvd":
            want += [sum_cube(np.maximum(np.abs(csf_r[b]) - mt, 0.0)), sum_cube(csf_o[b])]
        got = cbrt(sums[0]).numpy().astype(np.float64) + _stabiliser(*o["h"].shape)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        ro, do = o["a"], t["a"]


# -- motion --------------------------------------------------------------------

def test_motion_matches_jax_and_oracle():
    """Every has_prev/has_next pair of the halo contract."""
    for has_prev, has_next in ((False, False), (True, True), (True, False), (False, True)):
        _motion_matches(has_prev, has_next)


def _motion_matches(has_prev, has_next):
    from pqa2_tpu.ops import motion as jm
    from pqa2_tpu_torch.ops import cuda_motion
    from pqa2_tpu_torch.ops.motion import features_from_sad_prev, motion_features

    ref, _ = _pair((5, 72, 96))
    got = motion_features(_t(ref), has_prev=has_prev, has_next=has_next)
    want = _twin(jm.motion_features, "has_prev", "has_next")(
        jnp.asarray(ref), has_prev=has_prev, has_next=has_next)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MOTION_RTOL, atol=0)
    # Kernel 7's contract: the SAD sum / (H*W), frame 0 paired with itself.
    sad = cuda_motion.motion_sad(_t(ref))
    assert sad[0].item() == 0.0 and sad.shape == (5,)
    via_sad = features_from_sad_prev(sad[1:], 5, has_prev=has_prev, has_next=has_next)
    for g, w in zip(via_sad, got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=MOTION_RTOL, atol=0)
    motion, motion2 = gold_motion.motion_features(ref.astype(np.float64))
    lead = 1 if has_prev else 0
    core = slice(lead, 5 - (1 if has_next else 0))
    if not has_prev and not has_next:
        np.testing.assert_allclose(got[0].numpy(), motion, rtol=0, atol=ORACLE_MOTION)
        np.testing.assert_allclose(got[1].numpy(), motion2, rtol=0, atol=ORACLE_MOTION)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(motion)[core], rtol=0,
                                   atol=ORACLE_MOTION)
    assert np.all(got[0].numpy()[1 - lead:] > 0)


# -- the checked-in goldens of the float chain ----------------------------------

def test_float_goldens_pinned():
    """The float branch of extract_features_batched and the predictor on the
    clip of tests/goldens/regression_golden.json, held to the pins that
    tests/test_goldens.py holds the JAX package to (float precision: VMAF
    atol 0.01; features adm2 2e-4, motion2 1e-3, vif 2e-4); and
    ``score_clip`` with chunk_size=4, as that test calls the JAX one, held
    to the same VMAF pins."""
    for model_name in ("vmaf_v0.6.1", "vmaf_v0.6.1neg", "vmaf_4k_v0.6.1",
                       "vmaf_float_v0.6.1"):
        _golden_pins(model_name)


def _golden_pins(model_name):
    import json
    import pathlib

    from pqa2_tpu_torch.models.registry import get_model
    from pqa2_tpu_torch.models.svr import predictor_for_model
    from pqa2_tpu_torch.pipeline.features import extract_features_batched, model_feature_params
    from pqa2_tpu_torch.pipeline.scoring import score_clip

    golden = json.loads((pathlib.Path(__file__).parent / "goldens"
                         / "regression_golden.json").read_text())
    rng = np.random.default_rng(20260816)  # the generator of tests/test_goldens.py
    n, h, w = golden["n"], golden["h"], golden["w"]
    base = (rng.uniform(16, 235, (1, h, w))
            + rng.uniform(-18, 18, (n, 1, 1)) + rng.normal(0, 9, (n, h, w)))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(np.clip(base, 0, 255))
    dist = np.round(np.clip(ref + rng.normal(0, 5, ref.shape), 0, 255))

    model = get_model(model_name)
    params = model_feature_params(model, "float", device="cpu")
    assert params.pop("precision") == "float"
    feats = extract_features_batched(_t(ref.astype(np.float32)), _t(dist.astype(np.float32)),
                                     precision="float", **params)
    x = torch.stack([feats[k] for k in model.feature_names], dim=-1)
    vmaf = predictor_for_model(model)(x).numpy()
    np.testing.assert_allclose(vmaf, golden["vmaf"][model_name], rtol=0, atol=0.01)
    chunked = score_clip(ref.astype(np.float32), dist.astype(np.float32), model=model_name,
                         chunk_size=4, precision="float", device="cpu")
    np.testing.assert_allclose(chunked.vmaf, golden["vmaf"][model_name], rtol=0, atol=0.01)
    if model_name == "vmaf_v0.6.1":
        for i, fr in enumerate(golden["frames"]):
            assert abs(feats["adm2"][i].item() - fr["adm2"]) <= 2e-4
            assert abs(feats["motion2"][i].item() - fr["motion2"]) <= 1e-3
            for s in range(4):
                assert abs(feats[f"vif_scale{s}"][i].item() - fr["vif"][s]) <= 2e-4, (i, s)
