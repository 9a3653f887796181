"""The port's float family end to end against the JAX package, on the CPU.

A 10-frame 72x96 4:2:0 pair made as in tests/test_torch_slice.py,
chunk_size=4 (chunks 4+4+2: both motion halos and a short tail), scored
with the float-trained ``vmaf_float_v0.6.1`` through the port's
``VMAFAnalyzer(device="cpu")`` (the kernels' plain versions), and with the
bootstrap ``vmaf_float_b_v0.6.3``, against ``pqa2_tpu``'s ``stream_score``
on the same files in one child interpreter
(``test_torch_slice.jax_stream_scores``) and against the float64 oracles;
its NEG variant against the oracles at gain limit 1.0.

The port rounds every f32 product and sum on its own, in the JAX package's
operation order; the JAX child runs without FMA instructions so that its
jitted pipeline does the same (with FMAs, its own small-scale VIF and its
VMAF move by more than these tolerances against its op-by-op run;
ROADMAP Queue 3).

Tolerances (each with its reason):
  vif_scale*, adm2    atol 5e-5 vs JAX, inside the JAX package's own kernel-
                      vs-twin budgets of 2e-4 / 3e-4 (tests/test_pallas.py:60,
                      :140)
  motion/motion2      rtol 1e-5 vs JAX (the f32 mean of the same blurred values)
  vs the oracles      vif 2e-4, adm2 2e-4, motion 2e-3 (tests/test_ops.py)
  VMAF                atol 5e-3 vs JAX (features within 5e-5 times the SVR's
                      slopes), the bootstrap's 21 sub-models likewise; atol
                      1e-2 vs the float64 chain (oracle features through the
                      float64 SVR), the JAX package's own float-VMAF budget
                      (tests/test_goldens.py:55)
  PSNR, SSIM          as in tests/test_torch_slice.py
  chunked vs whole    atol 1e-5

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests, so it runs after every file of the JAX
package whose order matters (ROADMAP Q1.0).
"""

import os

import numpy as np
import pytest

from test_torch_slice import (
    CHUNK,
    FEATURES,
    PSNR_ATOL,
    ROOT,
    SSIM_ATOL,
    jax_stream_scores,
    write_clip,
)

N = 10

FLOAT_VIF_ATOL = 5e-5
FLOAT_ADM_ATOL = 5e-5
FLOAT_MOTION_RTOL = 1e-5
FLOAT_VMAF_ORACLE_ATOL = 1e-2
FLOAT_VMAF_ATOL = 5e-3
ORACLE_VIF = 2e-4
ORACLE_ADM = 2e-4
ORACLE_MOTION = 2e-3
CHUNK_ATOL = 1e-5

FLOAT_MODEL = "vmaf_float_v0.6.1"
NEG_MODEL = "vmaf_float_v0.6.1neg"
BOOT_MODEL = "vmaf_float_b_v0.6.3"


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("torch_slice_float"), N)


@pytest.fixture(scope="module")
def jax_runs(clip):
    """The JAX package's float and bootstrap runs on the clip."""
    return jax_stream_scores(clip, [FLOAT_MODEL, BOOT_MODEL])


@pytest.fixture(scope="module")
def port_float(clip, tmp_path_factory):
    """``VMAFAnalyzer(device="cpu").analyze_videos`` with the float model:
    (results dict, ClipScores)."""
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    (ref_path, dist_path), _, _, _ = clip
    a = VMAFAnalyzer(device="cpu")
    a.chunk_size = CHUNK
    a.set_output_directory(str(tmp_path_factory.mktemp("float_out")))
    res = a.analyze_videos(ref_path, dist_path, model=FLOAT_MODEL)
    assert res is not None
    return res, a.last_scores


@pytest.fixture(scope="module")
def oracle_features(clip):
    """The float family's features of every frame from the float64 oracles,
    in the float models' order (adm2, motion2, vif_scale0..3)."""
    from pqa2_tpu.golden.adm import adm_features
    from pqa2_tpu.golden.motion import motion_features
    from pqa2_tpu.golden.vif import vif_features

    _, ref, dist, _ = clip
    vif = np.array([vif_features(ref[i], dist[i], variant="classic") for i in range(N)])
    adm2 = np.array([adm_features(ref[i], dist[i])[0] for i in range(N)])
    motion, motion2 = motion_features(ref.astype(np.float64))
    return {"adm2": adm2, "motion": np.asarray(motion), "motion2": np.asarray(motion2),
            **{f"vif_scale{s}": vif[:, s] for s in range(4)}}


def _oracle_vmaf(model, feats):
    """Every sub-model's float64 prediction from float64 features, (M, N)."""
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    from test_svr import numpy_predict

    x = np.stack([feats[k] for k in model.feature_names], axis=-1)
    subs = model.models if hasattr(model, "models") else (model,)
    return np.stack([numpy_predict(m, x) for m in subs])


def _assert_feature_matches_jax(k, got, want):
    if k.startswith("motion"):
        np.testing.assert_allclose(got, want, rtol=FLOAT_MOTION_RTOL, atol=0, err_msg=k)
    else:
        tol = FLOAT_ADM_ATOL if k == "adm2" else FLOAT_VIF_ATOL
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)


def test_float_features_match_jax_and_oracles(jax_runs, port_float, oracle_features):
    for k in FEATURES:
        got = port_float[1].features[k]
        assert got.shape == (N,)
        _assert_feature_matches_jax(k, got, jax_runs[FLOAT_MODEL].features[k])
        oracle_tol = {"adm2": ORACLE_ADM, "motion": ORACLE_MOTION,
                      "motion2": ORACLE_MOTION}.get(k, ORACLE_VIF)
        np.testing.assert_allclose(got, oracle_features[k], rtol=0, atol=oracle_tol,
                                   err_msg=k)


def test_float_vmaf_psnr_ssim_match_jax(jax_runs, port_float, oracle_features):
    from pqa2_tpu.models import get_model

    res, got = port_float
    want = jax_runs[FLOAT_MODEL]
    assert got.model_name == want.model_name == FLOAT_MODEL
    assert not got.uses_integer_features
    np.testing.assert_allclose(got.vmaf, _oracle_vmaf(get_model(FLOAT_MODEL),
                                                      oracle_features)[0],
                               rtol=0, atol=FLOAT_VMAF_ORACLE_ATOL)
    np.testing.assert_allclose(got.vmaf, want.vmaf, rtol=0, atol=FLOAT_VMAF_ATOL)
    assert 20.0 < got.vmaf.min() and got.vmaf.max() < 95.0
    for k in ("psnr_y", "psnr_u", "psnr_v", "psnr_avg"):
        np.testing.assert_allclose(got.psnr[k], want.psnr[k], rtol=0, atol=PSNR_ATOL)
    for k in ("ssim_y", "ssim_u", "ssim_v", "ssim_all"):
        np.testing.assert_allclose(got.ssim[k], want.ssim[k], rtol=0, atol=SSIM_ATOL)
    assert res["model"] == FLOAT_MODEL and res["frame_count"] == N
    assert abs(res["vmaf_score"] - float(np.mean(want.vmaf))) <= FLOAT_VMAF_ATOL
    for k in ("json_path", "psnr_log", "ssim_log"):
        assert os.path.exists(res[k])
    assert len(res["raw_results"]["frames"]) == N


def test_float_chunked_equals_whole_clip(clip, port_float):
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    whole = stream_score(*clip[0], model=FLOAT_MODEL, chunk_size=16, device="cpu")
    got = port_float[1]
    for k in FEATURES:
        np.testing.assert_allclose(got.features[k], whole.features[k], rtol=0,
                                   atol=CHUNK_ATOL, err_msg=k)
    np.testing.assert_allclose(got.vmaf, whole.vmaf, rtol=0, atol=CHUNK_ATOL)


def test_float_neg_model_matches_oracles(clip, port_float):
    """``vmaf_float_v0.6.1neg``: VIF and ADM at gain limit 1.0, which lowers
    them against the unlimited float model's, end to end against the float64
    oracles at the same limit (the per-op comparison with the JAX twins at
    gain 1.0 is tests/test_torch_float.py)."""
    from pqa2_tpu.golden.adm import adm_features
    from pqa2_tpu.golden.vif import vif_features
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    _, ref, dist, _ = clip
    got = stream_score(*clip[0], model=NEG_MODEL, chunk_size=CHUNK, with_psnr=False,
                       with_ssim=False, device="cpu")
    assert got.model_name == NEG_MODEL
    vif = np.array([vif_features(ref[i], dist[i], gain_limit=1.0, variant="classic")
                    for i in range(N)])
    adm2 = np.array([adm_features(ref[i], dist[i], gain_limit=1.0)[0] for i in range(N)])
    for s in range(4):
        np.testing.assert_allclose(got.features[f"vif_scale{s}"], vif[:, s], rtol=0,
                                   atol=ORACLE_VIF)
    np.testing.assert_allclose(got.features["adm2"], adm2, rtol=0, atol=ORACLE_ADM)
    plain = port_float[1].features
    assert np.all(got.features["adm2"] <= plain["adm2"])
    assert not np.array_equal(got.features["adm2"], plain["adm2"])
    np.testing.assert_array_equal(got.features["motion2"], plain["motion2"])


def test_float_bootstrap_matches_jax(clip, jax_runs, oracle_features):
    from pqa2_tpu.models import get_model
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    got = stream_score(*clip[0], model=BOOT_MODEL, chunk_size=CHUNK, with_psnr=False,
                       with_ssim=False, device="cpu")
    want = jax_runs[BOOT_MODEL]
    assert got.bootstrap.shape == want.bootstrap.shape == (21, N)
    np.testing.assert_allclose(got.bootstrap, _oracle_vmaf(get_model(BOOT_MODEL),
                                                           oracle_features),
                               rtol=0, atol=FLOAT_VMAF_ORACLE_ATOL)
    np.testing.assert_allclose(got.bootstrap, want.bootstrap, rtol=0, atol=FLOAT_VMAF_ATOL)
    np.testing.assert_allclose(got.vmaf, want.vmaf, rtol=0, atol=FLOAT_VMAF_ATOL)


def test_cli_score_float_model_on_cpu(clip, tmp_path, capsys):
    import json

    from pqa2_tpu_torch.cli import main

    (ref_path, dist_path), _, _, _ = clip
    rc = main(["score", ref_path, dist_path, "--model", FLOAT_MODEL, "--device", "cpu",
               "--out", str(tmp_path), "--no-psnr", "--no-ssim"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == N and 0 < out["vmaf"] < 95 and out["psnr"] is None
