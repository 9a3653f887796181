"""CPU tests of the comparison that decides ``correct``: the frozen
reference against the port's own oracles, the reference's imports, and
runs at a tiny size with the timed path broken underneath (each must come
out not correct), and the control (integer_fast features, bfloat16 plane
metrics), which must come out not correct too.

Run from the repository's root: ``python -m pytest perfbench/tests -q``.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import frame as ref_frame

from test_perfbench_harness import run_tiny, tiny


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top in ("numpy", "typing", "__future__", "os", "math", "perfbench"), (path, n)


@pytest.mark.parametrize("depth", [8, 10])
def test_reference_equals_the_ports_oracles(depth):
    """The frozen reference against the port's golden/ at 72x96: every
    feature, PSNR and SSIM value the same."""
    from pqa2_tpu_torch.golden.adm_int import adm_features_int
    from pqa2_tpu_torch.golden.motion_int import motion_features_int
    from pqa2_tpu_torch.golden.psnr import psnr_frame
    from pqa2_tpu_torch.golden.ssim import ssim_frame
    from pqa2_tpu_torch.golden.vif_int import vif_features_int

    rng = np.random.default_rng(depth)
    top = (1 << depth) - 1
    dt = np.uint8 if depth == 8 else np.uint16
    ref_y = rng.integers(0, top + 1, (3, 72, 96)).astype(dt)
    ref_y = ((ref_y.astype(np.int64) + np.roll(ref_y, 1, axis=2)) // 2).astype(dt)
    dist = {"y": np.clip(ref_y[1].astype(np.int64) + rng.integers(-9, 10, (72, 96)), 0, top).astype(dt),
            "u": rng.integers(0, top + 1, (36, 48)).astype(dt),
            "v": rng.integers(0, top + 1, (36, 48)).astype(dt)}
    ref = {"y": ref_y[1], "u": rng.integers(0, top + 1, (36, 48)).astype(dt),
           "v": rng.integers(0, top + 1, (36, 48)).astype(dt)}
    got = ref_frame.frame_reference(list(ref_y), 1, dist, ref, bit_depth=depth,
                                    model_file="vmaf_v0.6.1.npz", vif_gain=None,
                                    adm_gain=100.0, first=False, last=False)
    vif = vif_features_int(ref["y"], dist["y"], np.inf, depth)
    assert [got[f"vif_scale{k}"] for k in range(4)] == vif
    assert got["adm2"] == adm_features_int(ref["y"], dist["y"], 100.0, depth)[0]
    motion, motion2 = motion_features_int(ref_y, depth)
    assert got["motion"] == motion[1] and got["motion2"] == motion2[1]
    want = {**psnr_frame(ref, dist, max_value=top), **ssim_frame(ref, dist, bit_depth=depth)}
    for k, v in want.items():
        assert got[k] == v, k


def test_reference_vmaf_equals_the_ports_predictor():
    """The reference's own reading of the model file against the port's
    SVR in float64 on the same features."""
    from pqa2_tpu_torch.models.registry import get_model

    feats = {"adm2": 0.93, "motion2": 3.1, "vif_scale0": 0.41, "vif_scale1": 0.77,
             "vif_scale2": 0.86, "vif_scale3": 0.91, "motion": 3.3}
    m = get_model("vmaf_v0.6.1")
    x = np.array([feats[n] for n in m.feature_names]) * m.slopes[1:] + m.intercepts[1:]
    k = np.exp(-m.gamma * np.sum((x - m.sv) ** 2, axis=1))
    s = (float(k @ m.sv_coef) - m.rho - m.intercepts[0]) / m.slopes[0]
    st = m.score_transform
    s = min(max(max(st.p0 + st.p1 * s + st.p2 * s * s, s), 0.0), 100.0)
    assert abs(ref_frame.svr_vmaf(feats, "vmaf_v0.6.1.npz") - s) < 1e-9


# What libvmaf's published model files state (model/vmaf_v0.6.1.json and
# model/vmaf_4k_v0.6.1.json of the Netflix vmaf repository, as the repo's
# SURVEY.md quotes them): feature order, SVR constants, transform and clip.
PUBLISHED = {
    "vmaf_v0.6.1.npz": dict(n_sv=211, rho=-1.33133,
                            transform=(1.70674692, 1.72643844, -0.00705305, 1.0),
                            clip=(0.0, 100.0)),
    "vmaf_4k_v0.6.1.npz": dict(n_sv=262, rho=-2.30449, transform=None, clip=None),
}


@pytest.mark.parametrize("model_file", sorted(PUBLISHED))
def test_reference_models_hold_the_published_values(model_file):
    """The reference's model files against libvmaf's published values,
    not against the program's registry."""
    pub = PUBLISHED[model_file]
    m = np.load(os.path.join(ref_frame.MODELS_DIR, model_file))
    assert [str(n) for n in m["feature_names"]] == [
        "adm2", "motion2", "vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3"]
    assert m["slopes"].shape == (7,) and m["intercepts"].shape == (7,)
    assert m["sv"].shape == (pub["n_sv"], 6) and m["sv_coef"].shape == (pub["n_sv"],)
    assert float(m["gamma"]) == 0.04 and float(m["rho"]) == pub["rho"]
    if pub["transform"] is None:
        assert "score_transform" not in m.files
    else:
        assert tuple(float(v) for v in m["score_transform"]) == pub["transform"]
    if pub["clip"] is not None:
        assert tuple(float(v) for v in m["score_clip"]) == pub["clip"]


@pytest.mark.parametrize("seed", [1, 2**31 + 77, 2**40 + 3])
def test_plan_takes_every_rung_and_inner_frames(seed):
    """The sample holds a request of each rung the window ran, a chunk
    boundary's two frames in each, and frames inside the chunks."""
    from perfbench import check

    recs = [harness.Record(i, i % 4, 0.1, {}, None) for i in range(37)]
    traffic = {"check": {"requests": 4, "frames_per_request": 3}}
    items = check.plan(recs, 180, 32, traffic, seed)
    by_req = {}
    for it in items:
        by_req.setdefault(it.record.index, []).append(it.frame)
    assert sorted(recs[i].rung for i in by_req) == [0, 1, 2, 3]
    edges = {0, 179} | {c for b in range(32, 180, 32) for c in (b - 1, b)}
    for frames in by_req.values():
        assert len(frames) == 3 == len(set(frames))
        assert any(f - 1 in frames and f % 32 == 0 for f in frames)
        assert any(f not in edges for f in frames)


def test_sound_tiny_run_is_correct():
    _, out = run_tiny("hd8_frames_mem", seed=2**31 + 99)
    assert out["correct"] is True
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


def _perturb_vif(monkeypatch):
    """A feature altered where it is produced."""
    import pqa2_tpu_torch.pipeline.scoring as scoring

    orig = scoring.fetch_features

    def bad(feats):
        out = orig(feats)
        out["vif_scale0"] = out["vif_scale0"] + np.float32(1e-3)
        return out

    monkeypatch.setattr(scoring, "fetch_features", bad)


def _half_pooled(monkeypatch):
    """Half of the frames left out of the pooled scores, the mean taken
    over the rest."""
    import pqa2_tpu_torch.app.vmaf_analyzer as va
    import pqa2_tpu_torch.pipeline.scoring as scoring

    orig = scoring.pool_metric

    def bad(values, method="mean"):
        values = np.asarray(values)
        return orig(values[: max(1, values.size // 2)], method)

    monkeypatch.setattr(scoring, "pool_metric", bad)
    monkeypatch.setattr(va, "pool_metric", bad)


def _half_planes(monkeypatch):
    """Half of a chunk's frames left out of PSNR and SSIM, the rest's
    values repeated in their place."""
    import pqa2_tpu_torch.pipeline.scoring as scoring

    orig = scoring.plane_metrics

    def bad(planes, bit_depth, with_psnr, with_ssim):
        n = planes["y"][0].shape[0]
        half = {p: (r[: max(1, n // 2)], d[: max(1, n // 2)]) for p, (r, d) in planes.items()}
        ps, ss = orig(half, bit_depth, with_psnr, with_ssim)
        idx = np.minimum(np.arange(n), max(1, n // 2) - 1)
        return ({k: v[idx] for k, v in ps.items()} if ps else ps,
                {k: v[idx] for k, v in ss.items()} if ss else ss)

    monkeypatch.setattr(scoring, "plane_metrics", bad)


@pytest.mark.parametrize("fault", [_perturb_vif, _half_pooled, _half_planes])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    _, out = run_tiny("hd8_frames_mem", seed=2**31 + 123)
    assert out["correct"] is False


def test_control_is_not_correct():
    """integer_fast features, the bfloat16 SVR and bfloat16 PSNR/SSIM
    each fail their own number."""
    bench, c, cfg, traffic = tiny("hd8_frames_mem")
    run = harness.Run(bench, c, cfg, traffic, seed=2**31 + 7, seconds=0.5, trace=False,
                      device="cpu", precision="integer_fast",
                      override=control.bf16_override(torch, cfg))
    out = run.execute()
    assert out["correct"] is False
    ch = out["checks"]
    assert ch["feature_gap"]["value"] > ch["feature_gap"]["limit"]
    assert ch["vmaf_gap"]["value"] > ch["vmaf_gap"]["limit"]
    assert ch["psnr_gap"]["value"] > ch["psnr_gap"]["limit"]
    assert ch["ssim_gap"]["value"] > ch["ssim_gap"]["limit"]
