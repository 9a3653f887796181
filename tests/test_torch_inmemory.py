"""The port's in-memory scoring and settings API, on the CPU.

  * ``score_clip`` against the JAX package's ``score_clip`` with
    ``vmaf_v0.6.1`` at ``integer``, ``integer_fast`` and ``float`` (the JAX
    side in one child interpreter, tests/test_torch_fast.py:jax_child; it
    scores the 9-frame clip as one chunk padded to 16 frames, so its
    clip-end ``motion2`` restore runs, while the port scores 9 frames);
  * the port's chunked result (chunk 4: chunks 4+4+1, both halos and a
    one-frame tail) equals its whole-clip result, bit for bit;
  * ``score_planes``/``VMAFAnalyzer.analyze_frames`` on decoded frames
    equal ``analyze_videos`` on the same y4m pair, bit for bit, also with
    the luma handed over as tensors, with a feature subsample and at 10
    bits;
  * ``VMAFAnalyzer(options_manager=...)``, ``VMAFAnalysisThread`` and
    ``cli score --precision`` reach the feature extraction with the chosen
    precision;
  * ``ClipScores.pooled`` returns the JAX class's dict for each method.

The clip is tests/test_torch_slice.py's (72x96 4:2:0, 9 frames).

Tolerances against JAX (each with its reason):
  vif_scale*      integer: equal (the same integer sums and f32 combine);
                  integer_fast: atol 2e-6 (tests/test_torch_fast.py);
                  float: atol 5e-5 (tests/test_torch_slice_float.py)
  adm2            integer families atol 2e-6 (f32 cbrt ulp), float 5e-5
  motion/motion2  integer families rtol 1e-6 (JAX's f32 hi/lo SAD fold),
                  float rtol 1e-5 (the f32 mean of the same blurred values)
  VMAF            atol 1e-3 (f32 exp and the ~83x inverse rescale)

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_fast import jax_child
from test_torch_slice import CHUNK, FEATURES, N, VMAF_ATOL, write_clip

PRECISIONS = ("integer", "integer_fast", "float")
MODEL = "vmaf_v0.6.1"
WHOLE = 16  # >= N: one chunk

VIF_ATOL = {"integer": 0.0, "integer_fast": 2e-6, "float": 5e-5}
ADM_ATOL = {"integer": 2e-6, "integer_fast": 2e-6, "float": 5e-5}
MOTION_RTOL = {"integer": 1e-6, "integer_fast": 1e-6, "float": 1e-5}

_JAX = """
from pqa2_tpu.pipeline.scoring import score_clip
out = {}
for p in ("integer", "integer_fast", "float"):
    s = score_clip(z["ref"], z["dist"], model="vmaf_v0.6.1", chunk_size=16, precision=p)
    out[p] = (s.features, s.vmaf)
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("torch_inmemory"))


@pytest.fixture(scope="module")
def jax_clip_scores(clip, tmp_path_factory):
    """{precision: (features, vmaf)} of the JAX package's score_clip."""
    _, ref, dist, _ = clip
    return jax_child(_JAX, {"ref": ref, "dist": dist}, tmp_path_factory.mktemp("jax"))


@pytest.fixture(scope="module")
def port_clip_scores(clip):
    """{(precision, chunk_size): ClipScores} of the port's score_clip, with
    the frame counts its frame_cb saw."""
    from pqa2_tpu_torch.pipeline.scoring import score_clip

    _, ref, dist, _ = clip
    out = {}
    for p in PRECISIONS:
        for cs in (CHUNK, WHOLE):
            seen = []
            s = score_clip(ref, dist, model=MODEL, chunk_size=cs, precision=p,
                           frame_cb=seen.append, device="cpu")
            out[p, cs] = (s, seen)
    return out


@pytest.mark.parametrize("precision", PRECISIONS)
def test_score_clip_matches_jax(precision, jax_clip_scores, port_clip_scores):
    want_f, want_vmaf = jax_clip_scores[precision]
    got = port_clip_scores[precision, CHUNK][0]
    assert got.model_name == MODEL and got.n_frames == N and got.frame_step == 1
    assert set(got.features) == set(FEATURES) == set(want_f)
    for s in range(4):
        k = f"vif_scale{s}"
        np.testing.assert_allclose(got.features[k], want_f[k], rtol=0,
                                   atol=VIF_ATOL[precision])
    np.testing.assert_allclose(got.features["adm2"], want_f["adm2"], rtol=0,
                               atol=ADM_ATOL[precision])
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(got.features[k], want_f[k],
                                   rtol=MOTION_RTOL[precision], atol=0)
    np.testing.assert_allclose(got.vmaf, want_vmaf, rtol=0, atol=VMAF_ATOL)
    assert 0 < got.vmaf.min() and got.vmaf.max() < 95


def test_chunked_equals_whole_clip(port_clip_scores):
    """Chunks 4+4+1 against one chunk, each precision: the same bits; the
    frame callback sees each chunk's core frames."""
    for p in PRECISIONS:
        chunked, seen = port_clip_scores[p, CHUNK]
        whole, seen_whole = port_clip_scores[p, WHOLE]
        assert seen == [4, 4, 1] and seen_whole == [N]
        for k in FEATURES:
            np.testing.assert_array_equal(chunked.features[k], whole.features[k], err_msg=k)
        np.testing.assert_array_equal(chunked.vmaf, whole.vmaf)
    fast = port_clip_scores["integer_fast", CHUNK][0].features
    exact = port_clip_scores["integer", CHUNK][0].features
    for k in ("adm2", "motion", "motion2"):
        np.testing.assert_array_equal(fast[k], exact[k])
    assert 0 < np.abs(fast["vif_scale0"] - exact["vif_scale0"]).max() < 1e-3


def _read(path):
    from pqa2_tpu_torch.io.video import VideoReader

    r = VideoReader(path)
    try:
        return list(r)
    finally:
        r.close()


def test_analyze_frames_equals_analyze_videos(clip, tmp_path):
    """The decoded frames through analyze_frames / score_planes give what the
    files give through analyze_videos: features, VMAF, PSNR and SSIM in
    every bit, with the luma as planes or handed over as tensors, every
    frame and every second frame, and for a 10-bit pair."""
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.pipeline.scoring import score_planes

    (ref_path, dist_path), ref, dist, _ = clip
    ref_planes, dist_planes = _read(ref_path), _read(dist_path)
    assert len(ref_planes) == N
    a = VMAFAnalyzer(device="cpu")
    a.chunk_size = CHUNK
    a.set_output_directory(str(tmp_path))
    for step in (1, 2):
        a.feature_subsample = step
        files = a.analyze_videos(ref_path, dist_path)
        want = a.last_scores
        frames = a.analyze_frames(ref_planes, dist_planes, reference_name="ref.y4m",
                                  distorted_name="dist.y4m")
        got = a.last_scores
        assert files is not None and frames is not None and set(files) == set(frames)
        for k in ("frame_count", "width", "height", "duration", "model", "vmaf_score",
                  "psnr_score", "ssim_score"):
            assert frames[k] == files[k], k
        assert os.path.exists(frames["json_path"]) and os.path.exists(frames["ssim_log"])
        tensors = score_planes(ref_planes, dist_planes, chunk_size=CHUNK, subsample=step,
                               ref_y=torch.from_numpy(ref), dist_y=torch.from_numpy(dist),
                               device="cpu")
        for s in (got, tensors):
            assert s.n_frames == -(-N // step) and s.frame_step == step
            for k in FEATURES:
                np.testing.assert_array_equal(s.features[k], want.features[k], err_msg=k)
            np.testing.assert_array_equal(s.vmaf, want.vmaf)
            for k in want.psnr:
                np.testing.assert_array_equal(s.psnr[k], want.psnr[k], err_msg=k)
            for k in want.ssim:
                np.testing.assert_array_equal(s.ssim[k], want.ssim[k], err_msg=k)
    only_psnr = score_planes(ref_planes, dist_planes, chunk_size=CHUNK, with_ssim=False,
                             device="cpu")
    assert only_psnr.ssim is None
    for k in want.psnr:
        np.testing.assert_array_equal(only_psnr.psnr[k][::2], want.psnr[k])

    # A 10-bit pair: the planes go up as codes and come onto the 8-bit
    # scale on the device, in both paths.
    from pqa2_tpu_torch.io.y4m import write_y4m

    rng = np.random.default_rng(3)
    deep = []
    for planes, name in ((ref_planes, "ref10.y4m"), (dist_planes, "dist10.y4m")):
        frames = [{p: (f[p].astype(np.uint16) << 2) | rng.integers(0, 4, f[p].shape,
                                                                     dtype=np.uint16)
                   for p in "yuv"} for f in planes]
        write_y4m(str(tmp_path / name), frames, colorspace="C420p10")
        deep.append(frames)
    a.feature_subsample = 1
    files = a.analyze_videos(str(tmp_path / "ref10.y4m"), str(tmp_path / "dist10.y4m"))
    want = a.last_scores
    frames = a.analyze_frames(deep[0], deep[1], bit_depth=10)
    got = a.last_scores
    assert files is not None and frames is not None and want.peak == got.peak == 1023.0
    for k in FEATURES:
        np.testing.assert_array_equal(got.features[k], want.features[k], err_msg=k)
    np.testing.assert_array_equal(got.vmaf, want.vmaf)
    for k in want.psnr:
        np.testing.assert_array_equal(got.psnr[k], want.psnr[k], err_msg=k)
    for k in want.ssim:
        np.testing.assert_array_equal(got.ssim[k], want.ssim[k], err_msg=k)


def test_settings_and_cli_select_the_precision(clip, tmp_path, monkeypatch, capsys):
    """The options manager's vmaf.feature_precision, the analysis thread and
    ``cli score --precision integer_fast --device cpu`` all reach the
    feature extraction with integer_fast, which runs no log2 table audit."""
    import json

    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalysisThread, VMAFAnalyzer
    from pqa2_tpu_torch.cli import main
    from pqa2_tpu_torch.pipeline import features, streaming

    seen = []
    real = streaming.extract_features_batched

    def spy(*args, **kwargs):
        seen.append(kwargs["precision"])
        return real(*args, **kwargs)

    def no_audit(device):
        raise AssertionError("integer_fast audited the log2 table")

    monkeypatch.setattr(streaming, "extract_features_batched", spy)
    monkeypatch.setattr(features, "log2_table_audit", no_audit)

    om = OptionsManager(str(tmp_path / "settings.json"), save_debounce_s=0)
    om.update_category("vmaf", {"feature_precision": "integer_fast",
                                "pool_method": "harmonic_mean", "ssim_enabled": False})
    om.update_setting("tpu", "chunk_size", CHUNK)
    (ref_path, dist_path), _, _, _ = clip
    a = VMAFAnalyzer(om, device="cpu")
    assert (a.feature_precision, a.pool_method, a.chunk_size, a.ssim_enabled,
            a.model) == ("integer_fast", "harmonic_mean", CHUNK, False, MODEL)
    a.set_output_directory(str(tmp_path / "analyzer"))
    res = a.analyze_videos(ref_path, dist_path)
    assert res is not None and res["ssim_score"] is None and seen == ["integer_fast"] * 3

    seen.clear()
    om.update_setting("vmaf", "feature_precision", "auto")
    b = VMAFAnalyzer(device="cpu")
    b.set_options_manager(om)
    assert b.feature_precision is None and b.options_manager is om
    t = VMAFAnalysisThread(ref_path, dist_path, options_manager=om, device="cpu")
    t.analyzer.feature_precision = "integer_fast"
    t.analyzer.set_output_directory(str(tmp_path / "thread"))
    done = []
    t.analysis_complete.connect(done.append)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and t.results is not None and done == [t.results]
    assert seen == ["integer_fast"] * 3

    seen.clear()
    rc = main(["score", ref_path, dist_path, "--device", "cpu", "--precision",
               "integer_fast", "--out", str(tmp_path / "cli")])
    assert rc == 0 and seen == ["integer_fast"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == N and 0 < out["vmaf"] < 95
    assert main(["probe", ref_path]) == 0
    assert json.loads(capsys.readouterr().out)["width"] == 96
    assert main(["models"]) == 0
    assert MODEL in json.loads(capsys.readouterr().out)


def test_clip_scores_pooled_matches_jax():
    """ClipScores.pooled of the port and of the JAX package, built from the
    same arrays, return the same dict for each pooling method."""
    from pqa2_tpu.pipeline.scoring import ClipScores as JaxScores
    from pqa2_tpu_torch.pipeline.scoring import POOL_METHODS, ClipScores

    rng = np.random.default_rng(5)
    feats = {k: rng.uniform(0.2, 1.0, 7).astype(np.float32) for k in FEATURES}
    vmaf = rng.uniform(20, 99, 7).astype(np.float32)
    kw = dict(model_name=MODEL, feature_names=tuple(FEATURES), features=feats, vmaf=vmaf)
    port, jax = ClipScores(**kw), JaxScores(**kw)
    assert POOL_METHODS == ("mean", "min", "max", "harmonic_mean")
    for m in POOL_METHODS:
        got = port.pooled(m)
        assert got == jax.pooled(m) and set(got) == {"vmaf", *FEATURES}
    assert port.pooled() == jax.pooled("mean")
    with pytest.raises(ValueError, match="unknown pool method"):
        port.pooled("median")
