"""The port's main path end to end against the JAX package, on the CPU.

A 9-frame 72x96 4:2:0 y4m pair scored with chunk_size=4 (chunks 4+4+1:
both motion halos and a one-frame tail) through
``pqa2_tpu.pipeline.streaming.stream_score`` once (in a child interpreter,
see :func:`jax_stream_scores`), and through the port's ``stream_score`` /
``VMAFAnalyzer`` with ``device="cpu"`` (the kernels' plain versions), with
``vmaf_v0.6.1``: the integer family. The float family, on a 10-frame clip
made the same way, is tests/test_torch_slice_float.py. The content is a
smoothed, moving base; the distorted clip adds +-8 noise to a mild blur, so
VMAF stays well below its 100 clip and the score comparison means
something.

Tolerances (each with its reason):
  vif_scale*          equal to JAX (same integer sums, same f32 combine);
                      atol 2e-6 vs the float64 oracle
  adm2                atol 2e-6 (f32 cbrt ulp)
  motion/motion2      rtol 1e-6 (JAX's f32 hi/lo SAD fold is ~6e-8)
  VMAF                atol 1e-3 (f32 exp and the ~83x inverse rescale)
  SSIM                atol 1e-6 (f32 window ratios, mean in another order)
  finite PSNR         atol 1e-4 dB (JAX sums the SSE in f32; the port's is
                      exact)

Keep this file at ten tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests, and the JAX package's files fail or hang
depending on which of them share a worker process (ROADMAP Q1.0).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from pqa2_tpu.io import write_y4m

ROOT = pathlib.Path(__file__).resolve().parent.parent

N, H, W = 9, 72, 96
CHUNK = 4

VIF_ATOL = 2e-6
ADM_ATOL = 2e-6
MOTION_RTOL = 1e-6
VMAF_ATOL = 1e-3
SSIM_ATOL = 1e-6
PSNR_ATOL = 1e-4

FEATURES = ("adm2", "motion", "motion2", "vif_scale0", "vif_scale1",
            "vif_scale2", "vif_scale3")


def _clip(n=N, seed=0, noise=8, blur=2):
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(H + 2 * n, W + 2 * n))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(np.stack([base[t: t + H, 2 * t: 2 * t + W] for t in range(n)]))
    ref = ref.astype(np.uint8)
    b = ref.astype(np.float64)
    for _ in range(blur):
        b = (b + np.roll(b, 1, -1) + np.roll(b, -1, -1)
             + np.roll(b, 1, -2) + np.roll(b, -1, -2)) / 5.0
    dist = np.clip(np.round(b) + rng.integers(-noise, noise + 1, ref.shape),
                   0, 255).astype(np.uint8)
    return ref, dist


def _frames(y):
    n = y.shape[0]
    c = y.reshape(n, H // 2, 2, W // 2, 2).mean(axis=(2, 4)).round().astype(np.uint8)
    return [{"y": y[i], "u": c[i], "v": 255 - c[i]} for i in range(n)]


def write_clip(d, n=N):
    """The n-frame y4m pair in directory ``d`` -> ((ref path, dist path),
    ref luma, dist luma, d)."""
    ref, dist = _clip(n)
    paths = (str(d / "ref.y4m"), str(d / "dist.y4m"))
    write_y4m(paths[0], _frames(ref))
    write_y4m(paths[1], _frames(dist))
    return paths, ref, dist, d


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("torch_slice"))


# The JAX reference runs, in a fresh interpreter (see jax_stream_scores).
_JAX_STREAM_SCORE = """
import pickle, sys
from pqa2_tpu.utils.stacklimit import raise_stack_limit
raise_stack_limit()
import jax
jax.config.update("jax_platforms", "cpu")
from pqa2_tpu.pipeline.streaming import stream_score
scores = {m: stream_score(sys.argv[1], sys.argv[2], model=m, chunk_size=int(sys.argv[3]))
          for m in sys.argv[5].split(",")}
with open(sys.argv[4], "wb") as f:
    pickle.dump(scores, f)
"""


def jax_stream_scores(clip, models):
    """``pqa2_tpu.pipeline.streaming.stream_score`` on the clip, once per
    model of ``models``, in one child interpreter -> {model: ClipScores}.

    A child, because a JAX streaming run leaves jit state behind that can
    make a later JAX ``stream_score`` in the same process fail ("Execution
    supplied 2 buffers but compiled program expected 4"), and the test
    files that share this process must not inherit it. Its XLA emits no
    FMA: XLA's CPU backend contracts an f32 multiply and add into one FMA
    wherever the CPU has FMA, which the JAX source does not ask for, and
    ``--xla_cpu_max_isa=AVX`` leaves it none, so the JAX pipeline rounds
    every operation on its own, as the port and its kernels do (the float
    family depends on it: tests/test_torch_slice_float.py)."""
    (ref_path, dist_path), _, _, d = clip
    out = d / "jax_scores.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env["XLA_FLAGS"] = " ".join(
        f for f in (env.get("XLA_FLAGS"), "--xla_cpu_max_isa=AVX") if f)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_STREAM_SCORE, ref_path, dist_path, str(CHUNK),
         str(out), ",".join(models)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_scores(clip):
    return jax_stream_scores(clip, ["vmaf_v0.6.1"])["vmaf_v0.6.1"]


@pytest.fixture(scope="module")
def port_scores(clip):
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    return stream_score(*clip[0], chunk_size=CHUNK, device="cpu")


def test_features_match_jax(jax_scores, port_scores):
    for k in FEATURES:
        assert port_scores.features[k].shape == (N,)
    for s in range(4):
        k = f"vif_scale{s}"
        np.testing.assert_allclose(port_scores.features[k], jax_scores.features[k],
                                   rtol=0, atol=VIF_ATOL)
        np.testing.assert_array_equal(port_scores.features[k], jax_scores.features[k])
    np.testing.assert_allclose(port_scores.features["adm2"], jax_scores.features["adm2"],
                               rtol=0, atol=ADM_ATOL)
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(port_scores.features[k], jax_scores.features[k],
                                   rtol=MOTION_RTOL, atol=0)
    assert port_scores.features["motion"][0] == 0.0
    assert np.all(port_scores.features["motion"][1:] > 0)


def test_vmaf_matches_jax_and_stays_below_the_clip(jax_scores, port_scores):
    np.testing.assert_allclose(port_scores.vmaf, jax_scores.vmaf, rtol=0, atol=VMAF_ATOL)
    assert port_scores.vmaf.max() < 95.0
    assert port_scores.model_name == jax_scores.model_name == "vmaf_v0.6.1"
    assert port_scores.peak == jax_scores.peak == 255.0


def test_psnr_matches_jax(jax_scores, port_scores):
    assert set(port_scores.psnr) == set(jax_scores.psnr)
    for k, v in jax_scores.psnr.items():
        got = port_scores.psnr[k]
        assert np.all(np.isfinite(got))
        if k.startswith("psnr"):
            np.testing.assert_allclose(got, v, rtol=0, atol=PSNR_ATOL)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-5)


def test_ssim_matches_jax(jax_scores, port_scores):
    assert set(port_scores.ssim) == set(jax_scores.ssim)
    for k in ("ssim_y", "ssim_u", "ssim_v", "ssim_all"):
        np.testing.assert_allclose(port_scores.ssim[k], jax_scores.ssim[k],
                                   rtol=0, atol=SSIM_ATOL)
    assert port_scores.ssim["ssim_all"].max() < 0.99


def test_chunk_boundary_frames_match_oracles(clip, port_scores):
    """Frames 0, 4 (the first chunk boundary) and 8 (alone in the one-frame
    tail chunk) against the numpy oracles; motion of frame 4 needs frames
    3..5 across the boundary, motion of frame 8 its halo frame 7 and no next
    frame."""
    from pqa2_tpu.golden.adm_int import adm_features_int
    from pqa2_tpu.golden.motion_int import motion_features_int
    from pqa2_tpu.golden.vif_int import vif_features_int

    _, ref, dist, _ = clip
    f = port_scores.features
    tail = N - 1
    assert tail == 2 * CHUNK
    for i in (0, CHUNK, tail):
        vif = [f[f"vif_scale{s}"][i] for s in range(4)]
        np.testing.assert_allclose(vif, vif_features_int(ref[i], dist[i]), rtol=0,
                                   atol=VIF_ATOL)
        np.testing.assert_allclose(f["adm2"][i], adm_features_int(ref[i], dist[i])[0],
                                   rtol=0, atol=ADM_ATOL)
    for i, frames in ((CHUNK, ref[CHUNK - 1: CHUNK + 2]), (tail, ref[tail - 1:])):
        motion, motion2 = motion_features_int(frames)
        np.testing.assert_allclose(f["motion"][i], motion[1], rtol=MOTION_RTOL)
        np.testing.assert_allclose(f["motion2"][i], motion2[1], rtol=MOTION_RTOL)


def test_chunked_equals_whole_clip(clip, port_scores):
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    whole = stream_score(*clip[0], chunk_size=16, device="cpu")
    for k in FEATURES:
        np.testing.assert_array_equal(port_scores.features[k], whole.features[k])
    np.testing.assert_array_equal(port_scores.vmaf, whole.vmaf)
    for k in port_scores.psnr:
        np.testing.assert_array_equal(port_scores.psnr[k], whole.psnr[k])
    for k in port_scores.ssim:
        np.testing.assert_array_equal(port_scores.ssim[k], whole.ssim[k])


def test_psnr_only_and_ssim_only_branches(clip, port_scores):
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    p = stream_score(*clip[0], chunk_size=CHUNK, with_ssim=False, device="cpu")
    s = stream_score(*clip[0], chunk_size=CHUNK, with_psnr=False, device="cpu")
    assert p.ssim is None and s.psnr is None
    for k in port_scores.psnr:
        np.testing.assert_array_equal(p.psnr[k], port_scores.psnr[k])
    for k in port_scores.ssim:
        np.testing.assert_array_equal(s.ssim[k], port_scores.ssim[k])


def _port_clip_scores(jax_scores):
    import dataclasses

    from pqa2_tpu_torch.pipeline.scoring import ClipScores

    return ClipScores(**{f.name: getattr(jax_scores, f.name)
                         for f in dataclasses.fields(ClipScores)})


def test_writers_are_byte_identical(jax_scores, tmp_path):
    """The same ClipScores gives the same bytes from both packages' writers,
    except the JSON "version" string."""
    from pqa2_tpu.app import vmaf_analyzer as jax_app
    from pqa2_tpu.pipeline.json_out import write_vmaf_json as jax_json
    from pqa2_tpu_torch.app import vmaf_analyzer as port_app
    from pqa2_tpu_torch.pipeline.json_out import write_vmaf_json as port_json

    port = _port_clip_scores(jax_scores)
    jax_json(jax_scores, str(tmp_path / "j.json"), fps=30.0)
    port_json(port, str(tmp_path / "p.json"), fps=30.0)
    j = (tmp_path / "j.json").read_text().splitlines()
    p = (tmp_path / "p.json").read_text().splitlines()
    assert len(j) == len(p) > 100
    diff = [(a, b) for a, b in zip(j, p) if a != b]
    assert len(diff) == 1 and '"version"' in diff[0][0] and "pqa2_tpu_torch" in diff[0][1]
    for name in ("write_psnr_log", "write_ssim_log"):
        getattr(jax_app, name)(jax_scores, str(tmp_path / f"j_{name}.txt"))
        getattr(port_app, name)(port, str(tmp_path / f"p_{name}.txt"))
        assert ((tmp_path / f"j_{name}.txt").read_bytes()
                == (tmp_path / f"p_{name}.txt").read_bytes())


def test_analyzer_matches_jax_finalize(clip, jax_scores, tmp_path):
    """The port's VMAFAnalyzer against the JAX analyzer's _finalize on the
    JAX scores: the same results-dict keys, geometry and artifacts."""
    from pqa2_tpu.app.vmaf_analyzer import VMAFAnalyzer as JaxAnalyzer
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    (ref_path, dist_path), _, _, _ = clip
    port = VMAFAnalyzer(device="cpu")
    port.chunk_size = CHUNK
    port.set_output_directory(str(tmp_path / "port"))
    done = []
    port.analysis_complete.connect(done.append)
    res = port.analyze_videos(ref_path, dist_path)
    assert res is not None and done == [res]
    jax = JaxAnalyzer()
    jax.set_output_directory(str(tmp_path / "jax"))
    want = jax._finalize(jax_scores, fps=30.0, model="vmaf_v0.6.1",
                         reference_path=ref_path, distorted_path=dist_path,
                         width=W, height=H)
    assert set(res) == set(want)
    for k in ("width", "height", "frame_count", "duration", "model",
              "reference_video", "distorted_video"):
        assert res[k] == want[k], k
    assert abs(res["vmaf_score"] - want["vmaf_score"]) <= VMAF_ATOL
    assert abs(res["psnr_score"] - want["psnr_score"]) <= PSNR_ATOL
    assert abs(res["ssim_score"] - want["ssim_score"]) <= SSIM_ATOL
    for k in ("json_path", "psnr_log", "ssim_log"):
        assert os.path.exists(res[k]) and os.path.exists(want[k])
        with open(res[k]) as a, open(want[k]) as b:
            assert len(a.read().splitlines()) == len(b.read().splitlines())
    assert len(res["raw_results"]["frames"]) == N
    assert port.last_scores.n_frames == N


def test_cli_score_on_cpu(clip, tmp_path, capsys):
    import json

    from pqa2_tpu_torch.cli import main

    (ref_path, dist_path), _, _, _ = clip
    rc = main(["score", ref_path, dist_path, "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == N and 0 < out["vmaf"] < 95
    assert os.path.exists(out["json_path"])
