"""The port's package-level API, its PSNR oracle, its logging setup and the
``tpu.profile_dir`` trace, on the CPU.

  * every name the JAX package exports at top level and from ``models``,
    ``io``, ``utils``, ``golden``, ``pipeline`` and ``ops`` resolves in the
    port, or ROADMAP.md lists it (with the reason it has no counterpart);
  * ``import pqa2_tpu_torch`` alone imports no ``pipeline``/``app`` module
    and not torch (the top-level names load on first use);
  * ``golden.psnr``'s ``psnr_frame``/``psnr_pooled`` give the JAX oracle's
    values, and the port's ``plane_metrics`` PSNR (both of its paths) gives
    the oracle's per-frame MSE exactly and its dB within 1e-12 relative
    (float64 logs of the same exact MSE, vectorised);
  * ``VMAFAnalyzer.analyze_videos`` with ``tpu.profile_dir`` set writes one
    torch.profiler trace (``*.pt.trace.json``) holding the ``vmaf_score``
    range, scores as without it in every bit, and writes nothing without it;
  * ``setup_logging`` writes ``vmaf_app.log`` under the port's own directory
    (``~/.pqa2_tpu_torch/logs``, or ``$APPDATA/logs``) with the JAX
    package's handlers and format.

No JAX computation runs here: the JAX package is only imported for its
names and its numpy oracle. Keep this file below eight tests
(ROADMAP Q1.0).
"""

import glob
import importlib
import json
import logging
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: The top-level names of pqa2_tpu/__init__.py's lazy ``__getattr__``.
TOP_LEVEL = ("score_clip", "score_planes", "ClipScores", "stream_score", "VMAFAnalyzer",
             "BookendAligner", "ReferenceAnalyzer", "get_model")
SUBPACKAGES = ("models", "io", "utils", "golden", "pipeline", "ops")


def _exports(module):
    """A package's exported names: its ``__all__``, else its public
    attributes that are not submodules."""
    names = getattr(module, "__all__", None)
    if names is None:
        names = [k for k, v in vars(module).items()
                 if not k.startswith("_") and not isinstance(v, types.ModuleType)
                 and k not in ("annotations",)]
    return sorted(names)


def test_every_jax_export_resolves_or_is_listed():
    import pqa2_tpu
    import pqa2_tpu_torch

    roadmap = (ROOT / "ROADMAP.md").read_text()
    missing = []
    for name in TOP_LEVEL:
        assert getattr(pqa2_tpu, name) is not None
        obj = getattr(pqa2_tpu_torch, name)
        assert obj.__module__.startswith("pqa2_tpu_torch."), (name, obj.__module__)
    counted = 0
    for sub in SUBPACKAGES:
        jax_m = importlib.import_module(f"pqa2_tpu.{sub}")
        port_m = importlib.import_module(f"pqa2_tpu_torch.{sub}")
        for name in _exports(jax_m):
            counted += 1
            if not hasattr(port_m, name):
                missing.append(f"{sub}.{name}")
                continue
            obj = getattr(port_m, name)
            owner = getattr(obj, "__module__", "") or ""
            assert owner.startswith("pqa2_tpu_torch."), (sub, name, owner)
    assert counted >= 40
    assert missing == ["ops.ssim_plane_batched"], missing
    for name in missing:
        assert f"`{name}`" in roadmap, f"{name} is not listed in ROADMAP.md"


def test_bare_import_is_light():
    code = ("import sys\n"
            "import pqa2_tpu_torch\n"
            "heavy = sorted(k for k in sys.modules if k.startswith(\n"
            "    ('pqa2_tpu_torch.pipeline', 'pqa2_tpu_torch.app', 'torch')))\n"
            "assert not heavy, heavy\n"
            "assert pqa2_tpu_torch.score_clip.__module__ == 'pqa2_tpu_torch.pipeline.scoring'\n"
            "assert 'pqa2_tpu_torch.pipeline.scoring' in sys.modules\n"
            "assert 'pqa2_tpu_torch.app' not in sys.modules\n"
            "from pqa2_tpu_torch.pipeline import write_vmaf_json\n"
            "assert 'pqa2_tpu_torch.pipeline.json_out' in sys.modules\n"
            "try:\n"
            "    pqa2_tpu_torch.no_such_name\n"
            "except AttributeError as e:\n"
            "    assert 'no_such_name' in str(e)\n"
            "else:\n"
            "    raise AssertionError('no AttributeError')\n"
            "print('light')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "light" in out.stdout


def _planes(rng, n, h, w):
    def plane(hh, ww):
        return rng.integers(0, 256, size=(n, hh, ww)).astype(np.uint8)

    ref = {"y": plane(h, w), "u": plane(h // 2, w // 2), "v": plane(h // 2, w // 2)}
    dist = {p: np.clip(v.astype(np.int64) + rng.integers(-6, 7, v.shape), 0, 255)
            .astype(np.uint8) for p, v in ref.items()}
    dist["v"][1] = ref["v"][1]  # one plane of one frame identical: mse 0
    same = {p: v[2:3].copy() for p, v in ref.items()}
    return ref, dist, same


def test_psnr_oracle_and_plane_metrics():
    from pqa2_tpu.golden import psnr as jax_psnr
    from pqa2_tpu_torch.golden import psnr
    from pqa2_tpu_torch.golden import psnr_frame
    from pqa2_tpu_torch.pipeline.scoring import plane_metrics

    assert psnr_frame is psnr.psnr_frame
    rng = np.random.default_rng(31)
    n, h, w = 4, 36, 52
    ref, dist, same = _planes(rng, n, h, w)
    frames = [({p: ref[p][i] for p in "yuv"}, {p: dist[p][i] for p in "yuv"})
              for i in range(n)]
    frames.append(({p: same[p][0] for p in "yuv"}, {p: same[p][0] for p in "yuv"}))
    oracle = [psnr.psnr_frame(r, d) for r, d in frames]
    assert oracle == [jax_psnr.psnr_frame(r, d) for r, d in frames]
    assert oracle[-1]["psnr_avg"] == float("inf") and oracle[1]["psnr_v"] == float("inf")
    for subset in (oracle, oracle[:-1], oracle[-1:]):
        assert psnr.psnr_pooled(subset) == jax_psnr.psnr_pooled(subset)
    deep = [psnr.psnr_frame({p: r[p].astype(np.uint16) << 2 for p in "yuv"},
                            {p: d[p].astype(np.uint16) << 2 for p in "yuv"}, max_value=1023)
            for r, d in frames[:2]]
    assert deep == [jax_psnr.psnr_frame({p: r[p].astype(np.uint16) << 2 for p in "yuv"},
                                        {p: d[p].astype(np.uint16) << 2 for p in "yuv"},
                                        max_value=1023) for r, d in frames[:2]]

    planes = {p: (torch.from_numpy(np.concatenate([ref[p], same[p]])).float(),
                  torch.from_numpy(np.concatenate([dist[p], same[p]])).float())
              for p in "yuv"}
    for with_ssim in (True, False):
        got, _ = plane_metrics(planes, 8, with_psnr=True, with_ssim=with_ssim)
        for key in ("y", "u", "v", "avg"):
            want_mse = np.array([o[f"mse_{key}"] for o in oracle])
            want_db = np.array([o[f"psnr_{key}"] for o in oracle])
            np.testing.assert_array_equal(got[f"mse_{key}"], want_mse, err_msg=key)
            np.testing.assert_allclose(got[f"psnr_{key}"], want_db, rtol=1e-12, err_msg=key)


def _write_pair(d):
    from pqa2_tpu_torch.io.y4m import write_y4m

    rng = np.random.default_rng(41)
    base = rng.uniform(16, 235, size=(3, 48, 64))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -2)) / 3.0
    ref = np.round(base).astype(np.uint8)
    dist = np.clip(ref.astype(np.int64) + rng.integers(-9, 10, ref.shape), 0, 255)
    c = np.full((24, 32), 128, np.uint8)
    rp, dp = os.path.join(d, "ref.y4m"), os.path.join(d, "dist.y4m")
    write_y4m(rp, [{"y": y, "u": c, "v": c} for y in ref])
    write_y4m(dp, [{"y": y.astype(np.uint8), "u": c, "v": c} for y in dist])
    return rp, dp


def test_profile_dir_writes_a_trace(tmp_path):
    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    rp, dp = _write_pair(str(tmp_path))
    trace_dir = tmp_path / "trace"
    runs = {}
    for name, profile_dir in (("traced", str(trace_dir)), ("plain", "")):
        om = OptionsManager(str(tmp_path / f"{name}.json"), save_debounce_s=0)
        om.update_setting("tpu", "profile_dir", profile_dir)
        om.update_setting("tpu", "chunk_size", 2)
        a = VMAFAnalyzer(om, device="cpu")
        a.set_output_directory(str(tmp_path / f"out_{name}"))
        assert a.analyze_videos(rp, dp) is not None
        runs[name] = a.last_scores
    traces = glob.glob(str(trace_dir / "*"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json"), traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "vmaf_score" for e in events)
    # Only the traced run wrote a trace: nothing else appeared anywhere.
    everything = sorted(p.name for p in tmp_path.rglob("*.pt.trace.json"))
    assert everything == [os.path.basename(traces[0])]
    a, b = runs["traced"], runs["plain"]
    np.testing.assert_array_equal(a.vmaf, b.vmaf)
    for k in b.features:
        np.testing.assert_array_equal(a.features[k], b.features[k], err_msg=k)
    for k in b.psnr:
        np.testing.assert_array_equal(a.psnr[k], b.psnr[k], err_msg=k)


def test_setup_logging_under_the_ports_directory(tmp_path, monkeypatch):
    from pqa2_tpu.utils import logs as jax_logs
    from pqa2_tpu_torch.utils import logs, setup_logging

    assert setup_logging is logs.setup_logging
    monkeypatch.delenv("APPDATA", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert logs.default_log_dir() == str(tmp_path / "home" / ".pqa2_tpu_torch" / "logs")
    assert jax_logs.default_log_dir() == str(tmp_path / "home" / ".pqa2_tpu" / "logs")
    monkeypatch.setenv("APPDATA", str(tmp_path / "appdata"))
    assert logs.default_log_dir() == jax_logs.default_log_dir() == str(tmp_path / "appdata" / "logs")
    monkeypatch.delenv("APPDATA")

    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        shapes = []
        for m in (jax_logs, logs):
            logger = m.setup_logging(logging.DEBUG)
            shapes.append([(type(h).__name__, h.formatter._fmt,
                            os.path.basename(getattr(h, "baseFilename", "")))
                           for h in root.handlers])
            logger.info("hello from %s", m.__name__)
            for h in root.handlers:
                h.flush()
        assert logger.name == "pqa2_tpu_torch" and root.level == logging.DEBUG
        assert shapes[0] == shapes[1]
        assert [s[2] for s in shapes[1]] == ["", "vmaf_app.log"]
        text = (tmp_path / "home" / ".pqa2_tpu_torch" / "logs" / "vmaf_app.log").read_text()
        assert " - pqa2_tpu_torch - INFO - hello from pqa2_tpu_torch.utils.logs" in text
        assert "pqa2_tpu.utils.logs" not in text.replace("pqa2_tpu_torch.utils.logs", "")
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
