"""The port's capture side (``app/capture.py``, the ``capture`` subcommand)
and results store (``app/results_store.py``), on the CPU, against the JAX
package's, in process (both are numpy and files; nothing here runs JAX).

  * ``FilePlaybackBackend`` writes the JAX backend's bytes for the same
    source (its noise comes from a fixed ``default_rng(0)``), with the same
    progress and frame-count callbacks;
  * ``CaptureManager``'s duration policy gives the JAX manager's seconds,
    and a capture (and a failing one) emits the JAX manager's signals in
    the same order with the same values;
  * the ``capture`` subcommand prints the JAX CLI's JSON keys and its file
    has the JAX file's bytes;
  * ``ResultsStore`` round-trips a port ``analyze_videos(device="cpu")``
    result (tests/test_cli_store.py's round trip), and the JAX store reads
    the port's directories the same way;
  * a simulated capture aligns and scores through
    ``run_combined_workflow(device="cpu")``, whose alignment equals
    ``BookendAligner(device="cpu")``'s on the same files.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

from pqa2_tpu.app import capture as jax_capture
from pqa2_tpu_torch.app import capture
from pqa2_tpu_torch.io.y4m import write_y4m

N, H, W = 6, 48, 64
SIGNALS = ("status_update", "progress_update", "state_changed", "capture_started",
           "capture_finished", "frame_available", "frame_count_updated")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A 6-frame smooth 48x64 clip with moving content (the playback
    source) and a noisier copy of it (a distorted clip)."""
    d = tmp_path_factory.mktemp("torch_capture")
    rng = np.random.default_rng(40)
    base = rng.uniform(16, 235, size=(N, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base).astype(np.uint8)
    dist = np.clip(ref.astype(np.int16) + rng.integers(-5, 6, ref.shape), 0, 255)

    def frames(ys):
        return [{"y": y, "u": np.full((H // 2, W // 2), 128, np.uint8),
                 "v": (y[::2, ::2] // 2 + 64).astype(np.uint8)} for y in ys]

    rp, dp = str(d / "ref.y4m"), str(d / "dist.y4m")
    write_y4m(rp, frames(ref))
    write_y4m(dp, frames(dist.astype(np.uint8)))
    return d, rp, dp


def _strip_ts(path):
    return re.sub(r"_\d{8}_\d{6}\.y4m$", "_TS.y4m", os.path.basename(path))


def test_file_playback_bytes_equal_jax(source, tmp_path):
    _, rp, _ = source
    for noise in (2.0, 0.0):
        out = {}
        for name, mod in (("jax", jax_capture), ("port", capture)):
            backend = mod.FilePlaybackBackend(rp, noise_sigma=noise)
            progress, counts = [], []
            backend.frame_cb = counts.append
            path = str(tmp_path / f"{name}_{noise}.y4m")
            assert backend.capture("FilePlayback", 2.0, path, {"bookend_duration": 0.2},
                                   progress.append)
            out[name] = (open(path, "rb").read(), progress, counts)
        assert out["port"] == out["jax"]
        assert len(out["port"][1]) == 6 and out["port"][2][-1] == 60
    with pytest.raises(FileNotFoundError):
        capture.FilePlaybackBackend(str(tmp_path / "none.y4m")).capture(
            "x", 1.0, str(tmp_path / "x.y4m"), {}, lambda p: None)


def _manager(mod, om_mod, tmp_path, name, settings):
    om = om_mod.OptionsManager(str(tmp_path / f"{name}.json"), save_debounce_s=0)
    for (cat, key), v in settings.items():
        om.update_setting(cat, key, v)
    cm = mod.CaptureManager(options_manager=om,
                            backend=mod.FilePlaybackBackend(noise_sigma=1.5))
    cm.set_output_directory(str(tmp_path / name))
    cm.set_test_name("capture")
    events = []
    for sig in SIGNALS:
        getattr(cm, sig).connect(lambda *a, sig=sig: events.append((sig, a)))
    return cm, events


def _normalised(events):
    """Enum states by name, capture paths without their timestamp."""
    out = []
    for sig, args in events:
        args = tuple(a.name if hasattr(a, "name") and hasattr(a, "value") else
                     _strip_ts(a) if isinstance(a, str) and a.endswith(".y4m") else a
                     for a in args)
        out.append((sig, args))
    return out


def test_capture_manager_policy_and_signals_equal_jax(source, tmp_path):
    from pqa2_tpu.app import options_manager as jax_om
    from pqa2_tpu_torch.app import options_manager as port_om

    _, rp, _ = source
    grids = [{}, {("bookend", "min_capture_time"): 1},
             {("bookend", "min_loops"): 1, ("bookend", "max_loops"): 2,
              ("bookend", "bookend_duration"): 0.5, ("bookend", "max_capture_time"): 12}]
    for g, settings in enumerate(grids):
        for dur in (0.0, 0.1, N / 30.0, 2.0, 7.5, 40.0):
            want, _ = _manager(jax_capture, jax_om, tmp_path, f"j{g}", settings)
            got, _ = _manager(capture, port_om, tmp_path, f"p{g}", settings)
            for cm in (want, got):
                cm.set_reference_video({"path": rp, "duration": dur, "frame_rate": 30.0})
            assert got._calculate_capture_duration() == want._calculate_capture_duration()
        assert capture.CaptureManager()._calculate_capture_duration() == \
            jax_capture.CaptureManager()._calculate_capture_duration()

    settings = {("bookend", "min_capture_time"): 1, ("bookend", "frame_offset"): 0}
    runs = {}
    for name, mod, om_mod in (("jax", jax_capture, jax_om), ("port", capture, port_om)):
        for ref in (rp, str(tmp_path / "missing.y4m")):
            cm, events = _manager(mod, om_mod, tmp_path, f"{name}_{len(runs)}", settings)
            cm.set_reference_video({"path": ref, "duration": N / 30.0, "frame_rate": 30.0})
            assert cm.start_bookend_capture("Fake Device")
            assert cm.wait(timeout=60)
            runs[(name, ref == rp)] = (_normalised(events), cm.state.name,
                                       cm.current_output_path)
    for ok in (True, False):
        got, want = runs[("port", ok)], runs[("jax", ok)]
        assert got[:2] == want[:2]
        assert got[1] == ("COMPLETED" if ok else "ERROR")
    assert open(runs[("port", True)][2], "rb").read() == open(runs[("jax", True)][2], "rb").read()
    finished = [a for s, a in runs[("port", False)][0] if s == "capture_finished"]
    assert finished == [(False, f"playback source not found: {str(tmp_path / 'missing.y4m')!r}")]


def test_capture_subcommand_matches_jax(source, tmp_path):
    from pqa2_tpu import cli as jax_cli
    from pqa2_tpu_torch import cli

    _, rp, _ = source
    printed = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["capture", rp, "--out", str(tmp_path / name), "--test-name", "cap",
                         "--noise", "3"]) == 0
        printed[name] = json.loads(buf.getvalue())
    assert set(printed["port"]) == set(printed["jax"]) == {"capture_path"}
    got, want = printed["port"]["capture_path"], printed["jax"]["capture_path"]
    assert os.path.dirname(got) == str(tmp_path / "port") and _strip_ts(got) == _strip_ts(want)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_results_store_roundtrip(source, tmp_path):
    from pqa2_tpu.app.results_store import ResultsStore as JaxStore
    from pqa2_tpu_torch.app.results_store import ResultsStore, write_compact_metadata
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    _, rp, dp = source
    base = str(tmp_path / "results")
    store = ResultsStore(base)
    analyzer = VMAFAnalyzer(device="cpu")
    analyzer.chunk_size = 4
    for name in ("testA", "testB"):
        test_dir = os.path.join(base, f"{name}_20260101_000000")
        os.makedirs(test_dir, exist_ok=True)
        analyzer.set_output_directory(test_dir)
        analyzer.set_test_name(name)
        results = analyzer.analyze_videos(rp, dp)
        assert results is not None
        write_compact_metadata(results, test_dir)

    tests = store.list_tests()
    assert len(tests) == 2 and all("vmaf_score" in t for t in tests)
    assert tests == JaxStore(base).list_tests()
    assert tests[0]["frame_count"] == N and len(tests[0]["frames"]) == N
    full = store.load_full(tests[0]["test_dir"])
    assert "frames" in full and "pooled_metrics" in full
    assert full["pooled_metrics"]["vmaf"]["mean"] == pytest.approx(tests[0]["vmaf_score"],
                                                                   abs=1e-6)
    csv_path = store.export_combined_csv(str(tmp_path / "combined.csv"))
    JaxStore(base).export_combined_csv(str(tmp_path / "jax.csv"))
    text = open(csv_path).read()
    assert "testA" in text and "testB" in text and text == open(tmp_path / "jax.csv").read()
    assert store.delete(tests[0]["test_dir"])
    assert len(store.list_tests()) == 1
    assert not store.delete(str(tmp_path))  # refuses outside base


def test_capture_then_workflow_on_cpu(source, tmp_path):
    from pqa2_tpu_torch.app import (
        BookendAligner,
        CaptureManager,
        CaptureState,
        OptionsManager,
        VMAFAnalyzer,
        run_combined_workflow,
    )

    _, rp, _ = source
    om = OptionsManager(settings_file=str(tmp_path / "s.json"), save_debounce_s=0)
    om.update_setting("bookend", "frame_offset", 0)
    om.update_setting("bookend", "min_capture_time", 1)
    cm = CaptureManager(options_manager=om, backend=capture.FilePlaybackBackend(noise_sigma=1.5))
    cm.set_output_directory(str(tmp_path / "cap"))
    cm.set_reference_video({"path": rp, "duration": N / 30.0, "frame_rate": 30.0})
    finished = []
    cm.capture_finished.connect(lambda ok, p: finished.append((ok, p)))
    assert cm.start_bookend_capture("Fake Device") and cm.wait(timeout=60)
    assert finished[0][0] and cm.state == CaptureState.COMPLETED
    cap = finished[0][1]

    analyzer = VMAFAnalyzer(device="cpu")
    analyzer.chunk_size = 4
    analyzer.set_output_directory(str(tmp_path / "out"))
    out = run_combined_workflow(rp, cap, options_manager=om, analyzer=analyzer, device="cpu")
    assert out is not None
    plain = BookendAligner(om, device="cpu").align_bookend_videos(rp, cap)
    paths = ("aligned_reference", "aligned_captured")
    assert {k: v for k, v in out["alignment"].items() if k not in paths} == \
        {k: v for k, v in plain.items() if k not in paths}
    assert out["alignment"]["confidence"] > 0.5 and not out["alignment"]["is_fallback"]
    res = out["analysis"]
    c0, c1 = out["alignment"]["cap_range"]
    assert res["frame_count"] == c1 - c0 >= 3 and np.all(np.isfinite(analyzer.last_scores.vmaf))
    assert res["vmaf_score"] > 50  # mild noise only
