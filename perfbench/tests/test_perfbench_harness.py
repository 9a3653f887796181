"""CPU tests of the benchmark's harness: discovery by name, the stages'
work counts, the result line, the module check, and a whole run at a tiny
size with the kernels' plain versions.

Run from the repository's root: ``python -m pytest perfbench/tests -q``.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench import harness, peaks

ROOT = harness.ROOT


def tiny(cell: str, entry: str = None, **cfg_over):
    """A cell's benchmark, cell, configuration and traffic at 72x96, six
    frames in chunks of four (one chunk boundary); ``entry`` overrides the
    traffic's way in (``files`` scores y4m files through analyze_videos)."""
    bench, c, cfg, traffic = harness.load_cell(cell)
    cfg = dict(cfg, width=96, height=72, chunk_size=4, **cfg_over)
    traffic = dict(traffic, frames=6, check=dict(traffic["check"], workers=1))
    if entry is not None:
        traffic["entry"] = entry
    return bench, c, cfg, traffic


def run_tiny(cell: str, seed: int = 2**31 + 5, trace: bool = False, entry: str = None,
             **kw):
    bench, c, cfg, traffic = tiny(cell, entry)
    run = harness.Run(bench, c, cfg, traffic, seed=seed, seconds=0.5, trace=trace,
                      device="cpu", **kw)
    return run, run.execute()


def test_discovery_from_new_files(tmp_path, monkeypatch):
    """A configuration, a cell's traffic, a metric and a stage are found
    from new files alone."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    (root / "perfbench/configs/new_cfg.json").write_text(json.dumps(dict(cfg, width=1280)))
    tr = json.load(open(root / "perfbench/workloads/hd8_frames_mem.json"))
    (root / "perfbench/workloads/new_mix.json").write_text(json.dumps(dict(tr, frames=7)))
    (root / "perfbench/metrics/new_metric.x.py").write_text(
        "def read(ctx):\n    return ctx.frames * 2.0\n")
    (root / "perfbench/stages/new_stage.py").write_text(
        "PATTERNS = [r'\\bnew_kernel\\b']\n\ndef work(cfg):\n    return 1, 2\n")
    bench["configs"].append(dict(bench["configs"][0], name="new_cfg",
                                 file="perfbench/configs/new_cfg.json"))
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg", "traffic": "new_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "fps"})
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "perfbench"))
    _, cell, cfg2, traffic = harness.load_cell("new_cell", bench)
    assert cfg2["width"] == 1280 and traffic["frames"] == 7
    assert "new_stage" in harness.load_stages()
    names = [m["name"] for m in harness.cell_metrics(bench, "new_cell", "per_layer")]
    assert "new_metric.x" in names and "device_idle_pct" not in names
    mod = harness.load_module(str(root / "perfbench/metrics/new_metric.x.py"), "m")
    assert mod.read(types.SimpleNamespace(frames=3)) == 6.0


@pytest.mark.parametrize("h,w,depth,vif_ops,adm_ops,ssim_ops", [
    (1080, 1920, 8, 1044284400, 207945120, 40435200),
    (2160, 3840, 10, 4177137600, 831708000, 161740800),
])
def test_stage_work_hand_sums(h, w, depth, vif_ops, adm_ops, ssim_ops):
    """The stages' (bytes, operations) of one frame against sums by hand."""
    st = harness.load_stages()
    cfg = {"height": h, "width": w, "bit_depth": depth}
    b = 1 if depth == 8 else 4
    assert st["vif_int"].work(cfg) == (2 * h * w * b + 232, vif_ops)
    assert st["adm_int"].work(cfg) == (2 * h * w * b + 192, adm_ops)
    px = h * w + 2 * (h // 2) * (w // 2)
    assert st["ssim_sse"].work(cfg) == (8 * px + 48, ssim_ops)
    # VIF is bound by its operations, SSIM by its bytes, ADM by its
    # operations on 8-bit input and by its bytes on 4-byte samples.
    for name, by_ops in (("vif_int", True), ("adm_int", depth == 8), ("ssim_sse", False)):
        nb, ops = st[name].work(cfg)
        want = ops / peaks.OPS_PER_S if by_ops else nb / peaks.BYTES_PER_S
        assert peaks.least_seconds(nb, ops) == want


def _vif_hand(h, w):
    taps = (17, 9, 5, 3)
    total = h * w * (20 * 17 + 43) + h * w * 23
    for f in taps[1:]:
        h, w = (h + 1) // 2, (w + 1) // 2
        total += h * w * (20 * f + 43) + 12 * f * h * w
    return total


def test_vif_hand_sum_matches_table():
    assert _vif_hand(1080, 1920) == 1044284400
    assert _vif_hand(2160, 3840) == 4177137600


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("pqa2_tpu_torch", "pqa2_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pqa2_tpu.x", types.ModuleType("pqa2_tpu.x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax.numpy", "pqa2_tpu.x"]


def test_last_line_shape(capsys):
    """A tiny CPU run's printed result: the contract's keys, the checks
    last, each number beside its limit on standard error too."""
    run, out = run_tiny("hd8_frames_mem")
    assert harness.emit(out, run) == 0
    cap = capsys.readouterr()
    last = json.loads(cap.out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] >= 1
    assert set(last["metrics"]) == {"fps", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    err = cap.err.strip().splitlines()
    assert err[-1].startswith("check json_mismatches:") and "limit" in err[-1]


def test_trace_run_reports_per_layer_metrics():
    """A traced run reports the per-layer metrics it can read (none of the
    kernels' shares on the CPU: nothing ran on a device) and a breakdown."""
    _, out = run_tiny("hd8_frames_mem", trace=True, entry="files")
    assert out["correct"] is True
    assert "kernel_roofline_pct" not in out["metrics"]
    assert out["metrics"]["launches_per_frame"]["value"] == 0.0
    assert out["device"]["window_s"] > 0 and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("entry", ["frames", "files"])
def test_uhd10_tiny_run_correct(entry):
    _, out = run_tiny("uhd10_frames_mem", entry=entry)
    assert out["correct"] is True and set(out["metrics"]) == {"fps", "setup_s"}


def test_cli_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hd8_frames_mem",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_benchmark_files_alone_fail(tmp_path):
    """In a directory with BENCHMARK.json and perfbench/ alone the run
    fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hd8_frames_mem",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and "{" not in p.stdout


def test_on_the_card_short_run():
    """One short run of the first cell through the CLI (the card only)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hd8_frames_mem",
                        "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
