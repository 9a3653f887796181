"""CPU tests of the readers of the program's spans and counters:
``htod_mb_per_frame`` and ``syncs_per_frame`` (the program's span records)
and ``upload_idle_pct`` and ``writer_idle_pct`` (the trace's idle gaps by
program span), on made-up contexts, on a program without span records, and
in a tiny traced run.

Run from the repository's root: ``python -m pytest perfbench/tests -q``.
"""

import os
import sys
import types

import pytest

from perfbench import harness
from perfbench.trace import TraceSummary

READERS = ("htod_mb_per_frame", "syncs_per_frame", "upload_idle_pct", "writer_idle_pct")


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"),
                               "metric_" + name).read


def test_declared_for_both_cells():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cells = [c["name"] for c in bench["workloads"]]
    for cell in cells:
        names = [m["name"] for m in harness.cell_metrics(bench, cell, "per_layer")]
        assert set(READERS) <= set(names), cell


def test_counter_readers_sum_the_records(monkeypatch):
    """A 180-frame 1080p request's counts as the program records them: four
    chroma uploads a frame of 960x540 bytes (luma already on the card), 8
    syncs in each of six chunks and one for the SVR."""
    from pqa2_tpu_torch.utils import profiling

    recs = [profiling.SpanRecord("app.request", counts={"frames": 180})]
    recs += [profiling.SpanRecord("scoring.upload.copy", counts={"htod_bytes": 0})] * 12
    recs += [profiling.SpanRecord("scoring.upload.copy",
                                  counts={"htod_bytes": 32 * 960 * 540})] * 20
    recs += [profiling.SpanRecord("scoring.upload.copy",
                                  counts={"htod_bytes": 20 * 960 * 540})] * 4
    recs += [profiling.SpanRecord("scoring.sync", counts={"syncs": 1, "dtoh_bytes": 8})] * 49
    monkeypatch.setattr(profiling, "_RECORDS", recs)
    ctx = types.SimpleNamespace(frames=180)
    assert reader("htod_mb_per_frame")(ctx) == pytest.approx(2.0736, rel=1e-12)
    assert reader("syncs_per_frame")(ctx) == pytest.approx(49 / 180, rel=1e-12)
    assert reader("syncs_per_frame")(types.SimpleNamespace(frames=0)) is None


def test_counter_readers_without_records(monkeypatch):
    """Nothing recorded, or a program with no span records (the parent of
    this metric): no reading, no error."""
    from pqa2_tpu_torch.utils import profiling

    ctx = types.SimpleNamespace(frames=180)
    monkeypatch.setattr(profiling, "_RECORDS", [])
    assert reader("htod_mb_per_frame")(ctx) is None
    monkeypatch.setitem(sys.modules, "pqa2_tpu_torch.utils.profiling",
                        types.ModuleType("pqa2_tpu_torch.utils.profiling"))
    assert reader("htod_mb_per_frame")(ctx) is None
    assert reader("syncs_per_frame")(ctx) is None


def test_idle_readers_take_program_spans_only():
    idle = {"scoring.upload.stack": 2.0, "scoring.upload.copy": 0.5, "upload": 1.0,
            "app.write_vmaf_json": 0.7, "app.write_psnr_log": 0.1, "write_ssim_log": 0.2,
            "cudaMemcpyAsync": 0.3, "(no host event)": 0.4}
    ctx = types.SimpleNamespace(trace=TraceSummary(window_s=10.0, busy_s=4.8, idle_s=idle))
    assert reader("upload_idle_pct")(ctx) == pytest.approx(25.0)
    assert reader("writer_idle_pct")(ctx) == pytest.approx(8.0)
    # Program spans name gaps, none under the upload or the writers (as
    # once uploads overlap the card's work): the share reads 0.
    ctx.trace.idle_s = {"scoring.sync": 1.0, "features.adm_tail": 0.5, "upload": 0.2}
    assert reader("upload_idle_pct")(ctx) == 0.0 and reader("writer_idle_pct")(ctx) == 0.0
    # The harness's own wrapper names alone (as on a program without spans) are not read.
    ctx.trace.idle_s = {"upload": 1.0, "write_vmaf_json": 0.5}
    assert reader("upload_idle_pct")(ctx) is None and reader("writer_idle_pct")(ctx) is None
    assert reader("upload_idle_pct")(types.SimpleNamespace(trace=None)) is None


def test_tiny_traced_run_reports_the_counts():
    """A traced CPU run at 72x96, six frames in chunks of four: luma lies on
    the device, so only chroma is copied (two planes of 36x48 bytes a side a
    frame); two chunks of 8 syncs and the SVR's one a request of six frames."""
    from pqa2_tpu_torch.utils import profiling

    profiling.clear()  # records of earlier traced runs in this process
    bench, cell, cfg, traffic = harness.load_cell("hd8_frames_mem")
    cfg = dict(cfg, width=96, height=72, chunk_size=4)
    traffic = dict(traffic, frames=6, check=dict(traffic["check"], workers=1))
    run = harness.Run(bench, cell, cfg, traffic, seed=2**31 + 7, seconds=0.5, trace=True,
                      device="cpu")
    out = run.execute()
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["htod_mb_per_frame"] == pytest.approx(2 * 2 * 36 * 48 / 1e6, rel=1e-12)
    assert m["syncs_per_frame"] == pytest.approx(17 / 6, rel=1e-12)
