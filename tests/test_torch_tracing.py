"""The port's own spans and counters (``pqa2_tpu_torch.utils.profiling``),
on the CPU at 64x48, five frames in chunks of two:

  * with no profiler running, scoring records nothing and never enters
    ``record_function``;
  * under a CPU profiler, ``analyze_frames`` records every span of the
    scoring path under one request id with its parent, and the
    ``htod_bytes`` and ``syncs`` counts equal sums worked out by hand at 8
    and 10 bits;
  * ``analyze_videos`` with ``tpu.profile_dir`` logs the counts' summary
    line, each record lies within 1 ms of its event in the exported Chrome
    trace, and the streaming producer thread's ``streaming.decode`` spans
    carry the request's id.

No JAX computation runs here. Keep this file below eight tests (ROADMAP Q1.0).
"""

import collections
import glob
import json
import logging

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.utils import profiling

H, W, N, CHUNK = 48, 64, 5, 2


def _planes(rng, depth):
    dt = np.uint8 if depth == 8 else np.uint16
    hi = 1 << depth

    def plane(h, w):
        return rng.integers(0, hi, (h, w)).astype(dt)

    return [{"y": plane(H, W), "u": plane(H // 2, W // 2), "v": plane(H // 2, W // 2)}
            for _ in range(N)]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear()
        out = fn()
    return out, profiling.records()


def test_spans_off_record_nothing(monkeypatch):
    from pqa2_tpu_torch.pipeline.scoring import score_planes

    def boom(*a, **k):
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "_Span", boom)
    profiling.clear()
    rng = np.random.default_rng(1)
    s = score_planes(_planes(rng, 8), _planes(rng, 8), chunk_size=CHUNK, device="cpu")
    assert s.n_frames == N
    assert profiling.records() == []


@pytest.mark.parametrize("depth", [8, 10])
def test_spans_on_counts_and_parents(tmp_path, depth):
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    rng = np.random.default_rng(depth)
    a = VMAFAnalyzer(device="cpu")
    a.chunk_size = CHUNK
    a.set_output_directory(str(tmp_path))
    res, recs = _profiled(lambda: a.analyze_frames(_planes(rng, depth), _planes(rng, depth),
                                                   bit_depth=depth))
    assert res is not None and res["frame_count"] == N
    ids = {r.request for r in recs}
    assert len(ids) == 1 and None not in ids
    chunks = 3  # frames [0, 2), [2, 4), [4, 5)
    got = collections.Counter((r.name, r.parent) for r in recs)
    want = {("app.request", None): 1,
            ("app.write_vmaf_json", "app.request"): 1,
            ("app.write_psnr_log", "app.request"): 1,
            ("app.write_ssim_log", "app.request"): 1,
            # luma of both sides, then U and V of both sides
            ("scoring.upload.stack", "app.request"): 6 * chunks,
            ("scoring.upload.copy", "app.request"): 6 * chunks,
            ("features.vif_int", "app.request"): chunks,
            ("features.adm_int", "app.request"): chunks,
            # digits_from_sums and adm_from_digit_sums
            ("features.adm_tail", "app.request"): 2 * chunks,
            ("scoring.plane_metrics", "app.request"): chunks,
            ("scoring.svr", "app.request"): 1,
            # fetch_features, the ADM sums, SSIM and SSE of three planes, the SVR
            ("scoring.sync", "app.request"): chunks,
            ("scoring.sync", "features.adm_int"): chunks,
            ("scoring.sync", "scoring.plane_metrics"): 6 * chunks,
            ("scoring.sync", "scoring.svr"): 1}
    assert dict(got) == want
    total = profiling.summary(recs)
    assert total["frames"] == N
    assert total["syncs_per_frame"] * N == 8 * chunks + 1
    dtoh = sum(r.counts["dtoh_bytes"] for r in recs if r.name == "scoring.sync")
    assert dtoh > 0 and total["dtoh_mb_per_frame"] == pytest.approx(dtoh / N / 1e6, rel=1e-12)
    # Luma with its motion halo: 3 + 4 + 2 frames a side; chroma: 5 frames,
    # two planes a side. uint16 travels as int32.
    sample = 1 if depth == 8 else 4
    htod = (2 * (3 + 4 + 2) * H * W + 2 * 2 * N * (H // 2) * (W // 2)) * sample
    assert sum(r.counts.get("htod_bytes", 0) for r in recs) == htod
    assert total["htod_mb_per_frame"] == pytest.approx(htod / N / 1e6, rel=1e-12)
    for r in recs:
        assert r.start_ns <= r.end_ns


@pytest.fixture(scope="module")
def traced_videos(tmp_path_factory):
    """analyze_videos on two tiny y4m files with ``tpu.profile_dir`` set:
    (records, Chrome trace, log lines)."""
    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.io.y4m import write_y4m

    d = tmp_path_factory.mktemp("traced")
    rng = np.random.default_rng(3)
    paths = [str(d / "ref.y4m"), str(d / "dist.y4m")]
    for p in paths:
        write_y4m(p, _planes(rng, 8))
    om = OptionsManager(str(d / "settings.json"), save_debounce_s=0)
    om.update_setting("tpu", "profile_dir", str(d / "trace"))
    om.update_setting("tpu", "chunk_size", CHUNK)
    a = VMAFAnalyzer(om, device="cpu")
    a.set_output_directory(str(d / "out"))
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    log = logging.getLogger(profiling.__name__)
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        assert a.analyze_videos(*paths) is not None
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    (trace,) = glob.glob(str(d / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        return profiling.records(), json.load(f), lines


def test_records_on_the_trace_clock_and_summary_line(traced_videos):
    recs, trace, lines = traced_videos
    summary = [ln for ln in lines if ln.startswith("trace vmaf_score:")]
    assert len(summary) == 1 and f"{N} frames" in summary[0], lines
    assert "syncs/frame" in summary[0] and "scoring.upload.copy" in summary[0]
    assert "DtoH" in summary[0] and "DtoH None" not in summary[0]
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            start = base + round(float(e["ts"]) * 1000)
            events[e["name"]].append((start, start + round(float(e["dur"]) * 1000)))
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append((r.start_ns, r.end_ns))
    assert "streaming.decode" in by_name and "app.request" in by_name
    # The profiler follows the thread that started it: the producer
    # thread's spans are records only.
    assert events.pop("streaming.decode", []) == []
    by_name.pop("streaming.decode")
    for name, spans in by_name.items():
        assert len(events[name]) == len(spans), name
        for (a, b), (ea, eb) in zip(sorted(spans), sorted(events[name])):
            assert abs(a - ea) < 1_000_000 and abs(b - eb) < 1_000_000, (name, a - ea, b - eb)


def test_streaming_decode_spans_carry_the_request(traced_videos):
    recs = traced_videos[0]
    (req,) = [r for r in recs if r.name == "app.request"]
    assert req.counts == {"frames": N}
    decode = [r for r in recs if r.name == "streaming.decode"]
    waits = [r for r in recs if r.name == "streaming.decode_wait"]
    assert len(decode) >= 3 and waits
    assert {r.request for r in recs} == {req.request}
    # The producer thread's spans have no parent on their thread.
    assert {r.parent for r in decode} == {None}
    assert {r.parent for r in waits} == {"app.request"}
