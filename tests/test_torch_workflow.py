"""The port's decode-once align-and-score workflow (``app/workflow.py``) and
the ``align``/``full`` subcommands, on the CPU.

  (f) ``run_combined_workflow(device="cpu")`` against the JAX package's on
      tests/test_workflow.py's bookend pair (white bookends around two
      loops of the reference; here the loops are blurred and noisier, so
      per-frame VMAF stays below its clip at 100 and the comparison says
      something): the alignment dicts, the aligned y4m bytes and the
      per-frame scores. The JAX side, with its ``align`` and ``full``
      subcommands, runs in one child interpreter
      (tests/test_torch_fast.py:jax_child);
  (g) the decode-once path equals the two-pass path
      (``max_in_memory_bytes=0``: streamed alignment, trims, streaming
      analyzer) in every per-frame bit, at 8 bits and on a mixed 8/10-bit
      pair;
  (h) options and refusals: the duration cap, ``write_aligned=False``,
      feature subsample 2, a missing file; without a card, every new entry
      point asked for ``cuda`` (the default) raises and nothing is written;
  (i) each clip's luma is uploaded once: the tensors scoring receives share
      storage with the ones the alignment read, and with motion
      compensation the capture's luma is rewritten on the host (``dist_y``
      None);
  (j) ``CombinedWorkflowThread``'s signals in order, and the ``align`` and
      ``full`` subcommands' JSON keys equal to the JAX package's.

Tolerances against JAX (each with its reason): alignment dicts (paths
aside) and aligned y4m bytes equal; features as tests/test_torch_inmemory.py
states for the integer family (vif_scale equal, adm2 atol 2e-6, motion rtol
1e-6), PSNR atol 1e-4 (MSE rtol 1e-5), SSIM atol 1e-6 (ssim_db, a log of
1 - ssim, not compared) and VMAF atol 1e-3, as tests/test_torch_slice.py
states and compares them.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.io.y4m import write_y4m
from test_torch_fast import jax_child
from test_torch_inmemory import ADM_ATOL, MOTION_RTOL, VIF_ATOL
from test_torch_slice import PSNR_ATOL, SSIM_ATOL, VMAF_ATOL

N, H, W = 6, 64, 96
ALIGNED = ("aligned_reference", "aligned_captured")


def _planes(ys, depth=8):
    dt = np.uint8 if depth == 8 else np.uint16
    mid = 128 << (depth - 8)
    return [{"y": y.astype(dt), "u": np.full((H // 2, W // 2), mid, dt),
             "v": np.full((H // 2, W // 2), mid - 5, dt)} for y in ys]


def write_pair(d, seed=5, cap_depth=8, shift=None):
    """(ref path, cap path) in ``d``: an 8-bit reference of N frames and a
    capture of white bookends around two blurred, noisy loops of it, at
    ``cap_depth`` bits; with ``shift``, its loops rolled by (dy, dx) in luma
    and half that in chroma."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 220, size=(N, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base)
    blur = (ref + np.roll(ref, 1, -1) + np.roll(ref, 1, -2)) / 3.0
    s = 1 << (cap_depth - 8)
    peak = (1 << cap_depth) - 1
    loop = np.clip(np.round(blur * s) + rng.integers(-8 * s, 8 * s + 1, ref.shape), 0, peak)
    loop = _planes(list(loop), cap_depth)
    if shift is not None:
        loop = [{p: np.roll(f[p], tuple(v // (1 if p == "y" else 2) for v in shift),
                            axis=(0, 1)) for p in "yuv"} for f in loop]
    white = _planes([np.full((H, W), 235 * s)], cap_depth)[0]
    os.makedirs(d, exist_ok=True)
    rp, cp = os.path.join(d, "ref.y4m"), os.path.join(d, "cap.y4m")
    write_y4m(rp, _planes(list(ref)))
    write_y4m(cp, [white] * 5 + loop + [white] * 5 + loop + [white] * 5,
              colorspace="C420mpeg2" if cap_depth == 8 else f"C420p{cap_depth}")
    return rp, cp


def _copy_capture(cp, d):
    """The capture copied into its own directory ``d`` (aligned files are
    written next to the capture)."""
    os.makedirs(d, exist_ok=True)
    return shutil.copy(cp, os.path.join(d, "cap.y4m"))


_JAX = """
import contextlib, io, json, os
os.environ["PQA2_COMPILE_CACHE"] = "0"
from pqa2_tpu import cli
from pqa2_tpu.app import vmaf_analyzer as va
from pqa2_tpu.app.workflow import run_combined_workflow

seen = []
finalize = va.VMAFAnalyzer._finalize
def record(self, scores, **kw):
    seen.append(scores)
    return finalize(self, scores, **kw)
va.VMAFAnalyzer._finalize = record

ref = str(z["ref"])
out = {}
an = va.VMAFAnalyzer()
an.set_output_directory(str(z["out"]))
res = run_combined_workflow(ref, str(z["cap_workflow"]), analyzer=an)
s = seen[-1]
out["workflow"] = res
out["scores"] = (s.features, s.vmaf, s.psnr, s.ssim)
out["aligned"] = [open(res["alignment"][k], "rb").read()
                  for k in ("aligned_reference", "aligned_captured")]
for name, argv in (("align", ["align", ref, str(z["cap_align"])]),
                   ("full", ["full", ref, str(z["cap_full"]), "--out", str(z["out_full"])])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out[name] = (rc, json.loads(buf.getvalue().strip().splitlines()[-1]))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_workflow")
    return d, write_pair(str(d / "pair"))


@pytest.fixture(scope="module")
def jax_side(pair, tmp_path_factory):
    """The JAX package's workflow and subcommands on the pair."""
    d, (rp, cp) = pair
    j = d / "jax"
    inputs = {"ref": np.array(rp), "out": np.array(str(j / "o")),
              "out_full": np.array(str(j / "full"))}
    for k in ("workflow", "align", "full"):
        inputs[f"cap_{k}"] = np.array(_copy_capture(cp, str(j / k)))
    return jax_child(_JAX, inputs, tmp_path_factory.mktemp("jax"))


def _analyzer(out_dir):
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    a = VMAFAnalyzer(device="cpu")
    a.set_output_directory(out_dir)
    return a


def _alignment(d):
    return {k: v for k, v in d.items() if k not in ALIGNED}


def test_workflow_matches_jax(pair, jax_side):
    from pqa2_tpu_torch.app.workflow import run_combined_workflow

    d, (rp, cp) = pair
    a = _analyzer(str(d / "port_o"))
    got = run_combined_workflow(rp, _copy_capture(cp, str(d / "port")), analyzer=a,
                                device="cpu")
    want = jax_side["workflow"]
    assert _alignment(got["alignment"]) == _alignment(want["alignment"])
    assert got["alignment"]["confidence"] > 0.9 and not got["alignment"]["is_fallback"]
    aligned = [open(got["alignment"][k], "rb").read() for k in ALIGNED]
    assert aligned == jax_side["aligned"]
    assert set(got["analysis"]) == set(want["analysis"])
    assert got["analysis"]["frame_count"] == want["analysis"]["frame_count"] >= 3
    features, vmaf, psnr, ssim = jax_side["scores"]
    s = a.last_scores
    assert set(s.features) == set(features)
    for k in s.features:
        if k.startswith("vif"):
            np.testing.assert_allclose(s.features[k], features[k], rtol=0,
                                       atol=VIF_ATOL["integer"], err_msg=k)
    np.testing.assert_allclose(s.features["adm2"], features["adm2"], rtol=0,
                               atol=ADM_ATOL["integer"])
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(s.features[k], features[k], rtol=MOTION_RTOL["integer"],
                                   atol=0)
    np.testing.assert_allclose(s.vmaf, vmaf, rtol=0, atol=VMAF_ATOL)
    assert 20 < s.vmaf.min() and s.vmaf.max() < 99
    # PSNR and SSIM as tests/test_torch_slice.py compares them: the MSEs
    # within 1e-5 relative, ssim_db (a log of 1 - ssim) not compared.
    assert set(s.psnr) == set(psnr) and set(s.ssim) == set(ssim)
    for k in psnr:
        np.testing.assert_allclose(s.psnr[k], psnr[k], rtol=0 if k.startswith("psnr") else 1e-5,
                                   atol=PSNR_ATOL if k.startswith("psnr") else 0, err_msg=k)
    for k in ("ssim_y", "ssim_u", "ssim_v", "ssim_all"):
        np.testing.assert_allclose(s.ssim[k], ssim[k], rtol=0, atol=SSIM_ATOL, err_msg=k)


def _per_frame(scores):
    out = {f"feature {k}": v for k, v in scores.features.items()}
    out["vmaf"] = scores.vmaf
    out.update({k: v for k, v in scores.psnr.items()})
    out.update({k: v for k, v in scores.ssim.items()})
    return out


@pytest.mark.parametrize("cap_depth", [8, 10], ids=["8-bit", "8-and-10-bit"])
def test_decode_once_equals_two_pass(cap_depth, tmp_path):
    from pqa2_tpu_torch.app.workflow import run_combined_workflow

    rp, cp = write_pair(str(tmp_path / "pair"), seed=cap_depth, cap_depth=cap_depth)
    runs = []
    for budget in (2 << 30, 0):
        a = _analyzer(str(tmp_path / f"o{budget}"))
        out = run_combined_workflow(rp, cp, analyzer=a, device="cpu",
                                    max_in_memory_bytes=budget)
        assert out is not None
        runs.append((out, _per_frame(a.last_scores), a.last_scores.peak))
    (mem, mem_s, mem_peak), (two, two_s, two_peak) = runs
    assert mem["alignment"] == two["alignment"]
    assert mem_peak == two_peak == (1 << cap_depth) - 1
    assert mem_s.keys() == two_s.keys() and len(mem_s) == 7 + 1 + 8 + 5
    for k in mem_s:
        assert mem_s[k].dtype == two_s[k].dtype, k
        np.testing.assert_array_equal(mem_s[k], two_s[k], err_msg=k)
    assert mem["analysis"]["frame_count"] == len(mem_s["vmaf"]) >= 3


def test_options_and_refusals(pair, tmp_path):
    from pqa2_tpu_torch.app.bookend_aligner import BookendAligner
    from pqa2_tpu_torch.app.workflow import run_combined_workflow

    _, (rp, cp) = pair
    cp = _copy_capture(cp, str(tmp_path / "cap"))
    out = run_combined_workflow(rp, cp, out_dir=str(tmp_path / "d"), duration=3 / 30.0,
                                device="cpu")
    assert out["analysis"]["frame_count"] == 3
    assert [b - a for a, b in (out["alignment"]["ref_range"], out["alignment"]["cap_range"])] \
        == [3, 3]
    for k in ALIGNED:
        os.remove(out["alignment"][k])
    out = run_combined_workflow(rp, cp, out_dir=str(tmp_path / "n"), write_aligned=False,
                                device="cpu")
    assert out["alignment"]["aligned_reference"] is None
    assert sorted(os.listdir(os.path.dirname(cp))) == ["cap.y4m"]
    a = _analyzer(str(tmp_path / "sub"))
    a.feature_subsample = 2
    out = run_combined_workflow(rp, cp, analyzer=a, device="cpu")
    r0, r1 = out["alignment"]["ref_range"]
    assert out["analysis"]["frame_count"] == -(-(r1 - r0) // 2) and a.last_scores.frame_step == 2
    errors = []
    aligner = BookendAligner(device="cpu")
    aligner.error_occurred.connect(errors.append)
    assert run_combined_workflow(str(tmp_path / "no.y4m"), cp, aligner=aligner,
                                 device="cpu") is None
    assert errors and "not found" in errors[0]

    if torch.cuda.is_available():
        return
    from pqa2_tpu_torch import cli
    from pqa2_tpu_torch.align.motioncomp import estimate_shifts
    from pqa2_tpu_torch.align.stats import frame_luma_stats, stats_and_thumbs
    from pqa2_tpu_torch.align.streamed import streamed_align
    from pqa2_tpu_torch.align.temporal import align_bookend_clips, thumb_series
    from pqa2_tpu_torch.app import (
        BookendAlignmentThread,
        CombinedWorkflowThread,
        ReferenceAnalysisThread,
        ReferenceAnalyzer,
    )

    x = np.zeros((2, 16, 16), np.uint8)
    before = sorted(os.listdir(os.path.dirname(cp)))
    for name, fn in {
        "BookendAligner": BookendAligner,
        "ReferenceAnalyzer": ReferenceAnalyzer,
        "run_combined_workflow": lambda: run_combined_workflow(rp, cp),
        "frame_luma_stats": lambda: frame_luma_stats(x),
        "stats_and_thumbs": lambda: stats_and_thumbs(x),
        "thumb_series": lambda: thumb_series(x),
        "align_bookend_clips": lambda: align_bookend_clips(x, x),
        "estimate_shifts": lambda: estimate_shifts(x, x),
        "streamed_align": lambda: streamed_align(rp, cp),
        "BookendAlignmentThread": lambda: BookendAlignmentThread(rp, cp),
        "ReferenceAnalysisThread": lambda: ReferenceAnalysisThread(rp),
        "CombinedWorkflowThread": lambda: CombinedWorkflowThread(rp, cp),
        "cli align": lambda: cli.main(["align", rp, cp]),
        "cli full": lambda: cli.main(["full", rp, cp, "--out", str(tmp_path / "f")]),
    }.items():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            fn()
            pytest.fail(name)
    assert sorted(os.listdir(os.path.dirname(cp))) == before
    assert not os.path.exists(tmp_path / "f")


def test_one_upload_per_clip(tmp_path, monkeypatch):
    from pqa2_tpu_torch.app import workflow
    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.pipeline import scoring

    seen = {"upload": [], "align": [], "score": [], "features": []}
    upload, align, analyze = workflow.upload, workflow.align_bookend_clips, \
        VMAFAnalyzer.analyze_frames
    extract = scoring.extract_features_batched

    def spy_upload(*a, **k):
        seen["upload"].append(upload(*a, **k))
        return seen["upload"][-1]

    def spy_align(ref, cap, **k):
        seen["align"].append((ref, cap))
        return align(ref, cap, **k)

    def spy_analyze(self, *a, **k):
        seen["score"].append((k["ref_y"], k["dist_y"]))
        return analyze(self, *a, **k)

    def spy_extract(rb, db, **k):
        seen["features"].append((rb, db))
        return extract(rb, db, **k)

    monkeypatch.setattr(workflow, "upload", spy_upload)
    monkeypatch.setattr(workflow, "align_bookend_clips", spy_align)
    monkeypatch.setattr(VMAFAnalyzer, "analyze_frames", spy_analyze)
    monkeypatch.setattr(scoring, "extract_features_batched", spy_extract)

    def ptr(t):
        return t.untyped_storage().data_ptr()

    for mc in (False, True):
        for v in seen.values():
            v.clear()
        rp, cp = write_pair(str(tmp_path / f"mc{mc}"), shift=(2, 6) if mc else None)
        om = OptionsManager(settings_file=str(tmp_path / f"s{mc}.json"), save_debounce_s=0)
        om.update_setting("bookend", "frame_offset", 0)
        om.update_setting("bookend", "motion_compensation", mc)
        a = _analyzer(str(tmp_path / f"o{mc}"))
        out = workflow.run_combined_workflow(rp, cp, options_manager=om, analyzer=a,
                                             device="cpu")
        assert out["alignment"]["bookend_info"]["motion_compensated"] is mc
        (ref_dev, cap_dev), = seen["align"]
        assert [ptr(t) for t in seen["upload"]] == [ptr(ref_dev), ptr(cap_dev)]
        (ref_y, dist_y), = seen["score"]
        r0, r1 = out["alignment"]["ref_range"]
        c0, c1 = out["alignment"]["cap_range"]
        assert ptr(ref_y) == ptr(ref_dev) and ref_y.data_ptr() == ref_dev[r0].data_ptr()
        assert ref_y.shape[0] == r1 - r0 and ref_dev.dtype == torch.uint8
        # Scoring reads its chunks from those buffers: no second upload.
        assert all(ptr(rb) == ptr(ref_dev) for rb, _ in seen["features"])
        if mc:
            assert dist_y is None
            assert a.last_scores.vmaf.min() > 60
        else:
            assert ptr(dist_y) == ptr(cap_dev) and dist_y.data_ptr() == cap_dev[c0].data_ptr()
            assert dist_y.shape[0] == c1 - c0
            assert all(ptr(db) == ptr(cap_dev) for _, db in seen["features"])


def test_thread_and_cli(pair, jax_side, tmp_path, capsys):
    from pqa2_tpu_torch import cli
    from pqa2_tpu_torch.app.workflow import CombinedWorkflowThread

    d, (rp, cp) = pair
    t = CombinedWorkflowThread(rp, _copy_capture(cp, str(tmp_path / "t")),
                               out_dir=str(tmp_path / "wf"), device="cpu")
    events = []
    for name in ("alignment_progress", "alignment_complete", "status_update",
                 "analysis_progress", "analysis_complete", "error_occurred",
                 "analysis_failed"):
        getattr(t, name).connect(lambda v, name=name: events.append((name, v)))
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and t.result is not None
    names = [n for n, _ in events if n != "status_update"]
    first_analysis = names.index("analysis_progress")
    assert names.index("alignment_complete") < first_analysis
    assert set(names[:first_analysis]) == {"alignment_progress", "alignment_complete"}
    assert names[-1] == "analysis_complete" and names.count("analysis_complete") == 1
    assert "error_occurred" not in names and "analysis_failed" not in names
    for channel in ("alignment_progress", "analysis_progress"):
        values = [v for n, v in events if n == channel]
        assert values == sorted(values) and values[-1] == 100, channel
    assert t.result["alignment"] == dict(events)["alignment_complete"]

    for name, argv in (("align", ["align", rp, _copy_capture(cp, str(tmp_path / "a"))]),
                       ("full", ["full", rp, _copy_capture(cp, str(tmp_path / "f")),
                                 "--out", str(tmp_path / "full")])):
        capsys.readouterr()
        assert cli.main(argv + ["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rc, want = jax_side[name]
        assert rc == 0 and set(got) == set(want), name
        assert got["confidence" if name == "align" else "alignment_confidence"] > 0.9
    for k in ("report_html", "csv", "report_pdf"):
        assert os.path.getsize(got[k]) > 100, k
