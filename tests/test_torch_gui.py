"""The port's desktop window (``pqa2_tpu_torch.ui``, ``pqa2_tpu_torch.main``)
driven end to end under the functional PyQt5 stub, on the CPU.

Run as a script, this file is the driver: in a fresh interpreter it installs
``tests/support/qt_stub.py`` before anything imports PyQt5, builds the
window through ``pqa2_tpu_torch.main.main(["--device", DEVICE])`` (the stub's
event loop returns at once) and drives Setup -> Capture -> Analysis ->
Results as a user would: the six tabs and the wizard's Back/Next, a setting
saved through the Options tab, the reference analysed by the Setup tab's
``ReferenceAnalysisThread``, the capture handed over with
``handle_capture_finished``, ``run_combined_analysis`` with ``vmaf_v0.6.1``
over the whole clip, the Results tab's display, its CSV/HTML (and, where
matplotlib is installed, PDF) exports and its history, the themes,
``start_new_test`` and ``close``. Its last line of output is one JSON
object: the alignment, every per-frame array of the analysis (features,
VMAF, PSNR, SSIM) with its dtype, each kernel's launches during the
Analysis run and its wall seconds. chip_smoke.py runs the same driver with
``--device cuda`` on its 1080p workflow pair.

    python tests/test_torch_gui.py --device cpu --ref REF.y4m --cap CAP.y4m

Here (each test runs the driver or the entry point in a child, so the stub
never reaches this process's import cache):

  * the window's Analysis run on a 64x96 bookend pair gives the alignment
    and every per-frame value of ``run_combined_workflow(device="cpu")``
    with the same settings, in every bit, and launches no kernel;
  * ``python -m pqa2_tpu_torch.main`` without PyQt5 exits 2 with the
    pointer to the port's CLI, and logs the state checks (no card here:
    ``cuda_devices`` False) under its own log directory.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile``
queues files by their number of tests (ROADMAP Q1.0).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: The bookend settings of the drive (and of chip_smoke's workflow phase).
FRAME_OFFSET = 0


def kernel_counters():
    """Each kernel's launch counter: (wrapper, attribute), as chip_smoke.py
    counts them. Kernel 1f is the integer VIF wrapper's fast form."""
    from pqa2_tpu_torch.ops import (
        cuda_adm,
        cuda_adm_int,
        cuda_motion,
        cuda_ssim,
        cuda_vif,
        cuda_vif_int,
    )

    return {"vif_int_scale": (cuda_vif_int.vif_int_scale, "launches"),
            "vif_int_scale_fast": (cuda_vif_int.vif_int_scale, "fast_launches"),
            "log2_table_audit": (cuda_vif_int.log2_table_audit, "launches"),
            "adm_int_level": (cuda_adm_int.adm_int_level, "launches"),
            "ssim_sse_plane": (cuda_ssim.ssim_sse_plane, "launches"),
            "vif_scale": (cuda_vif.vif_scale, "launches"),
            "adm_level": (cuda_adm.adm_level, "launches"),
            "motion_sad": (cuda_motion.motion_sad, "launches")}


def per_frame(scores):
    """name -> per-frame array of a ClipScores: features, VMAF, PSNR, SSIM."""
    out = {f"feature {k}": v for k, v in scores.features.items()}
    out["vmaf"] = scores.vmaf
    out.update(scores.psnr)
    out.update(scores.ssim)
    return out


def encode_arrays(arrays):
    """Arrays as JSON-exact lists (float32 widens to float64 exactly)."""
    return {k: {"dtype": str(v.dtype), "values": np.asarray(v, np.float64).tolist()}
            for k, v in arrays.items()}


def decode_arrays(enc):
    return {k: np.array(v["values"], np.float64).astype(v["dtype"]) for k, v in enc.items()}


def without_paths(alignment):
    return {k: v for k, v in alignment.items()
            if k not in ("aligned_reference", "aligned_captured")}


def _nav_buttons(tab, QPushButton):
    found = {}

    def walk(layout):
        items = getattr(layout, "items", None)
        if not isinstance(items, list):
            return
        for it in items:
            if isinstance(it, QPushButton):
                if "Next" in it.text():
                    found["next"] = it
                elif "Back" in it.text():
                    found["back"] = it
            else:
                walk(it)

    walk(tab.layout())
    return found


def drive(device: str, ref: str, cap: str) -> dict:
    """The window from Setup to Results on ``device``; returns the record
    printed as the driver's last line. Run from the directory the window
    may write in (settings under ``config/``, tests under ``results/``)."""
    sys.path.insert(0, str(ROOT / "tests" / "support"))
    import qt_stub

    qt_stub.install()
    from PyQt5.QtWidgets import QFileDialog, QMainWindow, QPushButton

    shown = []
    show = QMainWindow.show
    QMainWindow.show = lambda self: (shown.append(self), show(self))[1]
    from pqa2_tpu_torch import main as entry

    rc = entry.main(["--device", device])
    assert rc == 0, rc
    assert len(shown) == 1, shown
    win = shown[0]
    assert win.device.type == device, win.device

    # Structure and the wizard's Back/Next.
    names = [win.tabs.tabText(i) for i in range(win.tabs.count())]
    assert names == ["Setup", "Capture", "Analysis", "Results", "Options", "Help"], names
    order = [win.setup_tab, win.capture_tab, win.analysis_tab, win.results_tab]
    for i, tab in enumerate(order[:-1]):
        _nav_buttons(tab, QPushButton)["next"].clicked.emit()
        assert win.tabs.currentIndex() == i + 1, (i, win.tabs.currentIndex())
    for i in (3, 2, 1):
        _nav_buttons(order[i], QPushButton)["back"].clicked.emit()
        assert win.tabs.currentIndex() == i - 1
    assert len(win.menuBar().actions) >= 2, "File/Help menus missing"

    # A setting saved through the Options tab's schema editors.
    options = win.options_manager
    otab = win.options_tab
    otab._editors[("bookend", "frame_offset")][2](FRAME_OFFSET)
    otab.save_settings()
    assert options.get_setting("bookend", "frame_offset") == FRAME_OFFSET
    assert options.get_setting("bookend", "motion_compensation") is False

    # Setup: the reference analysed on the window's device.
    t0 = time.perf_counter()
    win.setup_tab.analyze_reference(ref)
    win.setup_tab._thread.join(timeout=600)
    setup_seconds = time.perf_counter() - t0
    info = win.reference_info
    assert info is not None and info["path"] == ref, "the reference was not analysed"
    assert info["has_bookends"] is False and info["frame_count"] > 0, info

    # Capture -> Analysis handoff.
    win.handle_capture_finished(True, cap)
    assert win.tabs.currentIndex() == 2, "handoff should land on Analysis"
    win.setup_tab.duration_combo.setCurrentText("Full duration")
    assert win.setup_tab.selected_duration() is None
    atab = win.analysis_tab
    atab.model_combo.setCurrentText("vmaf_v0.6.1")
    assert atab.model_combo.currentText() == "vmaf_v0.6.1"

    counters = kernel_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    atab.run_combined_analysis()
    thread = atab._workflow_thread
    assert thread is not None, atab.log_pane.toPlainText()
    thread.join(timeout=1800)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    assert not thread.is_alive(), "the workflow thread did not finish"
    assert thread.result is not None, atab.log_pane.toPlainText()
    res = thread.result["analysis"]
    assert atab.run_btn.isEnabled(), "the Run button stays disabled"
    assert win.tabs.currentWidget() is win.results_tab

    # Results: the display and the files written.
    rtab = win.results_tab
    shown_vmaf = rtab.vmaf_label.text()
    assert shown_vmaf.startswith(f"VMAF: {res['vmaf_score']:.2f}"), shown_vmaf
    out_dir = os.path.dirname(res["json_path"])
    meta_path = os.path.join(out_dir, f"{win.current_test_name()}_metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["scores"]["vmaf"] == res["vmaf_score"] and meta["model"] == "vmaf_v0.6.1"
    assert meta["settings"]["bookend"]["frame_offset"] == FRAME_OFFSET
    with open(res["json_path"]) as f:
        log_json = json.load(f)
    frames = log_json["frames"]
    assert len(frames) == res["frame_count"]
    assert os.path.exists(os.path.join(out_dir, "metadata.json"))

    exports = os.path.join(os.getcwd(), "exports")
    os.makedirs(exports, exist_ok=True)
    csv_path = os.path.join(exports, "frames.csv")
    QFileDialog._next_paths.append(csv_path)
    rtab.csv_btn.clicked.emit()
    with open(csv_path) as f:
        rows = f.read().splitlines()
    assert rows[5].startswith("frame,") and len(rows) == 6 + len(frames), len(rows)
    html_path = os.path.join(exports, "report.html")
    QFileDialog._next_paths.append(html_path)
    rtab.html_btn.clicked.emit()
    with open(html_path) as f:
        assert f"{res['vmaf_score']:.2f}" in f.read()
    import importlib.util

    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    pdf_path = os.path.join(exports, "report.pdf")
    if has_matplotlib:
        QFileDialog._next_paths.append(pdf_path)
        rtab.pdf_btn.clicked.emit()
        rtab._report_thread.join(timeout=300)
        assert os.path.getsize(pdf_path) > 0, "PDF report not written"

    # History: view re-displays, combined CSV, delete empties.
    assert rtab.history_list.count() == 1, rtab.history_list.count()
    rtab.vmaf_label.setText("VMAF: -")
    rtab.history_list.setCurrentRow(0)
    rtab.view_selected()
    assert rtab.vmaf_label.text() == shown_vmaf, "view did not re-display"
    combined = os.path.join(exports, "combined.csv")
    QFileDialog._next_paths.append(combined)
    rtab.export_combined_csv()
    with open(combined) as f:
        assert win.current_test_name() in f.read()

    record = {
        "device": str(win.device),
        "alignment": without_paths(thread.result["alignment"]),
        "per_frame": encode_arrays(per_frame(thread.analyzer.last_scores)),
        "launches": launches,
        "analysis_seconds": seconds,
        "workflow_wall_seconds": thread.result["wall_seconds"],
        "setup_seconds": setup_seconds,
        "displayed": shown_vmaf,
        "vmaf_score": res["vmaf_score"],
        "frames": len(frames),
        "pdf": has_matplotlib,
    }

    rtab.history_list.setCurrentRow(0)
    rtab.delete_selected()
    assert not os.path.isdir(out_dir) and rtab.history_list.count() == 0

    # Themes over live settings, reset, close.
    for theme in ("Dark", "Light", "Custom", "System"):
        options.update_setting("branding", "selected_theme", theme)
        win.theme_manager.apply_current_theme()
    options.flush()
    win.start_new_test()
    assert win.tabs.currentIndex() == 0 and atab.capture_path is None
    win.close()
    return record


def run_driver(device, ref, cap, cwd, timeout=600, env=None):
    """The driver in a fresh interpreter in ``cwd`` -> (its record, stderr).
    Logs go under ``cwd``/appdata."""
    cwd = os.path.abspath(cwd)
    env = dict(env or os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["APPDATA"] = os.path.join(cwd, "appdata")
    os.makedirs(cwd, exist_ok=True)
    out = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--device",
                          device, "--ref", os.path.abspath(ref), "--cap", os.path.abspath(cap)],
                         cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"window driver failed (rc={out.returncode}):\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


# -- the tests ------------------------------------------------------------------

N, H, W = 6, 64, 96


def write_pair(d, seed=7):
    """(ref, cap) y4m paths in ``d``: N frames of smooth 8-bit content, and a
    capture of white bookends around two blurred, noisy loops of it."""
    from pqa2_tpu_torch.io.y4m import write_y4m

    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 220, size=(N, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base)
    loop = np.clip(np.round((ref + np.roll(ref, 1, -1) + np.roll(ref, 1, -2)) / 3.0)
                   + rng.integers(-8, 9, ref.shape), 0, 255)

    def planes(ys):
        return [{"y": y.astype(np.uint8), "u": np.full((H // 2, W // 2), 128, np.uint8),
                 "v": np.full((H // 2, W // 2), 123, np.uint8)} for y in ys]

    white = planes([np.full((H, W), 235)])[0]
    os.makedirs(d, exist_ok=True)
    rp, cp = os.path.join(d, "ref.y4m"), os.path.join(d, "cap.y4m")
    write_y4m(rp, planes(list(ref)))
    write_y4m(cp, [white] * 5 + planes(list(loop)) + [white] * 5 + planes(list(loop))
              + [white] * 5)
    return rp, cp


def test_window_analysis_equals_the_workflow(tmp_path):
    import shutil

    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.app.workflow import run_combined_workflow

    rp, cp = write_pair(str(tmp_path / "clips"))
    got, _ = run_driver("cpu", rp, cp, tmp_path / "gui")

    om = OptionsManager(str(tmp_path / "settings.json"), save_debounce_s=0)
    om.update_setting("bookend", "frame_offset", FRAME_OFFSET)
    os.makedirs(tmp_path / "direct")
    cap = shutil.copy(cp, tmp_path / "direct" / "cap.y4m")
    an = VMAFAnalyzer(device="cpu")
    an.set_output_directory(str(tmp_path / "direct" / "out"))
    want = run_combined_workflow(rp, cap, options_manager=om, analyzer=an, device="cpu")
    assert want is not None

    assert got["device"] == "cpu" and got["pdf"] in (True, False)
    assert got["alignment"] == json.loads(json.dumps(without_paths(want["alignment"])))
    assert got["frames"] == want["analysis"]["frame_count"] >= N - 2
    assert got["vmaf_score"] == want["analysis"]["vmaf_score"]
    ours, theirs = decode_arrays(got["per_frame"]), per_frame(an.last_scores)
    assert ours.keys() == theirs.keys() and len(ours) >= 17
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert got["launches"] == dict.fromkeys(got["launches"], 0)
    assert got["analysis_seconds"] > 0 and got["setup_seconds"] > 0


def test_main_without_qt_points_at_the_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), APPDATA=str(tmp_path / "appdata"))
    for argv in ([], ["--device", "cpu"]):
        out = subprocess.run([sys.executable, "-m", "pqa2_tpu_torch.main", *argv],
                             cwd=tmp_path, env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 2, out.stderr[-2000:]
        assert "python -m pqa2_tpu_torch.cli --help" in out.stderr
        assert "PyQt5 is not installed" in out.stderr
    with open(tmp_path / "appdata" / "logs" / "vmaf_app.log") as f:
        text = f.read()
    checks = [line for line in text.splitlines() if "application state checks:" in line]
    assert len(checks) == 2 and all(" - pqa2_tpu_torch - INFO - " in c for c in checks)
    # No card here: the state checks say so, and the window never started.
    import torch

    want = "'cuda_devices': True" if torch.cuda.is_available() else "'cuda_devices': False"
    assert all(want in c for c in checks), checks
    assert (tmp_path / "config" / "settings.json").exists()


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="drive the port's window under the PyQt5 stub")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ref", required=True)
    ap.add_argument("--cap", required=True)
    args = ap.parse_args(argv)
    record = drive(args.device, os.path.abspath(args.ref), os.path.abspath(args.cap))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
