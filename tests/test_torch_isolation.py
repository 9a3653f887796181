"""pqa2_tpu_torch stands alone and never hides a missing card.

  * a fresh interpreter imports the package and every module of it (the
    window's under the PyQt5 stub) with neither ``jax`` nor ``pqa2_tpu``
    (nor any submodule of either) in ``sys.modules``;
  * no source file of the package, and not chip_smoke.py, imports jax or
    pqa2_tpu (the port keeps its own copies of what it needs);
  * a kernel wrapper given a tensor that is neither on the CPU (plain
    version) nor on a CUDA device raises, without computing on the CPU;
  * asking for CUDA on a machine without a card raises (no CPU fallback),
    the desktop window's runs on the card fail through its tabs' error
    slots, and chip_smoke.py exits non-zero and prints no result there, as
    it does in a directory without the repository.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.io.y4m import write_y4m

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "pqa2_tpu_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__main__.py")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_without_jax():
    # The window's modules import PyQt5, absent here: the functional stub
    # stands in for it (tests/support/qt_stub.py).
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'tests' / 'support')!r})\n"
            "import qt_stub\n"
            "qt_stub.install()\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k in ('jax', 'pqa2_tpu')\n"
            "             or k.startswith(('jax.', 'pqa2_tpu.')))\n"
            "assert not bad, bad\n"
            "assert 'pqa2_tpu_torch.golden.vif' in sys.modules\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(MODULES) >= 20
    # The service, batch and capture modules are reached by both scans.
    assert {f"pqa2_tpu_torch.{m}" for m in (
        "analyzer", "ops.colorspace", "pipeline.batch", "app.service", "app.results_store",
        "app.utils", "app.capture", "app.devices", "io.repair", "ui.main_window",
        "main")} <= set(MODULES)


def _imports_forbidden(stmt: str) -> bool:
    """``import jax``/``from jax...`` or ``import pqa2_tpu``/``from
    pqa2_tpu...`` (pqa2_tpu_torch starts with the same letters)."""
    for kw in ("import ", "from "):
        if stmt.startswith(kw):
            mod = stmt[len(kw):].split()[0].split(",")[0]
            top = mod.split(".")[0]
            return top in ("jax", "pqa2_tpu")
    return False


def test_no_jax_import_in_sources():
    assert _imports_forbidden("from pqa2_tpu.golden import vif")
    assert _imports_forbidden("import pqa2_tpu")
    assert _imports_forbidden("import jax.numpy as jnp")
    assert not _imports_forbidden("from pqa2_tpu_torch.golden import vif")
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not _imports_forbidden(s), (p, s)


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper", ["vif_int_scale", "adm_int_level", "ssim_sse_plane"])
def test_wrappers_refuse_other_devices(wrapper, monkeypatch):
    """Each case covers one integer-family wrapper and a float-family one:
    the VIF wrappers, the ADM wrappers, SSIM and the motion SAD. (Three
    cases, not six: the file keeps its number of tests, by which
    pytest-xdist's ``--dist loadfile`` orders the files it hands out.)"""
    from pqa2_tpu_torch.ops import (
        adm,
        adm_int,
        cuda_adm,
        cuda_adm_int,
        cuda_motion,
        cuda_ssim,
        cuda_vif,
        cuda_vif_int,
        motion,
        ssim,
        vif,
        vif_int,
    )

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cuda_vif_int, "vif_int_scale_plain", forbidden)
    monkeypatch.setattr(cuda_adm_int, "adm_level_plain", forbidden)
    monkeypatch.setattr(cuda_ssim, "ssim_sse_plane_plain", forbidden)
    monkeypatch.setattr(cuda_vif, "vif_scale_plain", forbidden)
    monkeypatch.setattr(cuda_adm, "adm_level_plain_float", forbidden)
    monkeypatch.setattr(cuda_motion, "motion_sad_plain", forbidden)
    assert vif_int.vif_int_scale_plain is not forbidden
    assert adm_int.adm_level_plain is not forbidden and ssim.ssim_sse_plane_plain
    assert vif.vif_scale_plain is not forbidden and adm.adm_level_plain_float
    assert motion.motion_sad_plain is not forbidden
    f32 = dict(dtype=torch.float32)
    calls = {
        "vif_int_scale": [
            lambda: cuda_vif_int.vif_int_scale(_meta(2, 32, 32), _meta(2, 32, 32), scale=0,
                                               in_q=0, gain_limit=float("inf"),
                                               decimate=True),
            lambda: cuda_vif.vif_scale(_meta(2, 32, 32, **f32), _meta(2, 32, 32, **f32),
                                       scale=0, emit_next=True)],
        "adm_int_level": [
            lambda: cuda_adm_int.adm_int_level(_meta(2, 32, 32), _meta(2, 32, 32), level=0,
                                               extra_row_shift=0, gain_limit=100.0),
            lambda: cuda_adm.adm_level(_meta(2, 32, 32, **f32), _meta(2, 32, 32, **f32),
                                       level=0)],
        "ssim_sse_plane": [
            lambda: cuda_ssim.ssim_sse_plane(_meta(2, 32, 32, **f32), _meta(2, 32, 32, **f32)),
            lambda: cuda_motion.motion_sad(_meta(2, 32, 32, **f32))],
    }
    for call in calls[wrapper]:
        with pytest.raises(ValueError, match="CUDA"):
            call()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


@pytest.mark.parametrize("entry", ["require_cuda", "library", "log2_audit",
                                   "stream_score", "analyzer"])
def test_cuda_requests_raise_without_a_card(entry, tmp_path):
    _no_card()
    from pqa2_tpu_torch import _build
    from pqa2_tpu_torch._device import require_cuda
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.ops.cuda_vif_int import log2_table_audit
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    clip = str(tmp_path / "tiny.y4m")
    y = np.full((32, 32), 128, np.uint8)
    c = np.full((16, 16), 128, np.uint8)
    write_y4m(clip, [{"y": y, "u": c, "v": c}] * 2)
    if entry == "analyzer":
        failed = []
        a = VMAFAnalyzer(device="cuda")
        a.analysis_failed.connect(failed.append)
        assert a.analyze_videos(clip, clip) is None
        assert failed and "torch.cuda.is_available() is False" in failed[0]
        assert a.last_scores is None
        _window_analysis_without_a_card(clip, tmp_path)
        return
    fn = {"require_cuda": lambda: require_cuda("cuda"),
          "library": _build.library,
          "log2_audit": lambda: log2_table_audit("cuda"),
          "stream_score": lambda: stream_score(clip, clip, device="cuda")}[entry]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn()


def _window_analysis_without_a_card(clip, tmp_path):
    """``MainWindow(device="cuda")`` (the default) builds without a card,
    but its Setup and Analysis runs fail through the tabs' error slots
    (the Analysis tab's is the one its workflow's analysis_failed feeds),
    with the analyzer's message, and nothing is scored on the CPU. In a
    child under the PyQt5 stub (tests/support/qt_stub.py)."""
    code = f"""
import glob, os, sys
sys.path.insert(0, {str(ROOT / 'tests' / 'support')!r})
import qt_stub
qt_stub.install()
from pqa2_tpu_torch.app import CaptureManager, FileManager, OptionsManager
from pqa2_tpu_torch.ui.main_window import MainWindow
om = OptionsManager("settings.json", save_debounce_s=0)
win = MainWindow(CaptureManager(options_manager=om), FileManager("results"), om)
assert str(win.device) == "cuda"
win.setup_tab.analyze_reference({clip!r})
assert win.setup_tab._thread is None and win.reference_info is None
win.reference_info = {{"path": {clip!r}}}
win.handle_capture_finished(True, {clip!r})
win.analysis_tab.run_combined_analysis()
log = win.analysis_tab.log_pane.toPlainText().splitlines()
assert log[-1].startswith("ERROR: VMAF analysis error: "), log
assert "torch.cuda.is_available() is False" in log[-1], log
assert win.analysis_tab._workflow_thread is None and win.analysis_tab.run_btn.isEnabled()
assert win.results_tab.current_results is None
assert not glob.glob("**/*_vmaf.json", recursive=True)
win.close()
print("window refused")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "window refused" in out.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    _no_card()
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    env = _env()
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
