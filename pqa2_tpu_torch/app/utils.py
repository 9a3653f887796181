"""File management + app-state validation (port of pqa2_tpu/app/utils.py).

``FileManager`` (tracked temp workspace, per-test result directory policy
``<base>/<test>_<ts>/``) and ``run_unit_tests`` are the JAX module's;
``probe_video`` (also as ``get_video_info``) is re-exported from the port's
``io/video.py``. ``validate_application_state`` checks for the card where
the JAX module asks JAX for its devices.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional

from pqa2_tpu_torch.io.video import probe_video  # re-export: reference get_video_info
get_video_info = probe_video

logger = logging.getLogger(__name__)


class FileManager:
    """Temp workspace + output path policy (app/utils.py:106-319)."""

    def __init__(self, base_dir: Optional[str] = None):
        self._temp_dirs: List[str] = []
        self.base_dir = base_dir or os.path.join(os.getcwd(), "results")
        self.temp_dir = tempfile.mkdtemp(prefix="vmaf_app_")
        self._temp_dirs.append(self.temp_dir)

    def get_temp_dir(self) -> str:
        return self.temp_dir

    def get_temp_path(self, filename: str) -> str:
        return os.path.join(self.temp_dir, filename)

    def new_temp_dir(self, prefix: str = "vmaf_work_") -> str:
        d = tempfile.mkdtemp(prefix=prefix)
        self._temp_dirs.append(d)
        return d

    def get_default_base_dir(self) -> str:
        return self.base_dir

    def get_test_dir(self, test_name: str, timestamp: Optional[str] = None) -> str:
        """``<base>/<test>_<timestamp>/`` per-test result directory
        (app/utils.py:278-319)."""
        safe = re.sub(r"[^\w\-]+", "_", test_name).strip("_") or "Test"
        ts = timestamp or _dt.datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.base_dir, f"{safe}_{ts}")
        os.makedirs(path, exist_ok=True)
        return path

    def get_output_path(
        self, test_name: str, filename: str, timestamp: Optional[str] = None
    ) -> str:
        return os.path.join(self.get_test_dir(test_name, timestamp), filename)

    def cleanup_temp_files(self) -> None:
        for d in self._temp_dirs:
            shutil.rmtree(d, ignore_errors=True)
        self._temp_dirs.clear()

    def __del__(self):  # best-effort, mirrors the reference teardown
        try:
            self.cleanup_temp_files()
        except Exception:
            pass


def run_unit_tests(test_dir: str = "tests", extra_args=None) -> int:
    """pytest wrapper (app/utils.py:322-353 parity); returns the exit code."""
    import subprocess
    import sys

    cmd = [sys.executable, "-m", "pytest", test_dir, "-q"]
    if extra_args:
        cmd += list(extra_args)
    return subprocess.run(cmd).returncode


def validate_application_state(
    options_manager=None, file_manager=None
) -> Dict[str, bool]:
    """Runtime self-check (app/utils.py:355-454): managers constructible,
    temp files writable, settings loadable, models present, and a card the
    kernels are built for. That last key is ``cuda_devices`` (the JAX
    module's ``jax_devices``), the one key that differs: it is True only
    where ``_device.require_cuda`` accepts the card."""
    checks: Dict[str, bool] = {}
    from pqa2_tpu_torch.models.registry import available_models

    checks["models_available"] = len(available_models()) >= 3
    try:
        fm = file_manager or FileManager()
        probe = fm.get_temp_path("state_check.tmp")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        checks["temp_writable"] = True
    except OSError:
        checks["temp_writable"] = False
    try:
        om = options_manager
        if om is None:
            from pqa2_tpu_torch.app.options_manager import OptionsManager

            om = OptionsManager(settings_file=os.path.join(
                tempfile.gettempdir(), "pqa2_state_check_settings.json"))
        checks["settings_loadable"] = bool(om.get_setting("vmaf", "default_model"))
    except Exception:
        checks["settings_loadable"] = False
    try:
        from pqa2_tpu_torch._device import require_cuda

        require_cuda("cuda")
        checks["cuda_devices"] = True
    except (RuntimeError, ValueError):
        checks["cuda_devices"] = False
    checks["all_ok"] = all(checks.values())
    return checks
