# Copy of pqa2_tpu/app/options_manager.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu. The device-discovery
# methods (get_decklink_devices, get_decklink_formats, test_device_connection,
# get_ffmpeg_path) are left out: they call app/devices.py, the capture backends,
# which the port does not have.
"""Settings store.

Rebuild of the reference OptionsManager (app/options_manager.py): the same
hierarchical JSON settings file, category/key getters with default fallback,
recursive backfill of new keys into old files, debounced save, and a
``settings_updated`` broadcast signal. Device-discovery probing
(decklink/DirectShow) is delegated to the capture backend; this class owns
only configuration.

New: a ``tpu`` category (mesh shape, precision, chunk size) — the knobs the
JAX pipeline adds over the ffmpeg one.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
from typing import Any, Dict, Optional

from pqa2_tpu_torch.utils.signals import Signal

logger = logging.getLogger(__name__)


def default_settings() -> Dict[str, Dict[str, Any]]:
    """Full default tree, mirroring app/options_manager.py:39-139 plus the
    TPU category."""
    return {
        "bookend": {
            "min_loops": 3,
            "max_loops": 10,
            "min_capture_time": 5,
            "max_capture_time": 30,
            "bookend_duration": 0.2,
            "white_threshold": 200,
            "frame_sampling_rate": 5,
            "min_frame_sampling_rate": 1,
            "max_frame_sampling_rate": 30,
            "frame_offset": 3,
            "adaptive_brightness": True,
            "motion_compensation": False,
            "fallback_to_full_video": True,
        },
        "vmaf": {
            "default_model": "vmaf_v0.6.1",
            "available_models": ["vmaf_v0.6.1", "vmaf_4k_v0.6.1", "vmaf_b_v0.6.3"],
            "subsample": 1,
            "threads": 0,
            "output_format": "json",
            "save_json": True,
            "save_plots": True,
            "pool_method": "mean",
            "feature_subsample": 1,
            # auto = follow the model's extractor family (integer models ->
            # fixed-point path); float / integer force one.
            "feature_precision": "auto",
            "enable_motion_score": False,
            "enable_temporal_features": False,
            "psnr_enabled": True,
            "ssim_enabled": True,
            "tester_name": "",
            "test_location": "",
        },
        "capture": {
            "default_device": "Intensity Shuttle",
            "resolution": "1920x1080",
            "frame_rate": 29.97,
            "pixel_format": "uyvy422",
            "available_resolutions": ["1920x1080", "1280x720", "720x576", "720x486"],
            "available_frame_rates": [23.98, 24, 25, 29.97, 30, 50, 59.94, 60],
            "video_input": "hdmi",
            "audio_input": "embedded",
            "encoder": "libx264",
            "crf": 18,
            "preset": "fast",
            "disable_audio": False,
            "low_latency": True,
            "force_format": False,
            "format_code": "Hp29",
            "width": 1920,
            "height": 1080,
            "scan_type": "p",
            "is_interlaced": False,
            "retry_attempts": 3,
            "retry_delay": 3,
            "recovery_timeout": 10,
        },
        "analysis": {
            "use_temp_files": True,
            "auto_alignment": True,
            "alignment_method": "Bookend Detection",
        },
        "encoder": {
            "default_encoder": "libx264",
            "default_crf": 23,
            "default_preset": "medium",
        },
        "paths": {
            "default_output_dir": "",
            "reference_video_dir": "",
            "results_dir": "",
            "temp_dir": "",
            "models_dir": "",
            "ffmpeg_path": "",
        },
        "debug": {
            "log_level": "INFO",
            "save_logs": True,
            "show_commands": True,
            "suppress_ffmpeg_dialogs": True,
        },
        "branding": {
            "app_name": "VMAF Test App",
            "company_name": "Chroma",
            "enable_white_label": False,
            "footer_text": "© 2025 Chroma",
            "primary_color": "#4CAF50",
            "selected_theme": "System",
            "bg_color": "#2D2D30",
            "text_color": "#FFFFFF",
            "accent_color": "#007ACC",
            "logo_path": "",
        },
        # TPU-native additions (not in the reference).
        "tpu": {
            "mesh_data": 0,  # 0 = all visible devices
            "mesh_space": 1,
            "chunk_size": 32,
            "precision": "float32",
            "profile_dir": "",
        },
    }


class OptionsManager:
    """JSON-backed settings with change signal and debounce."""

    def __init__(self, settings_file: Optional[str] = None, save_debounce_s: float = 1.0):
        self.settings_updated = Signal(dict, name="settings_updated")
        if settings_file is None:
            settings_file = os.path.join(os.getcwd(), "config", "settings.json")
        self.settings_file = settings_file
        self.default_settings = default_settings()
        self.settings: Dict[str, Dict[str, Any]] = {}
        self._save_debounce_s = save_debounce_s
        self._save_timer: Optional[threading.Timer] = None
        self._lock = threading.RLock()
        self.load_settings()

    # -- persistence --------------------------------------------------------

    def load_settings(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            if os.path.exists(self.settings_file):
                try:
                    with open(self.settings_file) as f:
                        self.settings = json.load(f)
                    self._backfill(self.settings, self.default_settings)
                except (json.JSONDecodeError, OSError) as e:
                    logger.error("failed to load settings (%s); using defaults", e)
                    self.settings = copy.deepcopy(self.default_settings)
            else:
                self.settings = copy.deepcopy(self.default_settings)
                self._write()
            configured = (self.settings.get("paths") or {}).get("ffmpeg_path")
            if configured:
                from pqa2_tpu_torch.io import ffmpeg_pipe

                ffmpeg_pipe.configure(ffmpeg_path=configured)
            return self.settings

    def _backfill(self, dst: Dict, src: Dict) -> bool:
        """Recursively add keys that newer versions introduced
        (app/options_manager.py:176-194)."""
        changed = False
        for key, val in src.items():
            if key not in dst:
                dst[key] = copy.deepcopy(val)
                changed = True
            elif isinstance(val, dict) and isinstance(dst[key], dict):
                changed |= self._backfill(dst[key], val)
        return changed

    def _write(self) -> None:
        os.makedirs(os.path.dirname(self.settings_file) or ".", exist_ok=True)
        tmp = self.settings_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.settings, f, indent=4)
        os.replace(tmp, self.settings_file)

    def save_settings(self, immediate: bool = False) -> None:
        """Debounced save (app/options_manager.py:196-221)."""
        with self._lock:
            if self._save_timer is not None:
                self._save_timer.cancel()
                self._save_timer = None
            if immediate or self._save_debounce_s <= 0:
                self._write()
            else:
                self._save_timer = threading.Timer(self._save_debounce_s, self._write)
                self._save_timer.daemon = True
                self._save_timer.start()

    def flush(self) -> None:
        self.save_settings(immediate=True)

    # -- accessors ----------------------------------------------------------

    def get_setting(self, category: str, key: Optional[str] = None, default=None):
        with self._lock:
            cat = self.settings.get(category)
            if cat is None:
                cat = self.default_settings.get(category, {})
            if key is None:
                return copy.deepcopy(cat)
            if key in cat:
                return cat[key]
            if default is not None:
                return default
            return self.default_settings.get(category, {}).get(key)

    def update_setting(self, category: str, key: str, value) -> None:
        with self._lock:
            self.settings.setdefault(category, {})[key] = value
        self.save_settings()
        self.settings_updated.emit(self.get_settings())

    def update_category(self, category: str, values: Dict) -> None:
        with self._lock:
            self.settings.setdefault(category, {}).update(values)
        self.save_settings()
        self.settings_updated.emit(self.get_settings())

    def get_settings(self) -> Dict:
        with self._lock:
            return copy.deepcopy(self.settings)

    def set_settings(self, settings: Dict) -> None:
        with self._lock:
            self.settings = copy.deepcopy(settings)
            self._backfill(self.settings, self.default_settings)
        self.save_settings()
        self.settings_updated.emit(self.get_settings())

    def reset_to_defaults(self) -> None:
        with self._lock:
            self.settings = copy.deepcopy(self.default_settings)
        self.save_settings(immediate=True)
        self.settings_updated.emit(self.get_settings())
