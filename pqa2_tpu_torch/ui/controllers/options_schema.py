# Port of pqa2_tpu/ui/controllers/options_schema.py: the same fields (keys,
# kinds, bounds, tabs), so a settings file written by either package binds in
# the other; the labels of the ``tpu`` category say what the port does with it.
"""Schema-driven options binding: settings tree <-> editor widgets.

The reference OptionsTab (app/ui/tabs/options_tab.py, ~1.6 kLoC) hand-rolls
a widget + load line + save line per setting. Here the binding is one
declarative FIELDS table; load/save are generic and Qt-free (tested in
test_ui_controllers.py), and the Qt tab just renders the schema. Adding a
setting to the UI is one line.

Field kinds: "str", "int", "float", "bool", "choice" (fixed list),
"slider" (int with range), "model" (VMAF model choice, resolved from the
registry at render time), "dir" / "file" (str paths rendered with a
Browse... picker, reference options_tab.py:1366-1431).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

Key = Tuple[str, str]  # (category, key)


@dataclasses.dataclass(frozen=True)
class Field:
    category: str
    key: str
    label: str
    kind: str  # str | int | float | bool | choice | slider | model | dir | file
    tab: str
    choices: Optional[Sequence] = None
    lo: Optional[float] = None
    hi: Optional[float] = None
    step: Optional[float] = None


# Coverage of the reference options surface (options_tab.py sub-tabs
# :79-623) plus the TPU category. Keys match app/options_manager.py's
# default tree exactly — load/save fail a test if one drifts.
FIELDS: List[Field] = [
    # -- General (paths + encoder, :79-193) --------------------------------
    Field("paths", "default_output_dir", "Output directory", "dir", "General"),
    Field("paths", "results_dir", "Results directory", "dir", "General"),
    Field("paths", "temp_dir", "Temp directory", "dir", "General"),
    Field("paths", "reference_video_dir", "Reference video directory", "dir",
          "General"),
    Field("paths", "ffmpeg_path", "ffmpeg binary (capture/ingest fallback)",
          "file", "General"),
    Field("encoder", "default_encoder", "Default encoder", "choice", "General",
          choices=["libx264", "libx265", "rawvideo"]),
    Field("encoder", "default_crf", "Default CRF", "int", "General",
          lo=0, hi=51),
    Field("encoder", "default_preset", "Encoder preset", "choice", "General",
          choices=["ultrafast", "superfast", "veryfast", "faster", "fast",
                   "medium", "slow", "slower", "veryslow"]),
    # -- Capture (:194-344) -------------------------------------------------
    Field("capture", "default_device", "Default device", "str", "Capture"),
    Field("capture", "resolution", "Resolution", "choice", "Capture",
          choices=["1920x1080", "1280x720", "720x576", "720x486"]),
    Field("capture", "frame_rate", "Frame rate", "choice", "Capture",
          choices=[23.98, 24, 25, 29.97, 30, 50, 59.94, 60]),
    Field("capture", "pixel_format", "Pixel format", "choice", "Capture",
          choices=["uyvy422", "yuv420p", "yuyv422"]),
    Field("capture", "video_input", "Video input", "choice", "Capture",
          choices=["hdmi", "sdi", "component", "composite"]),
    Field("capture", "audio_input", "Audio input", "choice", "Capture",
          choices=["embedded", "analog", "none"]),
    Field("capture", "encoder", "Capture encoder", "choice", "Capture",
          choices=["libx264", "libx265", "rawvideo"]),
    Field("capture", "crf", "Capture CRF", "int", "Capture", lo=0, hi=51),
    Field("capture", "preset", "Capture preset", "choice", "Capture",
          choices=["ultrafast", "superfast", "veryfast", "faster", "fast",
                   "medium", "slow"]),
    Field("capture", "format_code", "DeckLink format code", "str", "Capture"),
    Field("capture", "disable_audio", "Disable audio", "bool", "Capture"),
    Field("capture", "low_latency", "Low latency mode", "bool", "Capture"),
    Field("capture", "retry_attempts", "Retry attempts", "int", "Capture",
          lo=0, hi=10),
    Field("capture", "retry_delay", "Retry delay (s)", "int", "Capture",
          lo=0, hi=60),
    # -- Analysis (VMAF knobs, :345-469) ------------------------------------
    Field("vmaf", "default_model", "Default model", "model", "Analysis"),
    Field("vmaf", "pool_method", "Pool method", "choice", "Analysis",
          choices=["mean", "min", "max", "harmonic_mean"]),
    Field("vmaf", "feature_subsample", "Feature subsample (n_subsample)",
          "int", "Analysis", lo=1, hi=10),
    Field("vmaf", "feature_precision", "Feature precision", "choice",
          "Analysis", choices=["auto", "integer", "integer_fast", "float"]),
    Field("vmaf", "psnr_enabled", "Compute PSNR", "bool", "Analysis"),
    Field("vmaf", "ssim_enabled", "Compute SSIM", "bool", "Analysis"),
    Field("vmaf", "save_json", "Save JSON results", "bool", "Analysis"),
    Field("vmaf", "save_plots", "Save plots", "bool", "Analysis"),
    Field("analysis", "auto_alignment", "Auto alignment", "bool", "Analysis"),
    Field("analysis", "use_temp_files", "Use temp files", "bool", "Analysis"),
    # -- Advanced (bookend knobs, :471-623) ---------------------------------
    Field("bookend", "min_loops", "Min loops", "int", "Advanced", lo=1, hi=20),
    Field("bookend", "max_loops", "Max loops", "int", "Advanced", lo=1, hi=50),
    Field("bookend", "min_capture_time", "Min capture time (s)", "int",
          "Advanced", lo=1, hi=120),
    Field("bookend", "max_capture_time", "Max capture time (s)", "int",
          "Advanced", lo=1, hi=600),
    Field("bookend", "bookend_duration", "Bookend duration (s)", "float",
          "Advanced", lo=0.1, hi=2.0, step=0.1),
    Field("bookend", "white_threshold", "White threshold", "slider",
          "Advanced", lo=160, hi=250),
    Field("bookend", "frame_sampling_rate", "Frame sampling rate", "int",
          "Advanced", lo=1, hi=30),
    Field("bookend", "frame_offset", "Frame offset", "int", "Advanced",
          lo=-10, hi=10),
    Field("bookend", "adaptive_brightness", "Adaptive brightness", "bool",
          "Advanced"),
    Field("bookend", "motion_compensation", "Motion compensation", "bool",
          "Advanced"),
    Field("bookend", "fallback_to_full_video", "Fallback to full video",
          "bool", "Advanced"),
    Field("debug", "log_level", "Log level", "choice", "Advanced",
          choices=["DEBUG", "INFO", "WARNING", "ERROR"]),
    Field("debug", "save_logs", "Save logs", "bool", "Advanced"),
    Field("debug", "show_commands", "Show commands", "bool", "Advanced"),
    Field("branding", "selected_theme", "Theme", "choice", "Advanced",
          choices=["System", "Light", "Dark"]),
    # -- the "tpu" settings category (framework additions; the tab keeps the
    # category's name so both packages share one settings file) ------------
    Field("tpu", "chunk_size", "Chunk size (frames per card batch)", "int",
          "TPU", lo=1, hi=256),
    Field("tpu", "mesh_data", "Mesh data axis (0=auto)", "int", "TPU",
          lo=0, hi=4096),
    Field("tpu", "mesh_space", "Mesh space axis", "int", "TPU", lo=1, hi=64),
    Field("tpu", "profile_dir", "torch.profiler trace dir", "dir", "TPU"),
]

TABS = ("General", "Capture", "Analysis", "Advanced", "TPU")


def fields_for_tab(tab: str) -> List[Field]:
    return [f for f in FIELDS if f.tab == tab]


def load_values(options_manager) -> Dict[Key, Any]:
    """Settings tree -> {(category, key): value} for every schema field."""
    out: Dict[Key, Any] = {}
    for f in FIELDS:
        out[(f.category, f.key)] = options_manager.get_setting(f.category, f.key)
    return out


def save_values(options_manager, values: Dict[Key, Any]) -> None:
    """{(category, key): value} -> one update_category call per category
    (single change-signal emission per category, like the reference)."""
    by_cat: Dict[str, Dict[str, Any]] = {}
    for (cat, key), v in values.items():
        by_cat.setdefault(cat, {})[key] = v
    for cat, kv in by_cat.items():
        options_manager.update_category(cat, kv)


def coerce(field: Field, raw: Any) -> Any:
    """Widget value -> settings value with the field's declared type."""
    if field.kind in ("int", "slider"):
        return int(raw)
    if field.kind == "float":
        return float(raw)
    if field.kind == "bool":
        return bool(raw)
    if field.kind == "choice" and field.choices and not isinstance(
            field.choices[0], str):
        try:
            return type(field.choices[0])(float(raw))
        except (TypeError, ValueError):
            return raw
    return raw
