# Copy of pqa2_tpu/app/devices.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Capture-device discovery.

Rebuild of the reference OptionsManager's probing layer
(app/options_manager.py:304-887): DeckLink device enumeration via
``ffmpeg -f decklink -list_devices``, per-device format enumeration via
``-list_formats``, a connection probe, and the hardcoded Intensity Shuttle
format table as the hardware-free fallback — which is also what lets every
downstream feature run in environments without a card or ffmpeg.
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

PROBE_TIMEOUT_S = 10

# Standard DeckLink format codes (capture.py:662-673 mapping).
FORMAT_CODE_MAP = {
    "23ps": ("1920x1080", 23.98, "p"),
    "24ps": ("1920x1080", 24, "p"),
    "Hp25": ("1920x1080", 25, "p"),
    "Hp29": ("1920x1080", 29.97, "p"),
    "Hp30": ("1920x1080", 30, "p"),
    "Hi50": ("1920x1080", 25, "i"),
    "Hi59": ("1920x1080", 29.97, "i"),
    "hp50": ("1280x720", 50, "p"),
    "hp59": ("1280x720", 59.94, "p"),
    "hp60": ("1280x720", 60, "p"),
    "pal": ("720x576", 25, "i"),
    "ntsc": ("720x480", 29.97, "i"),
}


def ffmpeg_path() -> Optional[str]:
    """ffmpeg discovery (app/options_manager.py:656-712), PATH-based."""
    return shutil.which("ffmpeg")


def _run(cmd: List[str], timeout: float = PROBE_TIMEOUT_S):
    return subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, check=False
    )


def get_decklink_devices() -> List[str]:
    """Enumerate DeckLink devices; fallback list when probing fails
    (app/options_manager.py:304-382)."""
    exe = ffmpeg_path()
    if exe:
        try:
            r = _run([exe, "-hide_banner", "-f", "decklink",
                      "-list_devices", "1", "-i", "dummy"])
            devices = re.findall(r"\[decklink[^\]]*\]\s+'([^']+)'",
                                 r.stderr or "")
            if devices:
                return devices
        except (subprocess.SubprocessError, OSError) as e:
            logger.warning("decklink device probe failed: %s", e)
    # Reference fallback device list (:367-370).
    return ["Intensity Shuttle", "UltraStudio", "DeckLink"]


def get_decklink_formats(device_name: str) -> Dict[str, Any]:
    """Per-device format list; Intensity Shuttle table as fallback
    (app/options_manager.py:384-887)."""
    exe = ffmpeg_path()
    if exe:
        try:
            r = _run([exe, "-hide_banner", "-f", "decklink",
                      "-list_formats", "1", "-i", device_name])
            formats = []
            for m in re.finditer(
                r"^\s*(\S+)\s+(\d+)x(\d+) at (\d+)/(\d+) fps(?:\s+\((\w+)\))?",
                r.stderr or "", re.M,
            ):
                code, w, h, num, den, scan = m.groups()
                fps = round(int(num) / int(den), 2)
                formats.append({
                    "id": code,
                    "resolution": f"{w}x{h}",
                    "frame_rate": fps,
                    "scan_type": (scan or "p")[0],
                    "display": f"{w}x{h} @ {fps} fps ({(scan or 'p')[0]})",
                })
            if formats:
                return {"formats": formats, "source": "probe"}
        except (subprocess.SubprocessError, OSError) as e:
            logger.warning("decklink format probe failed: %s", e)
    return get_default_intensity_shuttle_formats()


def get_default_intensity_shuttle_formats() -> Dict[str, Any]:
    """Hardware-free fallback table (app/options_manager.py:889-937)."""
    formats = [
        {
            "id": code,
            "resolution": res,
            "frame_rate": rate,
            "scan_type": scan,
            "display": f"{res} @ {rate} fps ({scan})",
        }
        for code, (res, rate, scan) in FORMAT_CODE_MAP.items()
    ]
    format_map: Dict[str, List[float]] = {}
    for f in formats:
        if f["scan_type"] == "p":
            format_map.setdefault(f["resolution"], []).append(f["frame_rate"])
    return {"formats": formats, "format_map": format_map, "source": "fallback"}


def map_format_code(code: str) -> Optional[Dict[str, Any]]:
    """Format code -> properties (app/capture.py:662-673)."""
    entry = FORMAT_CODE_MAP.get(code)
    if entry is None:
        return None
    res, rate, scan = entry
    w, h = res.split("x")
    return {
        "format_code": code,
        "width": int(w),
        "height": int(h),
        "frame_rate": rate,
        "scan_type": scan,
        "is_interlaced": scan == "i",
    }


def test_device_connection(device_name: str) -> Dict[str, Any]:
    """Health check: format probe then a 0.1 s capture probe
    (app/options_manager.py:804-887)."""
    exe = ffmpeg_path()
    if not exe:
        return {"connected": False, "reason": "ffmpeg not found",
                "device": device_name}
    try:
        r = _run([exe, "-hide_banner", "-f", "decklink",
                  "-list_formats", "1", "-i", device_name])
        if "decklink" not in (r.stderr or ""):
            return {"connected": False, "reason": "device not recognised",
                    "device": device_name}
        probe = _run([exe, "-hide_banner", "-f", "decklink", "-t", "0.1",
                      "-i", device_name, "-f", "null", "-"], timeout=15)
        return {"connected": probe.returncode == 0,
                "reason": "" if probe.returncode == 0
                else (probe.stderr or "")[-200:],
                "device": device_name}
    except (subprocess.SubprocessError, OSError) as e:
        return {"connected": False, "reason": str(e), "device": device_name}
