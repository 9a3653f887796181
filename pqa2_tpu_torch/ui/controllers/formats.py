# Copy of pqa2_tpu/ui/controllers/formats.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Per-device capture-format detection flow (Qt-free).

The reference's OptionsTab embeds an interactive per-device format
enumeration UI (app/ui/tabs/options_tab.py:625-970: pick a device, press
Detect, see the mode list, apply one). The probing backend lives in
app/devices.py; this controller is the glue the Qt layer renders: detect
formats for the currently-selected device, format the display rows, and
apply a chosen mode to the capture settings tree.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from pqa2_tpu_torch.app import devices

logger = logging.getLogger(__name__)


def detect_formats(device_name: Optional[str]) -> Tuple[List[Dict[str, Any]], str]:
    """(format rows, source) for a device — probe first, fallback table
    when no hardware/ffmpeg answers (the reference's Intensity Shuttle
    table, app/options_manager.py:889-937)."""
    if not device_name:
        info = devices.get_default_intensity_shuttle_formats()
        return list(info.get("formats") or []), "fallback"
    try:
        info = devices.get_decklink_formats(device_name)
    except Exception as e:  # never let a probe error break the options UI
        logger.error("format detection failed for %r: %s", device_name, e)
        info = devices.get_default_intensity_shuttle_formats()
    return list(info.get("formats") or []), str(info.get("source", "fallback"))


def format_display(fmt: Dict[str, Any]) -> str:
    """One combo row: '<code> — 1920x1080 @ 29.97 fps (p)'."""
    disp = fmt.get("display") or (
        f"{fmt.get('resolution', '?')} @ {fmt.get('frame_rate', '?')} fps "
        f"({fmt.get('scan_type', 'p')})")
    return f"{fmt.get('id', '?')} — {disp}"


def apply_format(options_manager, fmt: Dict[str, Any]) -> Dict[str, Any]:
    """Write a chosen format into the capture settings tree.

    Mirrors the reference apply flow (options_tab.py:920-970): the
    DeckLink format code plus the derived resolution/frame-rate fields the
    capture command builder reads (app/capture.py DeckLinkBackend).
    Returns the key->value dict written (for status display/tests)."""
    code = str(fmt.get("id") or fmt.get("format_code") or "")
    updates = {"format_code": code}
    res = fmt.get("resolution")
    if res:
        updates["resolution"] = str(res)
    rate = fmt.get("frame_rate")
    if rate is not None:
        updates["frame_rate"] = float(rate)
    scan = fmt.get("scan_type")
    if scan:
        updates["scan_type"] = str(scan)
    if options_manager is not None:
        for key, value in updates.items():
            options_manager.update_setting("capture", key, value)
    return updates
