# Copy of pqa2_tpu/ui/controllers/devicestatus.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Capture-device status check flow.

Reference behavior: app/ui/tabs/capture_tab.py:609-689 — populate the
device dropdown (options-manager probe, hardcoded fallback list), restore
the configured default, then test the selected device and drive a
three-state status indicator (green/red/grey with a tooltip).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

# The reference's fallback list of common Blackmagic device names
# (capture_tab.py:622-629) when probing finds nothing.
FALLBACK_DEVICES = [
    "Intensity Shuttle",
    "UltraStudio",
    "DeckLink",
    "Decklink Video Capture",
    "Intensity Pro",
]

# Indicator palette (capture_tab.py:664-689).
STATUS_COLORS = {
    "connected": "#00AA00",
    "unavailable": "#AA0000",
    "unknown": "#808080",
}


@dataclasses.dataclass
class DeviceStatus:
    level: str  # "connected" | "unavailable" | "unknown"
    message: str

    @property
    def color(self) -> str:
        return STATUS_COLORS[self.level]

    @property
    def tooltip(self) -> str:
        if self.level == "connected":
            return f"Capture card status: connected ({self.message})"
        if self.level == "unavailable":
            return f"Capture card status: not connected ({self.message})"
        return self.message


def device_rows(options_manager=None) -> Tuple[List[str], Optional[str]]:
    """(devices_to_list, configured_default_or_None)."""
    devices: List[str] = []
    if options_manager is not None:
        try:
            devices = list(options_manager.get_decklink_devices() or [])
        except Exception as e:
            logger.error("device probe failed: %s", e)
    if not devices:
        devices = list(FALLBACK_DEVICES)
    current = None
    if options_manager is not None:
        try:
            configured = options_manager.get_setting("capture", "default_device")
            if configured in devices:
                current = configured
        except Exception as e:
            logger.error("could not read default_device: %s", e)
    return devices, current


def check_device_status(selected: Optional[str],
                        options_manager=None) -> DeviceStatus:
    """Status-indicator state for the selected device."""
    if not selected:
        return DeviceStatus("unknown", "No capture device selected")
    if options_manager is None:
        return DeviceStatus("unknown", "Capture manager not initialized")
    try:
        if hasattr(options_manager, "test_device_connection"):
            res = options_manager.test_device_connection(selected)
            # app/devices.py returns {"connected", "reason", "device"};
            # a (bool, str) pair is accepted for custom managers. (This
            # unpacking was a 2-tuple before round 3 — the dict made the
            # indicator report a permanent check error, caught by the
            # qt-glue stub test.)
            if isinstance(res, dict):
                available = bool(res.get("connected"))
                message = res.get("reason") or (
                    "Device connected" if available else "Device unavailable")
            else:
                available, message = res
        else:
            available, message = True, "Device check skipped"
    except Exception as e:
        logger.error("device check failed: %s", e)
        return DeviceStatus("unknown", f"Error checking device: {e}")
    if available:
        return DeviceStatus("connected", str(message))
    return DeviceStatus("unavailable", str(message))
