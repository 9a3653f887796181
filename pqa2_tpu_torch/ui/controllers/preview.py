# Copy of pqa2_tpu/ui/controllers/preview.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Live-preview frame pipeline: validation, RGB conversion, throttling.

Reference behavior: app/ui/tabs/capture_tab.py:449-530 — every incoming
frame is validated (None/empty/unknown layout -> a placeholder message),
converted to RGB for display, and counted. The model here owns all of
that plus a render throttle (the reference renders every frame; a 30 fps
DeckLink feed into a Qt label wastes most of that work), leaving the Qt
side a bare "set pixmap from this RGB array" call.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

Frame = Union[np.ndarray, Dict[str, np.ndarray], None]


def to_rgb(frame: Frame,
           bit_depth: Optional[int] = None) -> Tuple[Optional[np.ndarray], str]:
    """Normalise any frame the engine emits to (H, W, 3) uint8 RGB.

    Returns (rgb_or_None, status). Accepted inputs: grayscale (H, W),
    BGR (H, W, 3) — cv2 capture order — or a planar y/u/v dict (engine
    previews emit luma dicts). None when the frame can't be displayed,
    with the placeholder message the pane should show.

    ``bit_depth``: source depth for uint16 frames (10-bit y4m delivers
    code values 0..1023, not 0..65535 — a blind >> 8 would render black).
    Unknown uint16 depth falls back to inferring from the data range.
    """
    if frame is None:
        return None, "No video feed received"
    if isinstance(frame, dict):
        y = frame.get("y")
        if y is None or getattr(y, "size", 0) == 0:
            return None, "Empty video frame received"
        return to_rgb(np.asarray(y), bit_depth=bit_depth)
    if not isinstance(frame, np.ndarray):
        return None, f"Invalid frame format ({type(frame).__name__})"
    if frame.size == 0:
        return None, "Empty video frame received"
    if frame.dtype != np.uint8:
        # >8-bit luma scales down for display; floats clip to [0, 255].
        if frame.dtype == np.uint16:
            depth = bit_depth
            if depth is None:
                peak = int(frame.max())
                depth = 10 if peak < 1024 else (12 if peak < 4096 else 16)
            frame = (frame >> max(depth - 8, 0)).astype(np.uint8)
        else:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
    if frame.ndim == 2:
        return np.repeat(frame[:, :, None], 3, axis=2), "ok"
    if frame.ndim == 3 and frame.shape[2] == 3:
        return frame[:, :, ::-1].copy(), "ok"  # BGR -> RGB
    return None, f"Unsupported frame format: {frame.shape}"


class PreviewModel:
    """Frame counter + render throttle for the preview pane."""

    def __init__(self, max_render_fps: float = 15.0,
                 clock=time.monotonic):
        self.max_render_fps = float(max_render_fps)
        self._clock = clock
        self._last_render = -1e9
        self.frames_received = 0
        self.frames_rendered = 0
        self.last_status = "No video feed received"

    def submit(self, frame: Frame) -> Optional[np.ndarray]:
        """Process one incoming frame; returns RGB to render or None
        (throttled or invalid — check last_status)."""
        self.frames_received += 1
        now = self._clock()
        min_dt = 1.0 / self.max_render_fps if self.max_render_fps > 0 else 0.0
        if now - self._last_render < min_dt:
            return None  # throttled; status unchanged
        rgb, status = to_rgb(frame)
        self.last_status = status
        if rgb is None:
            return None
        self._last_render = now
        self.frames_rendered += 1
        return rgb

    @property
    def counter_text(self) -> str:
        return f"Frame: {self.frames_received:,}"
