# Copy of pqa2_tpu/ui/controllers/setup.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Setup-tab behaviors: reference summary, preview frame, duration policy.

Reference behavior: app/ui/tabs/setup_tab.py — the reference preview pane
(shared with CaptureTab's _show_reference_preview), the analyzed-info
summary block, and the analysis-duration dropdown semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pqa2_tpu_torch.ui.controllers.preview import to_rgb

DURATION_CHOICES = ["Full duration", "5s", "10s", "30s", "60s"]


def parse_duration(text: str) -> Optional[float]:
    """Dropdown text -> seconds (None = full clip)."""
    text = (text or "").strip()
    if not text or text.lower().startswith("full"):
        return None
    try:
        return float(text.rstrip("sS"))
    except ValueError:
        return None


def reference_summary(info: Dict) -> List[str]:
    """Analyzed reference -> display lines (setup_tab info pane)."""
    fr = info.get("frame_rate") or 0.0
    dur = info.get("duration") or 0.0
    lines = [
        f"Resolution: {info.get('width')}x{info.get('height')}",
        f"Frame rate: {fr:.3f} fps",
        f"Duration: {dur:.2f}s ({info.get('frame_count')} frames)",
        f"Format: {info.get('pix_fmt')} ({info.get('codec')})",
        "White bookends present: "
        + ("yes" if info.get("has_bookends") else "no"),
    ]
    if info.get("bit_depth", 8) > 8:
        lines.insert(3, f"Bit depth: {info['bit_depth']}-bit")
    return lines


def load_preview_rgb(path: str,
                     frame_index: int = 0) -> Tuple[Optional[np.ndarray], str]:
    """First (or n-th) frame of a video as display RGB.

    The setup/capture reference-preview loader (setup_tab preview pane,
    capture_tab.py:_show_reference_preview). Returns (rgb, status); rgb is
    None with a placeholder message when the file can't be decoded."""
    try:
        from pqa2_tpu_torch.io.video import VideoReader

        with VideoReader(path) as r:
            depth = r.info.bit_depth
            frame = None
            for i, fr in enumerate(r):
                frame = fr
                if i >= frame_index:
                    break
        if frame is None:
            return None, "No frames in video"
        return to_rgb(frame, bit_depth=depth)
    except Exception as e:
        return None, f"Preview unavailable: {e}"
