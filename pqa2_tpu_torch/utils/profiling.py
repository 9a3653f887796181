# Copy of pqa2_tpu/utils/profiling.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Progress metering.

The reference's observability is log-scraped ffmpeg progress
(SURVEY.md section 5.1). Here: a throughput meter that feeds the same
per-frame progress signal contract the UI expects. (The JAX package's
``trace`` context, a jax.profiler capture, has no counterpart: the port is
profiled with torch.profiler, see chip_smoke.py --profile.)
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class ThroughputMeter:
    """Frames/sec counter emitting throttled progress callbacks.

    Mirrors the reference's 0.25-0.5 s UI update throttle on ffmpeg
    stderr parsing (app/vmaf_analyzer.py:485-489)."""

    def __init__(self, total_frames: int,
                 progress_cb: Optional[Callable[[int], None]] = None,
                 status_cb: Optional[Callable[[str], None]] = None,
                 min_interval_s: float = 0.25):
        self.total = max(total_frames, 1)
        self.done = 0
        self._progress_cb = progress_cb
        self._status_cb = status_cb
        self._min_interval = min_interval_s
        self._t0 = time.perf_counter()
        self._last_emit = 0.0

    def add(self, frames: int) -> None:
        self.done += frames
        now = time.perf_counter()
        if now - self._last_emit < self._min_interval and self.done < self.total:
            return
        self._last_emit = now
        if self._progress_cb:
            self._progress_cb(min(int(100 * self.done / self.total), 100))
        if self._status_cb:
            fps = self.done / max(now - self._t0, 1e-9)
            self._status_cb(
                f"frame={self.done}/{self.total} fps={fps:.1f}"
            )

    @property
    def fps(self) -> float:
        return self.done / max(time.perf_counter() - self._t0, 1e-9)
