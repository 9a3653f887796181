# Port of pqa2_tpu/utils/profiling.py: ``trace`` runs torch.profiler where the
# JAX module runs jax.profiler; ``ThroughputMeter`` is the JAX module's.
"""Tracing / profiling hooks.

The reference's observability is log-scraped ffmpeg progress
(SURVEY.md section 5.1). Here: torch.profiler trace capture around scoring
regions (the counterpart of the JAX package's jax.profiler ``trace``) + a
throughput meter that feeds the same per-frame progress signal contract the
UI expects.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(profile_dir: Optional[str] = None, label: str = "score",
          device=None) -> Iterator[None]:
    """Capture a torch.profiler trace when a directory is configured; no-op
    otherwise. The region runs under ``record_function(label)``, with CUDA
    activity when ``device`` is a card, and its Chrome trace
    (``*.pt.trace.json``, viewable in TensorBoard/Perfetto) is written into
    ``profile_dir``. A profiler error propagates (torch.profiler refuses to
    start inside another active profiler)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        record_function,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logger.info("capturing torch.profiler trace to %s", profile_dir)
    # One profiling cycle: acc_events only spares the per-cycle warning.
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        with record_function(label):
            yield


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
