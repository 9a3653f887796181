# Port of pqa2_tpu/utils/profiling.py: ``trace`` runs torch.profiler where the
# JAX module runs jax.profiler; ``ThroughputMeter`` is the JAX module's.
"""Tracing / profiling hooks.

The reference's observability is log-scraped ffmpeg progress
(SURVEY.md section 5.1). Here: torch.profiler trace capture around scoring
regions (the counterpart of the JAX package's jax.profiler ``trace``), the
program's own spans and counters inside it, and a throughput meter that
feeds the same per-frame progress signal contract the UI expects.

Spans (:func:`span`) record only while a torch profiler records (the
operator's :func:`trace` or any other) or, on a worker thread, while it
serves a recorded request (:func:`join_request`: the profiler's flag is
per thread); otherwise each costs one flag test. A recording span opens
``record_function(name)``, so the Chrome trace shows it (a worker
thread's only as a record: the profiler follows the thread that started
it), and appends a :class:`SpanRecord` (:func:`records`) with
its counts: ``htod_bytes`` (frame planes copied to the device),
``syncs`` and ``dtoh_bytes`` (blocking device-to-host reads,
:func:`to_host`) and ``frames`` (frames a request scored).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import logging
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.autograd import _profiler_enabled

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. ``start_ns``/``end_ns`` are on the Chrome trace's
    clock (an event's ``ts`` in microseconds plus the trace's
    ``baseTimeNanoseconds``, both since the Unix epoch); ``parent`` is the
    enclosing span's name on the same thread, ``request`` the id of the
    ``analyze_*`` call it served (None outside one)."""

    name: str
    start_ns: int = 0
    end_ns: int = 0
    parent: Optional[str] = None
    request: Optional[int] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_RECORDS: List[SpanRecord] = []
_PARENT: contextvars.ContextVar = contextvars.ContextVar("pqa2_span_parent", default=None)
_REQUEST: contextvars.ContextVar = contextvars.ContextVar("pqa2_span_request", default=None)
_REQUEST_IDS = itertools.count(1)


class _Off:
    """The span of an unrecorded region: enters, adds and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "new_request", "fn", "tokens")

    def __init__(self, name: str, counts: Dict[str, int], new_request: bool):
        self.rec = SpanRecord(name, counts=counts)
        self.new_request = new_request

    def __enter__(self):
        rec = self.rec
        rec.parent = _PARENT.get()
        self.tokens = [_PARENT.set(rec.name)]
        if self.new_request:
            self.tokens.append(_REQUEST.set(next(_REQUEST_IDS)))
        rec.request = _REQUEST.get()
        # The clock is read before record_function enters and after it
        # exits: its own first call in a process takes ~1 ms after it
        # stamps the event.
        rec.start_ns = time.time_ns()
        self.fn = torch.profiler.record_function(rec.name)
        self.fn.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.fn.__exit__(*exc)
        self.rec.end_ns = time.time_ns()
        for token in reversed(self.tokens):
            token.var.reset(token)
        _RECORDS.append(self.rec)
        return False

    def add(self, **counts) -> None:
        """Add to the span's counts (for a count known only at its end)."""
        c = self.rec.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + int(v)


def span(name: str, *, request: bool = False, **counts):
    """A named span of the program: a context manager whose ``add(**counts)``
    adds to its counts. It records only while a torch profiler records;
    then it opens ``record_function(name)`` and appends a
    :class:`SpanRecord`. ``request=True`` opens a new request id for the
    spans inside it (the outermost span of an ``analyze_*`` call)."""
    if not _profiler_enabled() and _REQUEST.get() is None:
        return _OFF
    return _Span(name, counts, request)


def current_request() -> Optional[int]:
    """The request id of the calling context (None outside a recorded request)."""
    return _REQUEST.get()


def join_request(request_id: Optional[int]) -> None:
    """Give this thread's spans ``request_id``: called where a worker thread
    starts, whose context is its own, for its share of its caller's
    request. With an id its spans record, as the caller's do."""
    _REQUEST.set(request_id)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as host numpy: a blocking device-to-host read, counted in a
    ``scoring.sync`` span (one sync, ``t``'s bytes)."""
    with span("scoring.sync", syncs=1, dtoh_bytes=t.nbytes):
        return t.cpu().numpy()


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`clear`, in the order they ended."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


def summary(recs: Optional[List[SpanRecord]] = None) -> Dict:
    """Totals of the records: frames, HtoD MB, syncs and DtoH MB a frame
    (None without frames), seconds by span name."""
    recs = records() if recs is None else recs
    totals: Dict[str, int] = {}
    seconds: Dict[str, float] = {}
    for r in recs:
        for k, v in r.counts.items():
            totals[k] = totals.get(k, 0) + v
        seconds[r.name] = seconds.get(r.name, 0.0) + r.seconds
    frames = totals.get("frames", 0)
    per = (lambda v: v / frames) if frames else (lambda v: None)
    return {"frames": frames, "htod_mb_per_frame": per(totals.get("htod_bytes", 0) / 1e6),
            "syncs_per_frame": per(totals.get("syncs", 0)),
            "dtoh_mb_per_frame": per(totals.get("dtoh_bytes", 0) / 1e6), "seconds": seconds}


@contextlib.contextmanager
def trace(profile_dir: Optional[str] = None, label: str = "score",
          device=None) -> Iterator[None]:
    """Capture a torch.profiler trace when a directory is configured; no-op
    otherwise. The region runs under ``record_function(label)``, with CUDA
    activity when ``device`` is a card, and its Chrome trace
    (``*.pt.trace.json``, viewable in TensorBoard/Perfetto) is written into
    ``profile_dir``; the program's spans lie in it. The span records are
    cleared on entry, and on exit one log line gives what the trace does
    not show: frames, HtoD MB, syncs and DtoH MB a frame, seconds by span
    name. A
    profiler error propagates (torch.profiler refuses to start inside
    another active profiler)."""
    if not profile_dir:
        yield
        return
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
    clear()
    # One profiling cycle: acc_events only spares the per-cycle warning.
    with profile(activities=activities, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        with record_function(label):
            yield
    s = summary()
    logger.info("trace %s: %d frames, HtoD %s MB/frame, %s syncs/frame, DtoH %s MB/frame; "
                "seconds by span %s",
                label, s["frames"], s["htod_mb_per_frame"], s["syncs_per_frame"],
                s["dtoh_mb_per_frame"], json.dumps({k: round(v, 6) for k, v in sorted(s["seconds"].items())}))


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
