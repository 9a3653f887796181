# Copy of pqa2_tpu/ui/controllers/capturelog.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Capture log pane model: severity-classified, timestamped ring buffer.

Reference behavior: app/ui/tabs/capture_tab.py:870-915 — each message is
timestamped and colour-classified by keyword (error/warning/success), the
pane auto-scrolls, errors flash the status bar. The model here owns the
classification, formatting, buffering and the signal subscriptions; the
Qt pane just renders entries.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional

SEVERITY_COLORS = {
    "error": "#D32F2F",
    "warning": "#FF9800",
    "success": "#388E3C",
    "info": None,
}

_ERROR_WORDS = ("error", "failed", "exception")
_WARNING_WORDS = ("warning", "caution")
_SUCCESS_WORDS = ("success", "complete", "finished")


def classify(message: str) -> str:
    m = message.lower()
    if any(w in m for w in _ERROR_WORDS):
        return "error"
    if any(w in m for w in _WARNING_WORDS):
        return "warning"
    if any(w in m for w in _SUCCESS_WORDS):
        return "success"
    return "info"


@dataclasses.dataclass
class LogEntry:
    timestamp: str  # HH:MM:SS
    message: str
    severity: str

    @property
    def text(self) -> str:
        return f"[{self.timestamp}] {self.message}"

    @property
    def html(self) -> str:
        color = SEVERITY_COLORS[self.severity]
        if color is None:
            return self.text
        weight = ("font-weight: bold;"
                  if self.severity in ("error", "success") else "")
        return (f'<span style="color: {color}; {weight}">'
                f"{self.text}</span>")


class CaptureLogModel:
    """Bounded log with listeners (the Qt pane registers one).

    ``add`` runs on whatever thread emitted the message (capture worker
    threads included). Qt panes must NOT subscribe via ``on_entry`` —
    widgets are GUI-thread-only; bridge ``entry_added`` through
    ui.qt_bridge instead (which queues across threads)."""

    def __init__(self, max_entries: int = 500,
                 clock: Optional[Callable[[], str]] = None):
        from pqa2_tpu_torch.utils.signals import Signal

        self.entries: Deque[LogEntry] = deque(maxlen=max_entries)
        self.entry_added = Signal(object, name="log_entry_added")
        self._clock = clock or (lambda: time.strftime("%H:%M:%S"))
        self._listeners: List[Callable[[LogEntry], None]] = []
        self._lock = threading.Lock()

    def add(self, message: str) -> LogEntry:
        entry = LogEntry(self._clock(), str(message), classify(str(message)))
        with self._lock:
            self.entries.append(entry)
            listeners = list(self._listeners)
        for cb in listeners:
            cb(entry)
        self.entry_added.emit(entry)
        return entry

    def on_entry(self, cb: Callable[[LogEntry], None]) -> None:
        with self._lock:
            self._listeners.append(cb)

    def tail(self, n: int = 50) -> List[LogEntry]:
        with self._lock:
            return list(self.entries)[-n:]

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()

    @property
    def has_errors(self) -> bool:
        with self._lock:
            return any(e.severity == "error" for e in self.entries)

    # -- engine wiring -------------------------------------------------------

    def attach(self, capture_manager) -> None:
        """Subscribe to a CaptureManager's signal channels."""
        capture_manager.status_update.connect(self.add)
        capture_manager.capture_started.connect(
            lambda *_: self.add("Capture started"))
        capture_manager.capture_finished.connect(
            lambda ok, path: self.add(
                f"Capture finished successfully: {path}" if ok
                else f"Capture failed: {path}"))
