# Copy of pqa2_tpu/utils/signals.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Minimal signal/slot implementation (Qt-free).

The reference's engine layer communicates exclusively through pyqtSignal
channels (e.g. VMAFAnalyzer.analysis_progress/analysis_complete/
error_occurred/status_update, app/vmaf_analyzer.py:20-27). This class keeps
that exact connect/emit/disconnect contract so the engine layer stays
headless-capable and a Qt UI can bridge to real pyqtSignals 1:1.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List

logger = logging.getLogger(__name__)


class Signal:
    """Callable-list signal with the pyqtSignal surface the app layer uses."""

    def __init__(self, *arg_types, name: str = ""):
        self._arg_types = arg_types  # documentation only, like pyqtSignal(int)
        self._name = name
        self._lock = threading.Lock()
        self._slots: List[Callable] = []

    def connect(self, slot: Callable) -> None:
        with self._lock:
            if slot not in self._slots:
                self._slots.append(slot)

    def disconnect(self, slot: Callable = None) -> None:
        with self._lock:
            if slot is None:
                self._slots.clear()
            elif slot in self._slots:
                self._slots.remove(slot)

    def connected(self, slot: Callable):
        """Context manager: connect for the duration of a block.

        Engine objects outlive individual operations (e.g. one VMAFAnalyzer
        serving many jobs); scoped connections keep per-operation listeners
        from accumulating across runs."""
        import contextlib

        @contextlib.contextmanager
        def _scope():
            self.connect(slot)
            try:
                yield self
            finally:
                self.disconnect(slot)

        return _scope()

    def emit(self, *args) -> None:
        with self._lock:
            slots = list(self._slots)
        for slot in slots:
            try:
                slot(*args)
            except Exception:  # a bad listener must not break the engine
                logger.exception("signal %s: slot %r raised", self._name, slot)
