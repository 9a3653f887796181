# Copy of pqa2_tpu/ui/qt_bridge.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Bridging engine signals (pqa2_tpu_torch.utils.Signal) into the Qt event loop.

The engine layer emits from worker threads; Qt widgets must only be touched
from the GUI thread. SignalBridge re-emits any engine signal as a queued
pyqtSignal so slots always run on the GUI thread — the same role the
reference's pyqtSignal channels play natively (it defines its engines as
QObjects; ours are Qt-free)."""

from __future__ import annotations

from PyQt5.QtCore import QObject, pyqtSignal


class SignalBridge(QObject):
    """One bridged channel: engine Signal -> queued Qt signal."""

    relayed = pyqtSignal(object)

    def __init__(self, engine_signal, parent=None):
        super().__init__(parent)
        engine_signal.connect(self._relay)

    def _relay(self, *args):
        self.relayed.emit(args if len(args) != 1 else args[0])

    def connect(self, slot):
        self.relayed.connect(slot)


def bridge(engine_signal, slot, parent=None) -> SignalBridge:
    b = SignalBridge(engine_signal, parent)
    b.connect(slot)
    return b
