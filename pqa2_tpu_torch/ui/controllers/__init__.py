# Copy of pqa2_tpu/ui/controllers/__init__.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Qt-free UI controllers.

Every behavior the reference implements inline in its Qt widgets —
history browsing (app/ui/tabs/results_tab.py:3081-3696), device status
checks (app/ui/tabs/capture_tab.py:609-689), the capture log pane
(:870-915), preview frame conversion (:449-530) — lives here as plain
Python with tests; the Qt tabs are thin glue over these. This split is
what makes the UI layer testable in an environment without Qt (and is
the natural structure anyway: none of these behaviors need a widget).
"""

from pqa2_tpu_torch.ui.controllers.capturelog import CaptureLogModel, LogEntry
from pqa2_tpu_torch.ui.controllers.devicestatus import (
    DeviceStatus,
    check_device_status,
    device_rows,
)
from pqa2_tpu_torch.ui.controllers.history import HistoryController
from pqa2_tpu_torch.ui.controllers.preview import PreviewModel
from pqa2_tpu_torch.ui.controllers.setup import (
    DURATION_CHOICES,
    load_preview_rgb,
    parse_duration,
    reference_summary,
)

__all__ = [
    "DURATION_CHOICES",
    "load_preview_rgb",
    "parse_duration",
    "reference_summary",
    "CaptureLogModel",
    "LogEntry",
    "DeviceStatus",
    "check_device_status",
    "device_rows",
    "HistoryController",
    "PreviewModel",
]
