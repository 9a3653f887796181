# Copy of pqa2_tpu/ui/tabs/capture_tab.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""CaptureTab — device selection + bookend capture control.

Rebuild of app/ui/tabs/capture_tab.py: device dropdown + status indicator
(:609-689), start/stop bookend capture (:690-770), progress display
(:772-869), live preview pane (:449-530), scrolling capture log (:870-915).
All behavior lives in the Qt-free controllers (ui/controllers/); this widget
is render glue."""

from __future__ import annotations

from PyQt5.QtGui import QImage, QPixmap
from PyQt5.QtWidgets import (
    QComboBox, QGroupBox, QHBoxLayout, QLabel, QProgressBar, QPushButton,
    QTextEdit, QVBoxLayout, QWidget,
)

from pqa2_tpu_torch.app.capture import CaptureState
from pqa2_tpu_torch.ui.controllers import (
    CaptureLogModel, PreviewModel, check_device_status, device_rows,
    load_preview_rgb,
)
from pqa2_tpu_torch.ui.qt_bridge import bridge


class CaptureTab(QWidget):
    def __init__(self, parent):
        super().__init__()
        self.parent = parent
        self._bridges = []
        self.log_model = CaptureLogModel()
        self.preview_model = PreviewModel(max_render_fps=15.0)
        self._setup_ui()
        cm = self.parent.capture_manager
        if cm is not None:
            self.log_model.attach(cm)
            self._bridges = [
                bridge(cm.progress_update, self.progress.setValue, parent=self),
                bridge(cm.state_changed, self._on_state, parent=self),
                bridge(cm.capture_finished, self._on_finished, parent=self),
                bridge(cm.frame_available, self._on_frame, parent=self),
                bridge(cm.frame_count_updated, self._on_frame_count,
                       parent=self),
            ]
        # Log entries arrive on capture worker threads; the bridge queues
        # them onto the GUI thread before the pane is touched.
        self._bridges.append(
            bridge(self.log_model.entry_added, self._render_log_entry,
                   parent=self))

    def _setup_ui(self):
        layout = QVBoxLayout(self)
        dev_box = QGroupBox("Capture device")
        dev_layout = QHBoxLayout(dev_box)
        self.device_combo = QComboBox()
        self.device_status = QLabel()
        self.device_status.setFixedSize(16, 16)
        refresh_btn = QPushButton("Refresh")
        refresh_btn.clicked.connect(self.populate_devices_and_check_status)
        dev_layout.addWidget(self.device_combo, 1)
        dev_layout.addWidget(self.device_status)
        dev_layout.addWidget(refresh_btn)
        layout.addWidget(dev_box)
        self.device_combo.currentTextChanged.connect(self._check_status)
        self.populate_devices_and_check_status()

        prev_box = QGroupBox("Preview")
        prev_layout = QVBoxLayout(prev_box)
        self.preview_label = QLabel("No video feed received")
        self.preview_label.setMinimumHeight(120)
        self.frame_counter = QLabel("Frame: 0")
        prev_layout.addWidget(self.preview_label, 1)
        prev_layout.addWidget(self.frame_counter)
        layout.addWidget(prev_box, 1)

        ctl = QHBoxLayout()
        self.start_btn = QPushButton("Start bookend capture")
        self.start_btn.clicked.connect(self.start_capture)
        self.stop_btn = QPushButton("Stop")
        self.stop_btn.setEnabled(False)
        self.stop_btn.clicked.connect(self.stop_capture)
        ctl.addWidget(self.start_btn)
        ctl.addWidget(self.stop_btn)
        layout.addLayout(ctl)

        self.progress = QProgressBar()
        self.state_label = QLabel("Idle")
        self.capture_frame_label = QLabel("Frames: 0")
        layout.addWidget(self.progress)
        layout.addWidget(self.state_label)
        layout.addWidget(self.capture_frame_label)

        self.log_pane = QTextEdit()
        self.log_pane.setReadOnly(True)
        layout.addWidget(self.log_pane, 1)

    # -- devices (controllers/devicestatus.py) -------------------------------

    def populate_devices_and_check_status(self):
        om = self.parent.options_manager
        devices, current = device_rows(om)
        self.device_combo.clear()
        # File-playback simulator is always offered so the workflow runs
        # without a card (engine test double, app/capture.py).
        self.device_combo.addItems(devices + ["File playback (simulated)"])
        if current:
            idx = self.device_combo.findText(current)
            if idx >= 0:
                self.device_combo.setCurrentIndex(idx)
        self._check_status()

    def _check_status(self, *_):
        status = check_device_status(
            self.device_combo.currentText(), self.parent.options_manager
        )
        self.device_status.setStyleSheet(
            f"background-color: {status.color}; border-radius: 8px;"
        )
        self.device_status.setToolTip(status.tooltip)

    # -- log (controllers/capturelog.py) --------------------------------------

    def log(self, msg: str):
        self.log_model.add(msg)

    def _render_log_entry(self, entry):
        self.log_pane.append(entry.html)
        sb = self.log_pane.verticalScrollBar()
        sb.setValue(sb.maximum())

    # -- preview (controllers/preview.py) --------------------------------------

    def _on_frame(self, frame):
        rgb = self.preview_model.submit(frame)
        self.frame_counter.setText(self.preview_model.counter_text)
        if rgb is None:
            if self.preview_model.last_status != "ok":
                self.preview_label.setText(self.preview_model.last_status)
            return
        h, w, _ = rgb.shape
        img = QImage(rgb.data, w, h, 3 * w, QImage.Format_RGB888)
        self.preview_label.setPixmap(QPixmap.fromImage(img).scaled(
            self.preview_label.size().width() or w,
            self.preview_label.size().height() or h,
        ))

    # -- capture lifecycle -----------------------------------------------------

    def showEvent(self, event):
        """Entering the tab while idle shows the reference's first frame
        (reference capture_tab.py:_show_reference_preview). The decoded
        frame is cached per path — tab switches must not re-open/decode
        the file on the GUI thread every time."""
        super().showEvent(event)
        if self.is_capturing():
            return
        info = getattr(self.parent, "reference_info", None)
        if not info or not info.get("path"):
            return
        path = info["path"]
        cached = getattr(self, "_ref_preview_cache", None)
        if cached is not None and cached[0] == path:
            rgb = cached[1]
            if rgb is None:
                return
        else:
            rgb, status = load_preview_rgb(path)
            self._ref_preview_cache = (path, rgb)
            if rgb is None:
                self.preview_label.setText(status)
                return
        h, w, _ = rgb.shape
        img = QImage(rgb.data, w, h, 3 * w, QImage.Format_RGB888)
        self.preview_label.setPixmap(QPixmap.fromImage(img).scaled(
            self.preview_label.size().width() or w,
            self.preview_label.size().height() or h,
        ))

    def start_capture(self):
        cm = self.parent.capture_manager
        if cm is None:
            self.log("No capture manager available")
            return
        if getattr(self.parent, "reference_info", None) is None:
            self.log("Select and analyze a reference video first (Setup tab)")
            return
        cm.set_test_name(self.parent.current_test_name())
        if cm.start_bookend_capture(self.device_combo.currentText()):
            self.start_btn.setEnabled(False)
            self.stop_btn.setEnabled(True)

    def stop_capture(self):
        cm = self.parent.capture_manager
        if cm is not None:
            cm.stop_capture()
        self.start_btn.setEnabled(True)
        self.stop_btn.setEnabled(False)

    def _on_frame_count(self, args):
        current, total = args
        if total > 0:
            self.capture_frame_label.setText(
                f"Frames: {current:,} / {total:,}")
        else:
            self.capture_frame_label.setText(f"Frames: {current:,}")

    def _on_state(self, state):
        self.state_label.setText(str(getattr(state, "name", state)))

    def _on_finished(self, args):
        ok, path = args
        self.start_btn.setEnabled(True)
        self.stop_btn.setEnabled(False)
        self.parent.handle_capture_finished(bool(ok), path)

    def is_capturing(self) -> bool:
        cm = self.parent.capture_manager
        return cm is not None and cm.state == CaptureState.CAPTURING
