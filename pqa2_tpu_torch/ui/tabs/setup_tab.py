# Port of pqa2_tpu/ui/tabs/setup_tab.py: the reference analysis runs on the
# window's device, and a device it cannot use is reported in the info pane.
"""SetupTab — test metadata + reference selection/analysis.

Rebuild of app/ui/tabs/setup_tab.py: reference file browser (:209-254),
background analysis via ReferenceAnalysisThread (:286-298), reference
preview pane, duration combo and handoff of reference_info to the
CaptureManager (:300-355). Display logic lives in the Qt-free setup
controller (ui/controllers/setup.py)."""

from __future__ import annotations

import os

from PyQt5.QtGui import QImage, QPixmap
from PyQt5.QtWidgets import (
    QComboBox, QFileDialog, QFormLayout, QGroupBox, QLabel, QLineEdit,
    QPushButton, QTextEdit, QVBoxLayout, QWidget,
)

from pqa2_tpu_torch.app.reference_analyzer import ReferenceAnalysisThread
from pqa2_tpu_torch.ui.controllers import (
    DURATION_CHOICES, load_preview_rgb, parse_duration, reference_summary,
)
from pqa2_tpu_torch.ui.qt_bridge import bridge


class SetupTab(QWidget):
    def __init__(self, parent):
        super().__init__()
        self.parent = parent
        self._thread = None
        self._bridges = []
        self._setup_ui()

    def _setup_ui(self):
        layout = QVBoxLayout(self)

        meta_box = QGroupBox("Test metadata")
        form = QFormLayout(meta_box)
        self.test_name_edit = QLineEdit("Test_01")
        self.tester_edit = QLineEdit()
        self.location_edit = QLineEdit()
        form.addRow("Test name:", self.test_name_edit)
        form.addRow("Tester:", self.tester_edit)
        form.addRow("Location:", self.location_edit)
        layout.addWidget(meta_box)

        ref_box = QGroupBox("Reference video")
        ref_layout = QVBoxLayout(ref_box)
        self.ref_path_label = QLabel("No reference selected")
        browse_btn = QPushButton("Browse...")
        browse_btn.clicked.connect(self.browse_reference_video)
        self.duration_combo = QComboBox()
        self.duration_combo.addItems(DURATION_CHOICES)
        self.preview_label = QLabel("No preview")
        self.preview_label.setMinimumHeight(140)
        self.info_text = QTextEdit()
        self.info_text.setReadOnly(True)
        ref_layout.addWidget(self.ref_path_label)
        ref_layout.addWidget(browse_btn)
        ref_layout.addWidget(QLabel("Analysis duration:"))
        ref_layout.addWidget(self.duration_combo)
        ref_layout.addWidget(self.preview_label)
        ref_layout.addWidget(self.info_text)
        layout.addWidget(ref_box)
        layout.addStretch(1)

    def selected_duration(self):
        return parse_duration(self.duration_combo.currentText())

    def browse_reference_video(self):
        path, _ = QFileDialog.getOpenFileName(
            self, "Select reference video", "",
            "Video files (*.y4m *.mp4 *.mkv *.avi *.mov);;All files (*)",
        )
        if path:
            self.ref_path_label.setText(path)
            self.analyze_reference(path)

    def analyze_reference(self, path: str):
        self.info_text.setPlainText("Analyzing reference...")
        try:
            self._thread = ReferenceAnalysisThread(path, device=self.parent.device)
        except (RuntimeError, ValueError) as e:  # no card for the device
            self._thread = None
            self.info_text.setPlainText(f"Error: {e}")
            return
        self._bridges = [
            bridge(self._thread.analysis_complete, self.handle_reference_analyzed,
                   parent=self),
            bridge(self._thread.error_occurred,
                   lambda msg: self.info_text.setPlainText(f"Error: {msg}"),
                   parent=self),
        ]
        self._thread.start()

    def handle_reference_analyzed(self, info: dict):
        self.parent.reference_info = info
        self.info_text.setPlainText("\n".join(reference_summary(info)))
        self._show_preview(info.get("path"))
        if self.parent.capture_manager is not None:
            self.parent.capture_manager.set_reference_video(info)
        self.parent.statusBar().showMessage("Reference analyzed")

    def _show_preview(self, path):
        """Reference preview pane (setup_tab preview / capture_tab
        _show_reference_preview)."""
        if not path:
            return
        rgb, status = load_preview_rgb(path)
        if rgb is None:
            self.preview_label.setText(status)
            return
        h, w, _ = rgb.shape
        img = QImage(rgb.data, w, h, 3 * w, QImage.Format_RGB888)
        self.preview_label.setPixmap(QPixmap.fromImage(img).scaled(
            self.preview_label.width() or w,
            self.preview_label.height() or h,
        ))
