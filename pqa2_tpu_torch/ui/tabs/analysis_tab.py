# Port of pqa2_tpu/ui/tabs/analysis_tab.py: the workflow runs on the window's
# device, and a device it cannot use fails the run through the error slot.
"""AnalysisTab — the combined alignment -> VMAF pipeline.

Rebuild of app/ui/tabs/analysis_tab.py: model dropdown from the registry
(:1005-1077), combined workflow orchestration (:174-437) — through the
decode-once engine workflow (app/workflow.py) instead of the reference's
align-to-disk-then-rescore chain — alignment-complete -> VMAF progress
handoff (:349-437), metadata save (:690-817)."""

from __future__ import annotations

import json
import os
from datetime import datetime

from PyQt5.QtWidgets import (
    QComboBox, QFormLayout, QGroupBox, QLabel, QProgressBar, QPushButton,
    QTextEdit, QVBoxLayout, QWidget,
)

from pqa2_tpu_torch.app.workflow import CombinedWorkflowThread
from pqa2_tpu_torch.models.registry import available_models
from pqa2_tpu_torch.ui.qt_bridge import bridge


class AnalysisTab(QWidget):
    def __init__(self, parent):
        super().__init__()
        self.parent = parent
        self._workflow_thread = None
        self._bridges = []
        self._alignment_handled = False  # duplicate-signal guard (:355-376)
        self.capture_path = None
        self._setup_ui()

    def _setup_ui(self):
        layout = QVBoxLayout(self)
        cfg_box = QGroupBox("Analysis configuration")
        form = QFormLayout(cfg_box)
        self.model_combo = QComboBox()
        self._populate_vmaf_models()
        form.addRow("VMAF model:", self.model_combo)
        layout.addWidget(cfg_box)

        self.run_btn = QPushButton("Run combined analysis (align + score)")
        self.run_btn.clicked.connect(self.run_combined_analysis)
        layout.addWidget(self.run_btn)

        self.progress = QProgressBar()
        layout.addWidget(self.progress)
        self.log_pane = QTextEdit()
        self.log_pane.setReadOnly(True)
        layout.addWidget(self.log_pane, 1)

    def _populate_vmaf_models(self):
        self.model_combo.clear()
        # Registry scan replaces the reference's models/ dir scan (:1005).
        names = [n for n in available_models() if not n.startswith("vmaf_float")]
        self.model_combo.addItems(names or ["vmaf_v0.6.1"])
        idx = self.model_combo.findText("vmaf_v0.6.1")
        if idx >= 0:
            self.model_combo.setCurrentIndex(idx)

    def log(self, msg: str):
        self.log_pane.append(msg)
        self.parent.statusBar().showMessage(str(msg)[:120])

    def set_capture_path(self, path: str):
        self.capture_path = path
        self.log(f"Capture ready for analysis: {path}")

    # -- combined workflow ---------------------------------------------------

    def run_combined_analysis(self):
        info = getattr(self.parent, "reference_info", None)
        if info is None or not self.capture_path:
            self.log("Need an analyzed reference and a completed capture first")
            return
        self._alignment_handled = False
        self.run_btn.setEnabled(False)
        self.progress.setValue(0)
        self.log("Starting combined alignment + VMAF workflow...")
        # One thread drives the decode-once engine workflow; the alignment
        # and analysis signal channels split the progress bar 50/50 exactly
        # like the reference's two-stage chain.
        try:
            self._workflow_thread = CombinedWorkflowThread(
                info["path"], self.capture_path,
                model=self.model_combo.currentText(),
                out_dir=self.parent.current_test_dir(),
                test_name=self.parent.current_test_name(),
                options_manager=self.parent.options_manager,
                duration=self.parent.setup_tab.selected_duration(),
                device=self.parent.device,
            )
        except (RuntimeError, ValueError) as e:  # no card for the device
            self._workflow_thread = None
            self._on_error(f"VMAF analysis error: {e}")
            return
        t = self._workflow_thread
        self._bridges = [
            bridge(t.status_update, self.log, parent=self),
            bridge(t.analysis_status, self.log, parent=self),
            bridge(t.alignment_progress,
                   lambda p: self.progress.setValue(p // 2), parent=self),
            bridge(t.alignment_complete,
                   self.handle_alignment_for_combined_workflow, parent=self),
            bridge(t.analysis_progress,
                   lambda p: self.progress.setValue(50 + p // 2), parent=self),
            bridge(t.analysis_complete, self.handle_vmaf_complete, parent=self),
            bridge(t.analysis_failed, self._on_error, parent=self),
            bridge(t.error_occurred, self._on_error, parent=self),
        ]
        t.start()

    def handle_alignment_for_combined_workflow(self, result: dict):
        if self._alignment_handled:
            return
        self._alignment_handled = True
        self.log(
            f"Alignment complete (confidence {result.get('confidence', 0):.2f})"
        )

    def handle_vmaf_complete(self, results: dict):
        self.run_btn.setEnabled(True)
        self.progress.setValue(100)
        self.log(f"VMAF: {results['vmaf_score']:.2f}")
        self._save_test_metadata(results)
        self.parent.results_tab.display_results(results)
        self.parent.tabs.setCurrentWidget(self.parent.results_tab)

    def _save_test_metadata(self, results: dict):
        """*_metadata.json with system/capture/vmaf settings (:690-817)."""
        out_dir = self.parent.current_test_dir()
        om = self.parent.options_manager
        meta = {
            "test_name": self.parent.current_test_name(),
            "date": datetime.now().isoformat(timespec="seconds"),
            "model": results.get("model"),
            "scores": {
                "vmaf": results.get("vmaf_score"),
                "psnr": results.get("psnr_score"),
                "ssim": results.get("ssim_score"),
            },
            "settings": {
                "vmaf": om.get_setting("vmaf") if om else {},
                "bookend": om.get_setting("bookend") if om else {},
                "capture": om.get_setting("capture") if om else {},
            },
        }
        path = os.path.join(out_dir, f"{meta['test_name']}_metadata.json")
        with open(path, "w") as f:
            json.dump(meta, f, indent=2, default=str)

    def _on_error(self, msg):
        self.run_btn.setEnabled(True)
        self.log(f"ERROR: {msg}")
