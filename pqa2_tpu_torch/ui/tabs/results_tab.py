# Copy of pqa2_tpu/ui/tabs/results_tab.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""ResultsTab — score display, exports, history browser.

Rebuild of the live portion of app/ui/tabs/results_tab.py (:2390-3716):
score display with interpretation bands (:2394-2438), PDF export via
ReportGeneratorThread (:2683-2742), per-frame CSV export (:2906-3065),
history browser over ResultsStore (:3081-3244), delete + combined CSV
(:3255-3696). The dead embedded second app (:37-2389) is intentionally not
rebuilt (SURVEY.md section 7.4)."""

from __future__ import annotations

import os

from PyQt5.QtWidgets import (
    QFileDialog, QGroupBox, QHBoxLayout, QLabel, QListWidget, QListWidgetItem,
    QPushButton, QVBoxLayout, QWidget,
)

from pqa2_tpu_torch.app.report_generator import (
    ReportGenerator, ReportGeneratorThread, interpret_psnr, interpret_ssim,
    interpret_vmaf,
)
from pqa2_tpu_torch.app.results_store import ResultsStore, write_compact_metadata
from pqa2_tpu_torch.ui.controllers import HistoryController
from pqa2_tpu_torch.ui.qt_bridge import bridge


class ResultsTab(QWidget):
    def __init__(self, parent):
        super().__init__()
        self.parent = parent
        self.current_results = None
        self._report_thread = None
        self._bridges = []
        base = parent.file_manager.get_default_base_dir() if parent.file_manager else "results"
        self.store = ResultsStore(base)
        self.history = HistoryController(self.store)
        self._setup_ui()

    def _setup_ui(self):
        layout = QVBoxLayout(self)
        score_box = QGroupBox("Latest result")
        score_layout = QVBoxLayout(score_box)
        self.vmaf_label = QLabel("VMAF: -")
        self.psnr_label = QLabel("PSNR: -")
        self.ssim_label = QLabel("SSIM: -")
        for lbl in (self.vmaf_label, self.psnr_label, self.ssim_label):
            score_layout.addWidget(lbl)
        layout.addWidget(score_box)

        btns = QHBoxLayout()
        self.pdf_btn = QPushButton("Export PDF report")
        self.pdf_btn.clicked.connect(self.export_pdf_report)
        self.csv_btn = QPushButton("Export CSV")
        self.csv_btn.clicked.connect(self.export_csv_data)
        self.html_btn = QPushButton("Export HTML")
        self.html_btn.clicked.connect(self.export_html_report)
        for b in (self.pdf_btn, self.csv_btn, self.html_btn):
            b.setEnabled(False)
            btns.addWidget(b)
        layout.addLayout(btns)

        hist_box = QGroupBox("Test history")
        hist_layout = QVBoxLayout(hist_box)
        self.history_list = QListWidget()
        hist_layout.addWidget(self.history_list)
        hist_btns = QHBoxLayout()
        reload_btn = QPushButton("Reload history")
        reload_btn.clicked.connect(self.load_results_history)
        view_btn = QPushButton("View selected")
        view_btn.clicked.connect(self.view_selected)
        delete_btn = QPushButton("Delete selected")
        delete_btn.clicked.connect(self.delete_selected)
        combined_btn = QPushButton("Export combined CSV")
        combined_btn.clicked.connect(self.export_combined_csv)
        for b in (reload_btn, view_btn, delete_btn, combined_btn):
            hist_btns.addWidget(b)
        hist_layout.addLayout(hist_btns)
        layout.addWidget(hist_box, 1)

    # -- latest result -------------------------------------------------------

    def display_results(self, results: dict):
        self.current_results = results
        v = results.get("vmaf_score")
        p = results.get("psnr_score")
        s = results.get("ssim_score")
        self.vmaf_label.setText(
            f"VMAF: {v:.2f}  ({interpret_vmaf(v)})" if v is not None else "VMAF: -"
        )
        self.psnr_label.setText(
            f"PSNR: {p:.2f} dB  ({interpret_psnr(p)})" if p is not None else "PSNR: -"
        )
        self.ssim_label.setText(
            f"SSIM: {s:.4f}  ({interpret_ssim(s)})" if s is not None else "SSIM: -"
        )
        for b in (self.pdf_btn, self.csv_btn, self.html_btn):
            b.setEnabled(True)
        # Compact metadata for fast history reload (:2642-2679).
        out_dir = os.path.dirname(results.get("json_path", "")) or "."
        write_compact_metadata(results, out_dir)
        self.load_results_history()

    # -- exports -------------------------------------------------------------

    def _export_path(self, caption, default_name, filt):
        path, _ = QFileDialog.getSaveFileName(self, caption, default_name, filt)
        return path

    def export_pdf_report(self):
        if not self.current_results:
            return
        path = self._export_path("Export PDF", "report.pdf", "PDF (*.pdf)")
        if not path:
            return
        self._report_thread = ReportGeneratorThread(
            self.current_results, path,
            options_manager=self.parent.options_manager,
        )
        self._bridges = [
            bridge(self._report_thread.report_complete,
                   lambda p: self.parent.statusBar().showMessage(f"PDF saved: {p}"),
                   parent=self),
        ]
        self._report_thread.start()

    def export_html_report(self):
        if not self.current_results:
            return
        path = self._export_path("Export HTML", "report.html", "HTML (*.html)")
        if path:
            ReportGenerator(self.parent.options_manager).generate_html_report(
                self.current_results, path
            )

    def export_csv_data(self):
        if not self.current_results:
            return
        path = self._export_path("Export CSV", "frames.csv", "CSV (*.csv)")
        if path:
            ReportGenerator().export_csv(self.current_results, path)

    # -- history -------------------------------------------------------------

    def load_results_history(self):
        self.history_list.clear()
        for rec in self.history.refresh():
            item = QListWidgetItem(rec["label"])
            item.setData(32, rec["test_dir"])  # Qt.UserRole
            self.history_list.addItem(item)

    def view_selected(self):
        """Re-display a historical result (results_tab.py:3255-3310)."""
        items = self.history_list.selectedItems()
        if not items:
            return
        results, msg = self.history.view(items[0].data(32))
        if results is None:
            self.parent.statusBar().showMessage(msg)
            return
        self.display_results(results)

    def delete_selected(self):
        dirs = [item.data(32) for item in self.history_list.selectedItems()]
        n, failures = self.history.delete(dirs)
        if failures:
            self.parent.statusBar().showMessage("; ".join(failures))
        elif n:
            self.parent.statusBar().showMessage(f"Deleted {n} result(s)")
        self.load_results_history()

    def export_combined_csv(self):
        path = self._export_path("Export combined CSV", "history.csv", "CSV (*.csv)")
        if path:
            self.store.export_combined_csv(path)
