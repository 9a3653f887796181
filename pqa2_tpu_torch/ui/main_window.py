# Port of pqa2_tpu/ui/main_window.py: the window takes the device its engine
# threads run on, and its About text names the port.
"""MainWindow — the 6-tab wizard shell.

Rebuild of app/ui/main_window.py: fixed-size window with Setup / Capture /
Analysis / Results / Options / Help tabs (:71-100), manager signal wiring
(:112-142), capture-finished handoff to the analysis tab (:154-194),
close-time thread/file cleanup (:230-256), and state reset (:258-285).

``device`` is where the Setup tab's reference analysis and the Analysis
tab's align-and-score workflow run: ``cuda`` unless the caller asks for
``cpu``. The engines check it when a tab starts them (a missing card fails
that run through the tab's error slot; nothing falls back to the CPU)."""

from __future__ import annotations

import logging
from datetime import datetime

import torch
from PyQt5.QtWidgets import QMainWindow, QTabWidget

from pqa2_tpu_torch.ui.tabs import (
    AnalysisTab, CaptureTab, HelpTab, OptionsTab, ResultsTab, SetupTab,
)

logger = logging.getLogger(__name__)


class MainWindow(QMainWindow):
    def __init__(self, capture_manager=None, file_manager=None,
                 options_manager=None, device="cuda"):
        super().__init__()
        self.device = torch.device(device)
        self.capture_manager = capture_manager
        self.file_manager = file_manager
        self.options_manager = options_manager
        self.reference_info = None
        self._test_timestamp = None
        app_name = "VMAF Test App"
        if options_manager is not None:
            app_name = (options_manager.get_setting("branding", "app_name")
                        or app_name)
        self.setWindowTitle(app_name)
        self.resize(1400, 900)
        self._setup_ui()
        self._apply_branding_logo()

    def _apply_branding_logo(self):
        """Window icon from branding.logo_path, falling back to the
        bundled default asset (reference main_window.py:196-228 loads its
        hardcoded logo set; settings-driven here — a missing/invalid path
        is silently cosmetic)."""
        from pqa2_tpu_torch.ui.branding import resolve_logo_path

        path = resolve_logo_path(self.options_manager)
        if not path:
            return
        try:
            from PyQt5.QtGui import QIcon

            icon = QIcon(path)
            if not icon.isNull():
                self.setWindowIcon(icon)
        except Exception:
            logger.exception("could not load branding logo %r", path)

    def _setup_ui(self):
        self._setup_menu()
        self.tabs = QTabWidget()
        self.setup_tab = SetupTab(self)
        self.capture_tab = CaptureTab(self)
        self.analysis_tab = AnalysisTab(self)
        self.results_tab = ResultsTab(self)
        self.options_tab = OptionsTab(self)
        self.help_tab = HelpTab(self)
        for tab, name in (
            (self.setup_tab, "Setup"),
            (self.capture_tab, "Capture"),
            (self.analysis_tab, "Analysis"),
            (self.results_tab, "Results"),
            (self.options_tab, "Options"),
            (self.help_tab, "Help"),
        ):
            self.tabs.addTab(tab, name)
        # Wizard navigation (reference main_window.py:137-142): Back/Next
        # rows at the bottom of the four workflow tabs.
        self._add_nav(self.setup_tab, None, 1)
        self._add_nav(self.capture_tab, 0, 2)
        self._add_nav(self.analysis_tab, 1, 3)
        self._add_nav(self.results_tab, 2, None)
        self.setCentralWidget(self.tabs)
        self.statusBar().showMessage("Ready")
        # Settings changes propagate live (reference main_window.py:144-152):
        # device indicator re-checks and the theme re-applies.
        if self.options_manager is not None:
            from pqa2_tpu_torch.ui.qt_bridge import bridge

            self._settings_bridge = bridge(
                self.options_manager.settings_updated,
                self._on_settings_updated, parent=self)

    def _add_nav(self, tab, prev_idx, next_idx):
        from PyQt5.QtWidgets import QHBoxLayout, QPushButton

        layout = tab.layout()
        if layout is None:
            return
        row = QHBoxLayout()
        if prev_idx is not None:
            back = QPushButton("← Back")
            back.clicked.connect(
                lambda _=None, i=prev_idx: self.tabs.setCurrentIndex(i))
            row.addWidget(back)
        row.addStretch(1)
        if next_idx is not None:
            nxt = QPushButton("Next →")
            nxt.clicked.connect(
                lambda _=None, i=next_idx: self.tabs.setCurrentIndex(i))
            row.addWidget(nxt)
        layout.addLayout(row)

    def _on_settings_updated(self, _settings):
        try:
            self.capture_tab.populate_devices_and_check_status()
        except Exception:
            logger.exception("device status refresh failed")
        try:
            from pqa2_tpu_torch.models.registry import set_user_models_dir

            set_user_models_dir(
                self.options_manager.get_setting("paths", "models_dir"))
            self.analysis_tab._populate_vmaf_models()
        except Exception:
            logger.exception("model list refresh failed")
        tm = getattr(self, "theme_manager", None)
        if tm is not None:
            tm.apply_current_theme()

    def _setup_menu(self):
        """File/Help menus (the reference exposes New Test + About)."""
        file_menu = self.menuBar().addMenu("&File")
        new_act = file_menu.addAction("&New Test")
        new_act.setShortcut("Ctrl+N")
        new_act.triggered.connect(self.start_new_test)
        file_menu.addSeparator()
        exit_act = file_menu.addAction("E&xit")
        exit_act.triggered.connect(self.close)
        help_menu = self.menuBar().addMenu("&Help")
        about_act = help_menu.addAction("&About")
        about_act.triggered.connect(self._show_about)

    def _show_about(self):
        from PyQt5.QtWidgets import QMessageBox

        name = self.windowTitle()
        footer = ""
        if self.options_manager is not None:
            footer = self.options_manager.get_setting(
                "branding", "footer_text") or ""
        QMessageBox.about(
            self, f"About {name}",
            f"{name}\nVideo quality assessment on CUDA (pqa2_tpu_torch, "
            f"device {self.device})\n{footer}",
        )

    # -- cross-tab state -----------------------------------------------------

    def current_test_name(self) -> str:
        return self.setup_tab.test_name_edit.text() or "Test"

    def current_test_dir(self) -> str:
        if self._test_timestamp is None:
            self._test_timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        if self.file_manager is not None:
            return self.file_manager.get_test_dir(
                self.current_test_name(), self._test_timestamp
            )
        import os

        d = f"{self.current_test_name()}_{self._test_timestamp}"
        os.makedirs(d, exist_ok=True)
        return d

    def handle_capture_finished(self, success: bool, path: str):
        """Capture -> analysis handoff (app/ui/main_window.py:154-194)."""
        if success:
            self.analysis_tab.set_capture_path(path)
            self.tabs.setCurrentWidget(self.analysis_tab)
            self.statusBar().showMessage("Capture complete — ready to analyze")
        else:
            self.statusBar().showMessage(f"Capture failed: {path}")

    def start_new_test(self):
        """State reset (app/ui/main_window.py:258-285)."""
        self.reference_info = None
        self._test_timestamp = None
        self.analysis_tab.capture_path = None
        self.setup_tab.info_text.clear()
        self.setup_tab.ref_path_label.setText("No reference selected")
        self.tabs.setCurrentWidget(self.setup_tab)

    def closeEvent(self, event):
        """Thread/file cleanup on close (app/ui/main_window.py:230-256)."""
        try:
            if self.capture_manager is not None:
                self.capture_manager.stop_capture()
                self.capture_manager.stop_preview()
            th = self.analysis_tab._workflow_thread
            if th is not None and th.is_alive():
                th.terminate()  # cooperative analyzer abort
                th.join(timeout=3.0)
            if self.file_manager is not None:
                self.file_manager.cleanup_temp_files()
        except Exception:
            logger.exception("cleanup on close failed")
        event.accept()
