# Copy of pqa2_tpu/ui/theme_manager.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""ThemeManager — light/dark/system/custom palettes.

Rebuild of app/ui/theme_manager.py:31-103: themes resolved from the
``branding`` settings category; qdarkstyle used for Dark when installed,
otherwise a hand-rolled dark palette."""

from __future__ import annotations

import logging

from PyQt5.QtGui import QColor, QPalette
from PyQt5.QtWidgets import QApplication

logger = logging.getLogger(__name__)


class ThemeManager:
    def __init__(self, app: QApplication, options_manager=None):
        self.app = app
        self.options_manager = options_manager

    def _branding(self):
        if self.options_manager is None:
            return {}
        return self.options_manager.get_setting("branding") or {}

    def apply_current_theme(self) -> None:
        theme = self._branding().get("selected_theme", "System")
        if theme == "Dark":
            self.apply_dark_theme()
        elif theme == "Light":
            self.apply_light_theme()
        elif theme == "Custom":
            self.apply_custom_theme()
        else:
            self.app.setPalette(self.app.style().standardPalette())

    def apply_light_theme(self) -> None:
        self.app.setStyleSheet("")
        self.app.setPalette(self.app.style().standardPalette())

    def apply_dark_theme(self) -> None:
        try:
            import qdarkstyle

            self.app.setStyleSheet(qdarkstyle.load_stylesheet_pyqt5())
            return
        except ImportError:
            pass
        palette = QPalette()
        bg = QColor(45, 45, 48)
        fg = QColor(255, 255, 255)
        palette.setColor(QPalette.Window, bg)
        palette.setColor(QPalette.WindowText, fg)
        palette.setColor(QPalette.Base, QColor(30, 30, 30))
        palette.setColor(QPalette.AlternateBase, bg)
        palette.setColor(QPalette.Text, fg)
        palette.setColor(QPalette.Button, bg)
        palette.setColor(QPalette.ButtonText, fg)
        palette.setColor(QPalette.Highlight, QColor(0, 122, 204))
        palette.setColor(QPalette.HighlightedText, fg)
        self.app.setPalette(palette)

    def apply_custom_theme(self) -> None:
        b = self._branding()
        palette = QPalette()
        palette.setColor(QPalette.Window, QColor(b.get("bg_color", "#2D2D30")))
        palette.setColor(QPalette.WindowText, QColor(b.get("text_color", "#FFFFFF")))
        palette.setColor(QPalette.Highlight, QColor(b.get("accent_color", "#007ACC")))
        self.app.setPalette(palette)
