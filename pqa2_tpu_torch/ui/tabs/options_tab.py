# Copy of pqa2_tpu/ui/tabs/options_tab.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""OptionsTab — settings UI over OptionsManager.

Rebuild of app/ui/tabs/options_tab.py (General :79-193, Capture :194-344,
Analysis :345-469, Advanced :471-623, plus the TPU category) — rendered
from the declarative schema in ui/controllers/options_schema.py instead of
~1.6 kLoC of per-widget wiring. The binding (load/save/coerce and the
schema-to-settings-tree consistency) is Qt-free and tested; this widget
only maps field kinds to Qt editors.
"""

from __future__ import annotations

from PyQt5.QtCore import Qt
from PyQt5.QtWidgets import (
    QCheckBox, QComboBox, QDoubleSpinBox, QFormLayout, QHBoxLayout, QLabel,
    QLineEdit, QPushButton, QSlider, QSpinBox, QTabWidget, QVBoxLayout,
    QWidget,
)

from pqa2_tpu_torch.ui.controllers.options_schema import (
    TABS, coerce, fields_for_tab, load_values, save_values,
)


class OptionsTab(QWidget):
    def __init__(self, parent):
        super().__init__()
        self.parent = parent
        self.om = parent.options_manager
        self._editors = {}  # (category, key) -> (field, get, set)
        self._setup_ui()
        self.load_settings()

    def _setup_ui(self):
        layout = QVBoxLayout(self)
        self.sub_tabs = QTabWidget()
        for tab in TABS:
            self.sub_tabs.addTab(self._build_tab(tab), tab)
        layout.addWidget(self.sub_tabs)
        btns = QHBoxLayout()
        save_btn = QPushButton("Save settings")
        save_btn.clicked.connect(self.save_settings)
        reset_btn = QPushButton("Reset to defaults")
        reset_btn.clicked.connect(self.reset_defaults)
        btns.addWidget(save_btn)
        btns.addWidget(reset_btn)
        layout.addLayout(btns)

    def _build_tab(self, tab: str) -> QWidget:
        w = QWidget()
        form = QFormLayout(w)
        for field in fields_for_tab(tab):
            editor, getter, setter, row = self._make_editor(field)
            self._editors[(field.category, field.key)] = (field, getter, setter)
            if field.kind == "bool":
                form.addRow(row or editor)
            else:
                form.addRow(f"{field.label}:", row or editor)
        return w

    def _make_editor(self, field):
        """Field kind -> (widget, get, set, optional-row-layout)."""
        kind = field.kind
        if (field.category, field.key) == ("capture", "format_code"):
            return self._make_format_editor(field)
        if (field.category, field.key) == ("capture", "default_device"):
            return self._make_device_editor(field)
        if kind == "bool":
            cb = QCheckBox(field.label)
            return cb, cb.isChecked, cb.setChecked, None
        if kind == "int":
            sp = QSpinBox()
            sp.setRange(int(field.lo or 0), int(field.hi or 1 << 30))
            return sp, sp.value, lambda v: sp.setValue(int(v or 0)), None
        if kind == "float":
            sp = QDoubleSpinBox()
            sp.setRange(float(field.lo or 0.0), float(field.hi or 1e9))
            if field.step:
                sp.setSingleStep(field.step)
            return sp, sp.value, lambda v: sp.setValue(float(v or 0.0)), None
        if kind == "slider":
            sl = QSlider(Qt.Horizontal)
            sl.setRange(int(field.lo or 0), int(field.hi or 100))
            lbl = QLabel("")
            sl.valueChanged.connect(lambda v: lbl.setText(str(v)))
            row = QHBoxLayout()
            row.addWidget(sl)
            row.addWidget(lbl)
            return sl, sl.value, lambda v: sl.setValue(int(v or 0)), row
        if kind in ("choice", "model"):
            combo = QComboBox()
            if kind == "model":
                from pqa2_tpu_torch.models.registry import available_models

                combo.addItems(available_models() or ["vmaf_v0.6.1"])
            else:
                combo.addItems([str(c) for c in field.choices or ()])
            return (combo, combo.currentText,
                    lambda v: combo.setCurrentText(str(v)), None)
        if kind in ("dir", "file"):
            return self._make_path_editor(field)
        edit = QLineEdit()
        return edit, edit.text, lambda v: edit.setText(str(v or "")), None

    def _make_path_editor(self, field):
        """dir/file kinds get a Browse... picker next to the line edit
        (reference options_tab.py:104-168 buttons, :1366-1431 dialogs)."""
        edit = QLineEdit()
        browse = QPushButton("Browse...")

        def run_browse(_=None):
            from PyQt5.QtWidgets import QFileDialog

            start = edit.text() or ""
            if field.kind == "dir":
                picked = QFileDialog.getExistingDirectory(
                    self, f"Select {field.label}", start)
            else:
                picked, _filter = QFileDialog.getOpenFileName(
                    self, f"Select {field.label}", start)
            if picked:
                edit.setText(picked)

        browse.clicked.connect(run_browse)
        if not hasattr(self, "_path_browse_buttons"):
            self._path_browse_buttons = {}
        self._path_browse_buttons[(field.category, field.key)] = browse
        row = QHBoxLayout()
        row.addWidget(edit)
        row.addWidget(browse)
        return edit, edit.text, lambda v: edit.setText(str(v or "")), row

    def _make_device_editor(self, field):
        """default_device gets the Refresh Devices flow (reference
        options_tab.py:200-211): editable combo + button that re-probes
        the DeckLink device list (app/devices.py, Intensity Shuttle
        fallback when probing finds nothing)."""
        combo = QComboBox()
        combo.setEditable(True)

        def run_refresh(_=None):
            from pqa2_tpu_torch.app.devices import get_decklink_devices

            current = combo.currentText()
            combo.clear()
            devices = get_decklink_devices()
            combo.addItems(devices)
            if current:
                combo.setCurrentText(current)
            self.parent.statusBar().showMessage(
                f"{len(devices)} capture device(s) found")

        refresh = QPushButton("Refresh devices")
        refresh.clicked.connect(run_refresh)
        self._device_refresh_btn = refresh
        row = QHBoxLayout()
        row.addWidget(combo)
        row.addWidget(refresh)
        return (combo, combo.currentText,
                lambda v: combo.setCurrentText(str(v or "")), row)

    def _make_format_editor(self, field):
        """format_code gets the interactive per-device detection flow
        (reference options_tab.py:625-970): editable combo + Detect button
        that enumerates the selected device's modes and applies the pick
        to the capture settings (ui/controllers/formats.py)."""
        combo = QComboBox()
        combo.setEditable(True)
        detect = QPushButton("Detect formats")
        src_lbl = QLabel("")
        self._format_rows = []

        self._format_populating = False

        def run_detect(_=None):
            from pqa2_tpu_torch.ui.controllers import formats as fc

            device = None
            dev_editor = self._editors.get(("capture", "default_device"))
            if dev_editor is not None:
                device = dev_editor[1]() or None
            rows, source = fc.detect_formats(device)
            self._format_rows = rows
            current = combo.currentText()
            self._format_populating = True
            try:
                combo.clear()
                for fmt in rows:
                    combo.addItem(fc.format_display(fmt), fmt)
                if current:
                    self._set_format_value(combo, current)
            finally:
                self._format_populating = False
            src_lbl.setText(
                f"{len(rows)} modes ({'probed' if source == 'probe' else 'fallback table'})")

        def on_pick(idx):
            from pqa2_tpu_torch.ui.controllers import formats as fc

            # Populate-time index churn must not auto-apply a format.
            if self._format_populating:
                return
            if 0 <= idx < len(self._format_rows) and self.om is not None:
                fc.apply_format(self.om, self._format_rows[idx])
                self.parent.statusBar().showMessage(
                    f"Capture format set: {self._format_rows[idx].get('id')}")

        detect.clicked.connect(run_detect)
        combo.currentIndexChanged.connect(on_pick)
        row = QHBoxLayout()
        row.addWidget(combo)
        row.addWidget(detect)
        row.addWidget(src_lbl)

        def getter():
            fmt = combo.currentData()
            if isinstance(fmt, dict):
                return str(fmt.get("id", ""))
            return combo.currentText().split(" — ")[0].strip()

        def setter(v):
            # Programmatic selection (load_settings / reset_defaults) must
            # not fire on_pick's apply_format — that would write capture
            # settings back as a side effect of loading them, partially
            # undoing a reset. Only a user pick applies.
            self._format_populating = True
            try:
                self._set_format_value(combo, str(v or ""))
            finally:
                self._format_populating = False

        return (combo, getter, setter, row)

    @staticmethod
    def _set_format_value(combo, code: str):
        for i in range(combo.count()):
            data = combo.itemData(i)
            if isinstance(data, dict) and data.get("id") == code:
                combo.setCurrentIndex(i)
                return
        combo.setEditText(code) if hasattr(combo, "setEditText") else None

    # -- load/save -----------------------------------------------------------

    def load_settings(self):
        if self.om is None:
            return
        values = load_values(self.om)
        for key, value in values.items():
            if key in self._editors and value is not None:
                self._editors[key][2](value)

    def save_settings(self):
        if self.om is None:
            return
        values = {}
        for key, (field, getter, _) in self._editors.items():
            values[key] = coerce(field, getter())
        save_values(self.om, values)
        self.parent.statusBar().showMessage("Settings saved")

    def reset_defaults(self):
        if self.om is not None:
            self.om.reset_to_defaults()
            self.load_settings()
