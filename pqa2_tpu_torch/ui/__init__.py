# Copy of pqa2_tpu/ui/__init__.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Desktop GUI (PyQt5).

Rebuild of the reference's 6-tab wizard (app/ui/, SURVEY.md L5): MainWindow
hosting Setup / Capture / Analysis / Results / Options / Help tabs wired to
the engine managers via their signal channels. PyQt5 is an optional
dependency — everything engine-side runs headless (pqa2_tpu_torch.app, the CLI);
importing this package without PyQt5 raises a clear error.
"""

try:
    import PyQt5  # noqa: F401

    HAVE_QT = True
except ImportError:  # pragma: no cover - exercised only without PyQt5
    HAVE_QT = False

if HAVE_QT:
    from pqa2_tpu_torch.ui.main_window import MainWindow  # noqa: F401
    from pqa2_tpu_torch.ui.theme_manager import ThemeManager  # noqa: F401
else:  # pragma: no cover
    def _missing(*_a, **_k):
        raise ImportError(
            "PyQt5 is not installed; the GUI is unavailable. "
            "Use the CLI instead: python -m pqa2_tpu_torch.cli --help"
        )

    MainWindow = _missing  # type: ignore[assignment]
    ThemeManager = _missing  # type: ignore[assignment]
