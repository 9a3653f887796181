# Port of pqa2_tpu/main.py: the JAX platform pinning is gone; ``--device``
# chooses where the window's engines run, and the state checks are logged.
"""Application entry point.

Rebuild of the reference's main.py:30-82 — logging setup, manager
construction, MainWindow — launching the Qt GUI when PyQt5 is available and
pointing at the CLI otherwise. Run as ``python -m pqa2_tpu_torch.main``
(``--device cpu`` on a machine without a card: the engines' default is the
card, and nothing falls back to the CPU).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pqa2_tpu_torch.main",
                                 description="pqa2_tpu_torch desktop application")
    ap.add_argument("--device", default="cuda",
                    help="where the reference analysis and the align-and-score "
                         "workflow run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from pqa2_tpu_torch.utils.logs import setup_logging

    logger = setup_logging()

    from pqa2_tpu_torch.app.capture import CaptureManager
    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.utils import FileManager, validate_application_state

    options_manager = OptionsManager()
    # Point the model registry at the configured user models directory
    # (reference: "VMAF models directory" path setting + models/ dir scan,
    # app/ui/tabs/analysis_tab.py:1005-1077).
    from pqa2_tpu_torch.models.registry import set_user_models_dir

    set_user_models_dir(options_manager.get_setting("paths", "models_dir"))
    file_manager = FileManager()
    capture_manager = CaptureManager(options_manager=options_manager)

    checks = validate_application_state(options_manager, file_manager)
    logger.info("application state checks: %s", checks)
    if not checks["all_ok"]:
        logger.warning("application state checks failed: %s",
                       sorted(k for k, v in checks.items() if not v and k != "all_ok"))

    try:
        from PyQt5.QtWidgets import QApplication
    except ImportError:
        print(
            "PyQt5 is not installed — GUI unavailable.\n"
            "Use the CLI instead: python -m pqa2_tpu_torch.cli --help",
            file=sys.stderr,
        )
        return 2

    from pqa2_tpu_torch.ui.main_window import MainWindow
    from pqa2_tpu_torch.ui.theme_manager import ThemeManager

    app = QApplication(sys.argv[:1])
    theme = ThemeManager(app, options_manager)
    theme.apply_current_theme()
    window = MainWindow(capture_manager, file_manager, options_manager,
                        device=args.device)
    # Attached so settings saves re-apply the theme live
    # (MainWindow._on_settings_updated).
    window.theme_manager = theme
    window.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(main())
