# Copy of pqa2_tpu/ui/branding.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Branding asset resolution (Qt-free).

The reference hardcodes its bundled logo file as the window icon
(/root/reference/app/ui/main_window.py:196-228). Here the icon is
settings-driven (``branding.logo_path``) with the bundled
``pqa2_tpu_torch/assets/pqa2-logo.png`` as the default, so white-label
deployments re-brand via config alone (branding category:
app/options_manager.py).
"""

from __future__ import annotations

import os
from typing import Optional

_ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
DEFAULT_LOGO = os.path.join(_ASSETS_DIR, "pqa2-logo.png")


def resolve_logo_path(options_manager=None) -> Optional[str]:
    """The logo file to use as the window icon, or None.

    Order: ``branding.logo_path`` when set and readable, else the bundled
    default asset. A configured-but-missing path falls back (cosmetic,
    never fatal) — same degradation the reference applies to its missing
    logo file.
    """
    if options_manager is not None:
        path = options_manager.get_setting("branding", "logo_path") or ""
        if path and os.path.isfile(path):
            return path
    return DEFAULT_LOGO if os.path.isfile(DEFAULT_LOGO) else None
