# Port of pqa2_tpu/utils/logs.py: the same handlers and format, under the
# port's own directory and logger name.
"""Logging setup mirroring the reference's channel layout.

Console + per-user logfile (the reference logs to
%APPDATA%/ChromaPQA/logs/vmaf_app.log, main.py:12-24; here the POSIX
equivalent under ~/.pqa2_tpu_torch/logs)."""

from __future__ import annotations

import logging
import os
from typing import Optional


def default_log_dir() -> str:
    base = os.environ.get("APPDATA") or os.path.expanduser("~/.pqa2_tpu_torch")
    return os.path.join(base, "logs")


def setup_logging(
    level: int = logging.INFO, log_dir: Optional[str] = None
) -> logging.Logger:
    log_dir = log_dir or default_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    handlers: list = [logging.StreamHandler()]
    try:
        handlers.append(
            logging.FileHandler(os.path.join(log_dir, "vmaf_app.log"))
        )
    except OSError:
        pass
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
    return logging.getLogger("pqa2_tpu_torch")
