"""ReferenceAnalyzer — reference-video metadata + bookend presence check
(port of pqa2_tpu/app/reference_analyzer.py).

``get_video_info`` probes metadata in-process (no ffprobe subprocess) and
``_check_for_bookends`` scans the first 30 frames for a >=85%-white frame,
through one batched stats pass on the analyzer's ``device``
(:mod:`pqa2_tpu_torch.align.stats`).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.stats import frame_luma_stats, white_ratio
from pqa2_tpu_torch.io.video import VideoReader
from pqa2_tpu_torch.pipeline.scoring import resolve_device
from pqa2_tpu_torch.utils.signals import Signal

logger = logging.getLogger(__name__)

BOOKEND_CHECK_FRAMES = 30
WHITE_RATIO_REQUIRED = 0.85
WHITE_LEVEL = 200


class ReferenceAnalyzer:
    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.analysis_progress = Signal(int, name="analysis_progress")
        self.analysis_complete = Signal(dict, name="analysis_complete")
        self.error_occurred = Signal(str, name="error_occurred")

    def get_video_info(self, video_path: str) -> Optional[Dict]:
        """Metadata + has_bookends flag (app/reference_analyzer.py:20-97)."""
        try:
            if not os.path.exists(video_path):
                raise FileNotFoundError(f"video file not found: {video_path}")
            self.analysis_progress.emit(10)
            with VideoReader(video_path) as r:
                info = r.info.as_dict()
                frames = []
                for i, fr in enumerate(r):
                    if i >= BOOKEND_CHECK_FRAMES:
                        break
                    frames.append(fr["y"])
            self.analysis_progress.emit(60)
            info["has_bookends"] = self._check_for_bookends(frames)
            self.analysis_progress.emit(100)
            self.analysis_complete.emit(info)
            return info
        except Exception as e:
            logger.exception("reference analysis failed")
            self.error_occurred.emit(f"Error analyzing reference video: {e}")
            return None

    def _check_for_bookends(self, lumas) -> bool:
        """True if any early frame is >=85% white pixels
        (app/reference_analyzer.py:112-151)."""
        if not lumas:
            return False
        stats = frame_luma_stats(np.stack(lumas), device=self.device)
        ratios = white_ratio(stats, WHITE_LEVEL)
        return bool(np.any(ratios >= WHITE_RATIO_REQUIRED))


class ReferenceAnalysisThread(threading.Thread):
    """Thread wrapper (app/reference_analyzer.py:154-172)."""

    def __init__(self, video_path: str, device: Union[str, torch.device] = "cuda"):
        super().__init__(daemon=True)
        self.analyzer = ReferenceAnalyzer(device)
        self.analysis_progress = self.analyzer.analysis_progress
        self.analysis_complete = self.analyzer.analysis_complete
        self.error_occurred = self.analyzer.error_occurred
        self.video_path = video_path
        self.info: Optional[Dict] = None

    def run(self):
        self.info = self.analyzer.get_video_info(self.video_path)
