# Copy of pqa2_tpu/align/bookend.py with its imports pointed at this package
# and a ``device`` for the statistics pass.
"""White-bookend detection (host-side decision logic over batched stats).

Behavioural port of the reference's detector (app/bookend_alignment.py:755-1134):
adaptive brightness thresholds with a 3-step fallback cascade, white-frame
criteria combining mean brightness, frame uniformity (std-dev) and
white-pixel-ratio, minimum-run filtering, and a begin/end fallback when fewer
than two bookends are found. The per-frame evidence comes from ONE batched
device pass (align.stats) instead of the reference's sampled OpenCV rescans,
so every frame is classified at full precision in a single sweep.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.stats import frame_luma_stats, white_ratio

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BookendConfig:
    """Knobs mirroring the reference's bookend settings category
    (app/options_manager.py:40-54)."""

    white_threshold: float = 200.0
    adaptive_brightness: bool = True
    min_white_frames: Optional[int] = None  # default: max(3, 0.1s of frames)
    fallback_to_full_video: bool = True
    white_ratio_threshold: float = 0.7
    frame_offset: int = 3  # carried through to alignment


@dataclasses.dataclass
class Bookend:
    start_frame: int
    end_frame: int  # inclusive
    brightness: float
    std_dev: float
    is_fallback: bool = False

    @property
    def frame_count(self) -> int:
        return self.end_frame - self.start_frame + 1

    def start_time(self, fps: float) -> float:
        return self.start_frame / fps

    def end_time(self, fps: float) -> float:
        return self.end_frame / fps


def _thresholds(cfg: BookendConfig, mean: np.ndarray, std_of_means: float) -> List[float]:
    """The reference's 3-step cascade (bookend_alignment.py:818-860)."""
    if cfg.adaptive_brightness:
        avg_b = float(mean.mean())
        max_b = float(mean.max())
        dyn = max(avg_b + 2.0 * std_of_means, max_b * 0.85, 180.0)
        if max_b > 240.0:
            dyn = max(dyn, 220.0)
        elif max_b < 200.0:
            dyn = max(avg_b + 1.5 * std_of_means, 160.0)
        return [dyn, dyn * 0.9, max(avg_b + 20.0, 160.0)]
    t = cfg.white_threshold
    return [t, t * 0.9, t * 0.8]


def _classify_white(
    mean: np.ndarray,
    std: np.ndarray,
    ratio: np.ndarray,
    threshold: float,
    std_dev_threshold: float,
    ratio_threshold: float,
) -> np.ndarray:
    """Per-frame white decision (the reference's fine-scan criteria,
    bookend_alignment.py:1000-1020): uniform frames pass at 0.95*t; busy
    frames need full threshold, or 0.9*t with >=70% white pixels."""
    uniform = std < std_dev_threshold * 1.2
    white_uniform = uniform & (mean > threshold * 0.95)
    white_busy = ~uniform & (
        (mean > threshold)
        | ((mean > threshold * 0.9) & (ratio > ratio_threshold))
    )
    return white_uniform | white_busy


def _runs(mask: np.ndarray) -> List[tuple]:
    """Consecutive True runs -> [(start, end_inclusive)]."""
    if not mask.any():
        return []
    idx = np.flatnonzero(mask)
    splits = np.flatnonzero(np.diff(idx) > 1)
    starts = np.concatenate([[idx[0]], idx[splits + 1]])
    ends = np.concatenate([idx[splits], [idx[-1]]])
    return list(zip(starts.tolist(), ends.tolist()))


class BookendDetector:
    """Detect white bookend sections in a captured clip."""

    def __init__(self, config: Optional[BookendConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or BookendConfig()
        self.device = device

    def detect(self, luma: Optional[np.ndarray], fps: float = 30.0,
               stats=None) -> List[Bookend]:
        """(N, H, W) luma -> bookend list (>= 2 entries unless fallback off).

        ``stats``: optionally the precomputed frame_luma_stats dict (the
        combined alignment pass shares one stats+thumbnails device trip).
        With stats given, ``luma`` may be None — detection is stats-only
        (the streamed alignment path never materialises the clip)."""
        cfg = self.config
        if stats is None:
            stats = frame_luma_stats(luma, device=self.device)
        n = luma.shape[0] if luma is not None else stats["mean"].shape[0]
        mean, std = stats["mean"], stats["std"]

        min_white = cfg.min_white_frames
        if min_white is None:
            min_white = max(3, int(0.1 * fps)) if fps > 25 else 3

        std_of_means = float(mean.std())
        avg_std_dev = float(std.mean())
        std_dev_threshold = min(45.0, avg_std_dev * 1.8)
        thresholds = _thresholds(cfg, mean, std_of_means)
        logger.info(
            "bookend detect: %d frames, thresholds %s, min_run %d",
            n, [round(t, 1) for t in thresholds], min_white,
        )

        for threshold in thresholds:
            ratio = white_ratio(stats, threshold)
            mask = _classify_white(
                mean, std, ratio, threshold, std_dev_threshold,
                cfg.white_ratio_threshold,
            )
            bookends = [
                Bookend(
                    start_frame=s,
                    end_frame=e,
                    brightness=float(mean[s : e + 1].mean()),
                    std_dev=float(std[s : e + 1].mean()),
                )
                for s, e in _runs(mask)
                if e - s + 1 >= min_white
            ]
            if len(bookends) >= 2:
                logger.info(
                    "found %d bookends at threshold %.1f",
                    len(bookends), threshold,
                )
                return bookends

        logger.warning("fewer than two bookends found at any threshold")
        if cfg.fallback_to_full_video and n >= 2:
            # Reference fallback: synthesise begin/end bookends
            # (bookend_alignment.py:1096-1124).
            k = min(5, n - 1)
            return [
                Bookend(0, k, 0.0, 0.0, is_fallback=True),
                Bookend(max(0, n - 1 - k), n - 1, 0.0, 0.0, is_fallback=True),
            ]
        return []


def detect_bookends(
    luma: np.ndarray, fps: float = 30.0, config: Optional[BookendConfig] = None,
    *, device: Union[str, torch.device] = "cuda",
) -> List[Bookend]:
    return BookendDetector(config, device).detect(luma, fps)
