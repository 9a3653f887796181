# Copy of pqa2_tpu/io/repair.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Input validation + salvage.

Rebuild of the reference's capture-file hygiene
(app/bookend_alignment.py:16-105): ``validate_video_file`` probes that a
clip opens and decodes; ``repair_video_file`` salvages what the reference
fixed with an ffmpeg moov-remux — here by re-writing every decodable frame
to a fresh lossless .y4m (the in-process equivalent; MAX_REPAIR_ATTEMPTS
bounds retries the same way)."""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

MAX_REPAIR_ATTEMPTS = 3


def validate_video_file(path: str) -> bool:
    """True if the file exists, probes, and its first frame decodes."""
    if not path or not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    try:
        from pqa2_tpu_torch.io.video import VideoReader

        with VideoReader(path) as r:
            if r.info.width <= 0 or r.info.height <= 0:
                return False
            return r.read_frame() is not None
    except Exception as e:
        logger.warning("validate_video_file(%s): %s", path, e)
        return False


def repair_video_file(path: str, output_path: Optional[str] = None) -> Optional[str]:
    """Salvage decodable frames into a fresh .y4m; None if nothing decodes.

    Reads until the first decode error and writes everything recovered —
    a truncated capture keeps its good prefix (the reference's remux served
    the same purpose for interrupted ffmpeg captures)."""
    from pqa2_tpu_torch.io.video import VideoReader
    from pqa2_tpu_torch.io.y4m import write_y4m

    if output_path is None:
        base, _ = os.path.splitext(path)
        output_path = f"{base}_repaired.y4m"
    frames = []
    fps = 30.0
    try:
        with VideoReader(path) as r:
            fps = r.info.frame_rate or 30.0
            while True:
                try:
                    fr = r.read_frame()
                except Exception as e:
                    logger.warning("repair: stopping at frame %d (%s)",
                                   len(frames), e)
                    break
                if fr is None:
                    break
                frames.append(fr)
    except Exception as e:
        logger.error("repair_video_file(%s): unreadable (%s)", path, e)
        return None
    if not frames:
        return None
    write_y4m(output_path, frames, fps=(int(round(fps * 1000)), 1000))
    logger.info("repaired %s -> %s (%d frames)", path, output_path, len(frames))
    return output_path
