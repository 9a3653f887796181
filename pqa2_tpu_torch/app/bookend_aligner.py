"""BookendAligner — engine façade over pqa2_tpu_torch.align (port of
pqa2_tpu/app/bookend_aligner.py).

The reference's signal channels (alignment_progress/alignment_complete/
error_occurred/status_update), ``align_bookend_videos(reference_path,
captured_path)`` and its result-dict keys. Detection is one batched pass on
the aligner's ``device``, and the "aligned videos" are written as lossless
.y4m trims.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.bookend import BookendConfig
from pqa2_tpu_torch.align.motioncomp import compensate, estimate_shifts
from pqa2_tpu_torch.align.temporal import align_bookend_clips
from pqa2_tpu_torch.io.video import VideoReader
from pqa2_tpu_torch.io.y4m import write_y4m
from pqa2_tpu_torch.pipeline.scoring import resolve_device
from pqa2_tpu_torch.utils.signals import Signal

logger = logging.getLogger(__name__)


class AlignmentState:
    """Mirror of the reference's AlignmentState enum
    (app/bookend_alignment.py:1380-1388)."""

    IDLE = "idle"
    RUNNING = "running"
    COMPLETE = "complete"
    ERROR = "error"


class BookendAligner:
    """White-bookend temporal alignment engine on ``device`` (``cuda``
    unless the caller asks for ``cpu``; a missing card raises here)."""

    def __init__(self, options_manager=None, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.alignment_progress = Signal(int, name="alignment_progress")
        self.alignment_complete = Signal(dict, name="alignment_complete")
        self.error_occurred = Signal(str, name="error_occurred")
        self.status_update = Signal(str, name="status_update")
        self.options_manager = options_manager
        self.state = AlignmentState.IDLE
        self.delete_capture_after_alignment = False

    def _motion_compensation_enabled(self) -> bool:
        if self.options_manager is None:
            return False
        b = self.options_manager.get_setting("bookend") or {}
        return bool(b.get("motion_compensation", False))

    def _config(self) -> BookendConfig:
        cfg = BookendConfig()
        if self.options_manager is not None:
            b = self.options_manager.get_setting("bookend") or {}
            cfg.white_threshold = float(b.get("white_threshold", cfg.white_threshold))
            cfg.adaptive_brightness = bool(
                b.get("adaptive_brightness", cfg.adaptive_brightness)
            )
            cfg.fallback_to_full_video = bool(
                b.get("fallback_to_full_video", cfg.fallback_to_full_video)
            )
            cfg.frame_offset = int(b.get("frame_offset", cfg.frame_offset))
        return cfg

    def align_bookend_videos(
        self, reference_path: str, captured_path: str
    ) -> Optional[Dict]:
        """Detect bookends in the capture, align to the reference, write
        aligned .y4m pair next to the capture. Result dict mirrors
        app/bookend_alignment.py:440-456."""
        self.state = AlignmentState.RUNNING
        try:
            self.status_update.emit("Starting white bookend alignment process...")
            for p in (reference_path, captured_path):
                if not os.path.exists(p):
                    raise FileNotFoundError(f"video file not found: {p}")
            self.alignment_progress.emit(10)

            import time as _time

            t0 = _time.perf_counter()
            with VideoReader(reference_path) as r:
                ref_info = r.info
                ref_frames = list(r)
            with VideoReader(captured_path) as r:
                cap_info = r.info
                cap_frames = list(r)
            if not ref_frames or not cap_frames:
                raise ValueError("empty input video")

            ref_luma = np.stack([f["y"] for f in ref_frames])
            cap_luma = np.stack([f["y"] for f in cap_frames])
            t1 = _time.perf_counter()
            self.status_update.emit(
                "Detecting white bookend frames in captured video..."
            )
            self.alignment_progress.emit(30)

            result = align_bookend_clips(
                ref_luma, cap_luma,
                fps=cap_info.frame_rate or 30.0,
                config=self._config(),
                device=self.device,
            )
            t2 = _time.perf_counter()
            logger.debug("align phases: decode %.2fs detect+select %.2fs",
                         t1 - t0, t2 - t1)
            self.alignment_progress.emit(60)
            self.status_update.emit("Creating aligned videos...")

            out_dir = os.path.dirname(captured_path) or "."
            base = os.path.splitext(os.path.basename(captured_path))[0]
            aligned_ref = os.path.join(out_dir, f"{base}_ref_aligned.y4m")
            aligned_cap = os.path.join(out_dir, f"{base}_aligned.y4m")
            fps_pair = (
                int(round((ref_info.frame_rate or 30.0) * 1000)), 1000
            )
            r0, r1 = result.ref_range
            c0, c1 = result.cap_range
            cap_window = cap_frames[c0:c1]

            motion_compensated = False
            if self._motion_compensation_enabled():
                # Flag-gated spatial compensation (N10): remove the capture
                # chain's global misregistration before scoring.
                self.status_update.emit("Applying motion compensation...")
                # The codes go up as they are; the correlation takes f32
                # on the device.
                ref_w = np.stack([f["y"] for f in ref_frames[r0:r1]])
                cap_w = np.stack([f["y"] for f in cap_window])
                shifts = estimate_shifts(ref_w, cap_w, device=self.device)
                if np.any(shifts != 0):
                    cap_window = [
                        {
                            "y": compensate(f["y"][None], s[None])[0],
                            "u": compensate(f["u"][None], (s // 2)[None])[0],
                            "v": compensate(f["v"][None], (s // 2)[None])[0],
                        }
                        for f, s in zip(cap_window, shifts)
                    ]
                motion_compensated = True

            write_y4m(aligned_ref, ref_frames[r0:r1], fps=fps_pair)
            write_y4m(aligned_cap, cap_window, fps=fps_pair)
            self.alignment_progress.emit(90)

            if self.delete_capture_after_alignment:
                # Reference deletes the original capture post-alignment
                # (app/bookend_alignment.py:1267-1289).
                try:
                    os.remove(captured_path)
                except OSError as e:
                    logger.warning("could not delete capture: %s", e)

            out = {
                "alignment_method": "bookend",
                "offset_frames": result.offset_frames,
                "offset_seconds": result.offset_seconds,
                "confidence": result.confidence,
                "aligned_reference": aligned_ref,
                "aligned_captured": aligned_cap,
                "bookend_info": {
                    "first_bookend": dataclasses.asdict(result.bookends[0]),
                    "last_bookend": dataclasses.asdict(result.bookends[-1]),
                    "content_duration": result.content_duration,
                    "motion_compensated": motion_compensated,
                },
                "ref_range": list(result.ref_range),
                "cap_range": list(result.cap_range),
                "is_fallback": result.is_fallback,
            }
            self.state = AlignmentState.COMPLETE
            self.alignment_progress.emit(100)
            self.status_update.emit("White bookend alignment complete!")
            self.alignment_complete.emit(out)
            return out
        except Exception as e:
            self.state = AlignmentState.ERROR
            logger.exception("alignment failed")
            self.error_occurred.emit(f"Error in bookend alignment: {e}")
            return None


class BookendAlignmentThread(threading.Thread):
    """Thread wrapper (app/bookend_alignment.py:1137-1305)."""

    def __init__(self, reference_path, captured_path, options_manager=None,
                 delete_capture=False, device: Union[str, torch.device] = "cuda"):
        super().__init__(daemon=True)
        self.aligner = BookendAligner(options_manager, device)
        self.aligner.delete_capture_after_alignment = delete_capture
        self.alignment_progress = self.aligner.alignment_progress
        self.alignment_complete = self.aligner.alignment_complete
        self.error_occurred = self.aligner.error_occurred
        self.status_update = self.aligner.status_update
        self._args = (reference_path, captured_path)
        self.result: Optional[Dict] = None

    def run(self):
        self.result = self.aligner.align_bookend_videos(*self._args)


# Facade name parity with app/bookend_alignment.py:1310-1378.
Aligner = BookendAligner
