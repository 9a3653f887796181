"""Combined capture -> align -> score workflow, decoded once (port of
pqa2_tpu/app/workflow.py).

The reference runs this as the AnalysisTab "combined workflow": bookend
alignment writes trimmed videos to disk and the analyzer re-reads them. Here
the capture and reference files are decoded ONCE and each clip's luma
crosses the host -> device link once: the alignment statistics read the
uploaded tensors, and scoring takes the aligned windows of the same tensors
as views (``VMAFAnalyzer.analyze_frames(ref_y=, dist_y=)``). The aligned
.y4m artifacts are written on a background thread while the device scores.
Inputs past the memory budget take the two-pass path: streamed alignment,
trims written frame by frame, then the streaming analyzer.

Engine-only module: no Qt. The CLI drives it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.motioncomp import compensate, estimate_shifts
from pqa2_tpu_torch.align.streamed import streamed_align, write_trim
from pqa2_tpu_torch.align.temporal import align_bookend_clips
from pqa2_tpu_torch.app.bookend_aligner import AlignmentState, BookendAligner
from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
from pqa2_tpu_torch.io.video import VideoReader
from pqa2_tpu_torch.io.y4m import write_y4m
from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

logger = logging.getLogger(__name__)


def _decode(path: str):
    with VideoReader(path) as r:
        info = r.info
        frames = list(r)
    if not frames:
        raise ValueError(f"empty input video: {path}")
    return info, frames


def _estimated_decoded_bytes(*paths) -> Optional[int]:
    """Sum of decoded YUV420 sizes, from container metadata (None if any
    probe lacks a frame count — then the in-memory path proceeds and
    ordinary decode errors surface normally)."""
    total = 0
    for p in paths:
        try:
            with VideoReader(p) as r:
                info = r.info
        except Exception:
            return None
        if not info.frame_count:
            return None
        itemsize = 2 if info.bit_depth > 8 else 1
        total += int(info.frame_count * info.width * info.height * 1.5
                     * itemsize)
    return total


def _run_two_pass(reference_path, captured_path, *, aligner, analyzer,
                  model, duration, t_start, device):
    """Bounded-memory fallback for oversized inputs: streamed alignment
    (align/streamed.py — one chunk resident at a time, its statistics on
    ``device``), frame-by-frame trim writes, then the streaming analyzer.
    Same result shape as the in-memory path; peak host memory is ~one chunk
    regardless of length."""
    aligner.state = AlignmentState.RUNNING
    try:
        aligner.status_update.emit(
            "Starting white bookend alignment process (streamed)...")
        aligner.alignment_progress.emit(10)
        result, ref_info, cap_info = streamed_align(
            reference_path, captured_path, config=aligner._config(), device=device)
        aligner.alignment_progress.emit(60)
        aligner.status_update.emit("Creating aligned videos...")

        if aligner._motion_compensation_enabled():
            # The streamed path never holds both windows in memory, so
            # per-frame shift estimation is unavailable: say so instead of
            # silently skipping.
            msg = ("Motion compensation is enabled but unavailable on the "
                   "streamed (oversized-input) path; proceeding without it.")
            logger.warning(msg)
            aligner.status_update.emit(msg)
        r0, r1 = result.ref_range
        c0, c1 = result.cap_range
        if duration:
            # Per-clip frame rates: when ref and capture rates differ the
            # same wall-clock cap covers different frame counts.
            ref_n = int(round(duration * (ref_info.frame_rate or 30.0)))
            cap_n = int(round(duration * (cap_info.frame_rate or 30.0)))
            r1 = min(r1, r0 + ref_n)
            c1 = min(c1, c0 + cap_n)
        base_dir = os.path.dirname(captured_path) or "."
        base = os.path.splitext(os.path.basename(captured_path))[0]
        aligned_ref = os.path.join(base_dir, f"{base}_ref_aligned.y4m")
        aligned_cap = os.path.join(base_dir, f"{base}_aligned.y4m")
        fps_pair = (int(round((ref_info.frame_rate or 30.0) * 1000)), 1000)
        write_trim(reference_path, aligned_ref, r0, r1, fps=fps_pair)
        write_trim(captured_path, aligned_cap, c0, c1, fps=fps_pair)

        alignment = {
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
                "motion_compensated": False,
            },
            "ref_range": [r0, r1],
            "cap_range": [c0, c1],
            "is_fallback": result.is_fallback,
        }
        aligner.state = AlignmentState.COMPLETE
        aligner.alignment_progress.emit(100)
        aligner.status_update.emit("White bookend alignment complete!")
        aligner.alignment_complete.emit(alignment)
    except Exception as e:
        aligner.state = AlignmentState.ERROR
        logger.exception("streamed alignment failed")
        aligner.error_occurred.emit(f"Error in bookend alignment: {e}")
        return None

    analysis = analyzer.analyze_videos(
        alignment["aligned_reference"], alignment["aligned_captured"],
        model=model,
    )
    if analysis is None:
        return None

    if aligner.delete_capture_after_alignment:
        # Parity with the in-memory branch: the original capture is deleted
        # once the aligned artifacts exist.
        try:
            os.remove(captured_path)
        except OSError as e:
            logger.warning("could not delete capture: %s", e)

    return {
        "alignment": alignment,
        "analysis": analysis,
        "wall_seconds": round(time.perf_counter() - t_start, 3),
    }


def _shift_depth(frames: List[Dict], from_depth: int, to_depth: int):
    """Exact depth promotion (<< diff) so both clips score on one scale."""
    if from_depth == to_depth:
        return frames
    shift = to_depth - from_depth
    return [
        {k: (v.astype(np.uint16) << shift) for k, v in f.items()}
        for f in frames
    ]


def run_combined_workflow(
    reference_path: str,
    captured_path: str,
    *,
    options_manager=None,
    out_dir: Optional[str] = None,
    model: Optional[str] = None,
    test_name: Optional[str] = None,
    aligner=None,
    analyzer=None,
    write_aligned: bool = True,
    duration: Optional[float] = None,
    max_in_memory_bytes: int = 2 << 30,
    device: Union[str, torch.device] = "cuda",
) -> Optional[Dict]:
    """Decode-once bookend workflow on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; a missing card raises here). Returns
    ``{"alignment": <BookendAligner-shaped dict>, "analysis":
    <VMAFAnalyzer-shaped dict>, "wall_seconds": float}`` or None on failure
    (errors are emitted on the aligner/analyzer error signals, mirroring the
    reference tab's behavior).

    ``aligner``/``analyzer`` instances are optional — pass them to receive
    progress/status/complete signals; fresh engine instances on ``device``
    are created otherwise. A given analyzer scores on its own device.

    Inputs whose decoded size exceeds ``max_in_memory_bytes`` (default 2 GB;
    e.g. minutes of 4K) fall back to the two-pass path — BookendAligner
    trims to disk, the streaming analyzer scores with bounded host memory —
    trading the decode-once speedup for a flat memory ceiling.
    """
    device = resolve_device(device)
    t_start = time.perf_counter()
    aligner = aligner or BookendAligner(options_manager, device=device)
    analyzer = analyzer or VMAFAnalyzer(options_manager, device=device)
    if out_dir:
        analyzer.set_output_directory(out_dir)
    if test_name:
        analyzer.set_test_name(test_name)

    est = _estimated_decoded_bytes(reference_path, captured_path)
    if est is not None and est > max_in_memory_bytes:
        logger.info(
            "inputs decode to ~%.1f GB > %.1f GB budget; using the "
            "two-pass streaming path", est / 1e9, max_in_memory_bytes / 1e9)
        return _run_two_pass(
            reference_path, captured_path, aligner=aligner,
            analyzer=analyzer, model=model, duration=duration,
            t_start=t_start, device=device)

    aligner.state = AlignmentState.RUNNING
    try:
        aligner.status_update.emit("Starting white bookend alignment process...")
        for p in (reference_path, captured_path):
            if not os.path.exists(p):
                raise FileNotFoundError(f"video file not found: {p}")
        aligner.alignment_progress.emit(10)

        ref_info, ref_frames = _decode(reference_path)
        cap_info, cap_frames = _decode(captured_path)
        depth = max(ref_info.bit_depth, cap_info.bit_depth)
        ref_frames = _shift_depth(ref_frames, ref_info.bit_depth, depth)
        cap_frames = _shift_depth(cap_frames, cap_info.bit_depth, depth)

        aligner.status_update.emit(
            "Detecting white bookend frames in captured video...")
        aligner.alignment_progress.emit(30)
        ref_luma = np.stack([f["y"] for f in ref_frames])
        cap_luma = np.stack([f["y"] for f in cap_frames])
        # Each luma batch crosses the host->device link exactly ONCE per
        # workflow, on the 8-bit scale the detection thresholds are defined
        # on (>8-bit codes are divided on the device): alignment statistics
        # read these tensors, and scoring later takes its aligned windows of
        # the same buffers as views (pipeline/scoring.py ref_y/dist_y).
        div = float(1 << (depth - 8))
        ref_dev = upload(ref_luma, device, div)
        cap_dev = upload(cap_luma, device, div)
        del ref_luma, cap_luma
        result = align_bookend_clips(
            ref_dev, cap_dev,
            fps=cap_info.frame_rate or 30.0,
            config=aligner._config(),
            device=device,
        )
        aligner.alignment_progress.emit(60)

        r0, r1 = result.ref_range
        c0, c1 = result.cap_range
        if duration:
            # Analysis-duration cap (the reference passes the setup tab's
            # duration through to the analyzer). Per-clip frame rates: when
            # the reference and capture rates differ, the same wall-clock
            # span covers different frame counts.
            ref_n = int(round(duration * (ref_info.frame_rate or 30.0)))
            cap_n = int(round(duration * (cap_info.frame_rate or 30.0)))
            r1 = min(r1, r0 + ref_n)
            c1 = min(c1, c0 + cap_n)
        ref_window = ref_frames[r0:r1]
        cap_window = cap_frames[c0:c1]

        # Device-resident luma windows for scoring (no second upload);
        # invalidated below if motion compensation rewrites the frames.
        score_ref_y = ref_dev[r0:r1]
        score_dist_y = cap_dev[c0:c1]

        motion_compensated = False
        if aligner._motion_compensation_enabled():
            aligner.status_update.emit("Applying motion compensation...")
            shifts = estimate_shifts(score_ref_y, score_dist_y, device=device)
            if np.any(shifts != 0):
                cap_window = [
                    {
                        "y": compensate(f["y"][None], s[None])[0],
                        "u": compensate(f["u"][None], (s // 2)[None])[0],
                        "v": compensate(f["v"][None], (s // 2)[None])[0],
                    }
                    for f, s in zip(cap_window, shifts)
                ]
                score_dist_y = None  # frames rewritten on host
            motion_compensated = True

        # Aligned .y4m artifacts (the contract the reference fulfils with
        # re-encoded trims) are written while the device scores.
        base_dir = os.path.dirname(captured_path) or "."
        base = os.path.splitext(os.path.basename(captured_path))[0]
        aligned_ref = os.path.join(base_dir, f"{base}_ref_aligned.y4m")
        aligned_cap = os.path.join(base_dir, f"{base}_aligned.y4m")
        fps_pair = (int(round((ref_info.frame_rate or 30.0) * 1000)), 1000)
        writer_err: List[Exception] = []

        colorspace = "C420mpeg2" if depth == 8 else f"C420p{depth}"

        def _write_artifacts():
            try:
                write_y4m(aligned_ref, ref_window, fps=fps_pair,
                          colorspace=colorspace)
                write_y4m(aligned_cap, cap_window, fps=fps_pair,
                          colorspace=colorspace)
            except Exception as e:  # surfaced after join
                writer_err.append(e)

        writer = None
        if write_aligned:
            writer = threading.Thread(target=_write_artifacts, daemon=True)
            writer.start()

        alignment = {
            "alignment_method": "bookend",
            "offset_frames": result.offset_frames,
            "offset_seconds": result.offset_seconds,
            "confidence": result.confidence,
            "aligned_reference": aligned_ref if write_aligned else None,
            "aligned_captured": aligned_cap if write_aligned else None,
            "bookend_info": {
                "first_bookend": dataclasses.asdict(result.bookends[0]),
                "last_bookend": dataclasses.asdict(result.bookends[-1]),
                "content_duration": result.content_duration,
                "motion_compensated": motion_compensated,
            },
            "ref_range": [r0, r1],
            "cap_range": [c0, c1],
            "is_fallback": result.is_fallback,
        }
        aligner.state = AlignmentState.COMPLETE
        aligner.alignment_progress.emit(100)
        aligner.status_update.emit("White bookend alignment complete!")
        aligner.alignment_complete.emit(alignment)
    except Exception as e:
        aligner.state = AlignmentState.ERROR
        logger.exception("alignment failed")
        aligner.error_occurred.emit(f"Error in bookend alignment: {e}")
        return None

    analysis = analyzer.analyze_frames(
        ref_window,
        cap_window,
        fps=cap_info.frame_rate or 30.0,
        model=model,
        reference_name=aligned_ref,
        distorted_name=aligned_cap,
        bit_depth=depth,
        ref_y=score_ref_y,
        dist_y=score_dist_y,
    )
    if writer is not None:
        writer.join()
        if writer_err:
            logger.warning("aligned artifact write failed: %s", writer_err[0])
    if analysis is None:
        return None

    if aligner.delete_capture_after_alignment:
        try:
            os.remove(captured_path)
        except OSError as e:
            logger.warning("could not delete capture: %s", e)

    return {
        "alignment": alignment,
        "analysis": analysis,
        "wall_seconds": round(time.perf_counter() - t_start, 3),
    }


class CombinedWorkflowThread(threading.Thread):
    """Thread wrapper for the decode-once workflow with both engines'
    signal channels exposed — the engine-side replacement for the
    reference AnalysisTab's BookendAlignmentThread -> VMAFAnalysisThread
    chain."""

    def __init__(self, reference_path: str, captured_path: str, *,
                 model: Optional[str] = None, out_dir: Optional[str] = None,
                 test_name: Optional[str] = None, options_manager=None,
                 duration: Optional[float] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(daemon=True)
        self.aligner = BookendAligner(options_manager, device)
        self.analyzer = VMAFAnalyzer(options_manager, device=self.aligner.device)
        # Re-expose the channels at thread level, like the reference threads.
        self.alignment_progress = self.aligner.alignment_progress
        self.alignment_complete = self.aligner.alignment_complete
        self.status_update = self.aligner.status_update
        self.error_occurred = self.aligner.error_occurred
        self.analysis_progress = self.analyzer.analysis_progress
        self.analysis_complete = self.analyzer.analysis_complete
        self.analysis_failed = self.analyzer.analysis_failed
        self.analysis_status = self.analyzer.status_update
        self._args = dict(
            model=model, out_dir=out_dir, test_name=test_name,
            duration=duration, device=self.aligner.device,
        )
        self._paths = (reference_path, captured_path)
        self.result: Optional[Dict] = None

    def run(self):
        self.result = run_combined_workflow(
            *self._paths, aligner=self.aligner, analyzer=self.analyzer,
            **self._args,
        )

    def terminate(self):
        self.analyzer.terminate_analysis()
