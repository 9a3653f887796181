"""VMAFAnalyzer — the scoring engine facade (port of pqa2_tpu/app/vmaf_analyzer.py).

Same signal channels, the same settings (``options_manager``,
:meth:`VMAFAnalyzer.set_options_from_manager`), the same entry points
(``analyze_videos(reference, distorted, model, duration)`` and the
in-memory ``analyze_frames``), the same results-dict keys and on-disk
artifacts (``*_vmaf.json`` in the libvmaf schema, ``*_psnr.txt`` /
``*_ssim.txt`` in ffmpeg's stats_file line format), and
:class:`VMAFAnalysisThread`. Files score through
:func:`pqa2_tpu_torch.pipeline.streaming.stream_score`, decoded frames
through :func:`pqa2_tpu_torch.pipeline.scoring.score_planes`, both on the
analyzer's ``device``.
"""

from __future__ import annotations

import logging
import os
import threading
from datetime import datetime
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.io.video import probe_video
from pqa2_tpu_torch.utils.profiling import ThroughputMeter
from pqa2_tpu_torch.utils.signals import Signal
from pqa2_tpu_torch.pipeline.json_out import write_vmaf_json
from pqa2_tpu_torch.pipeline.scoring import ClipScores, pool_metric, score_planes
from pqa2_tpu_torch.pipeline.streaming import stream_score

logger = logging.getLogger(__name__)


def _fmt(v: float, nd: int = 6) -> str:
    """ffmpeg-style float formatting: 'inf' for infinite values."""
    if not np.isfinite(v):
        return "inf"
    return f"{v:.{nd}f}"


def write_psnr_log(scores: ClipScores, path: str) -> None:
    """ffmpeg psnr stats_file lines plus an 'average' summary line."""
    p = scores.psnr
    with open(path, "w") as f:
        for i in range(scores.n_frames):
            f.write(
                f"n:{i + 1} mse_avg:{p['mse_avg'][i]:.2f} "
                f"mse_y:{p['mse_y'][i]:.2f} mse_u:{p['mse_u'][i]:.2f} "
                f"mse_v:{p['mse_v'][i]:.2f} psnr_avg:{_fmt(p['psnr_avg'][i], 2)} "
                f"psnr_y:{_fmt(p['psnr_y'][i], 2)} psnr_u:{_fmt(p['psnr_u'][i], 2)} "
                f"psnr_v:{_fmt(p['psnr_v'][i], 2)}\n"
            )
        # Clip-level pooling over accumulated MSE on the native scale.
        peak = scores.peak
        mse_avg = float(np.mean(p["mse_avg"]))
        avg = 10.0 * np.log10(peak * peak / mse_avg) if mse_avg > 0 else float("inf")
        f.write(f"PSNR average:{_fmt(avg, 6)} "
                f"min:{_fmt(float(np.min(p['psnr_avg'])), 6)} "
                f"max:{_fmt(float(np.max(p['psnr_avg'])), 6)}\n")


def write_ssim_log(scores: ClipScores, path: str) -> None:
    """ffmpeg ssim stats_file lines plus an 'average' summary line."""
    s = scores.ssim
    with open(path, "w") as f:
        for i in range(scores.n_frames):
            db = s["ssim_db"][i]
            f.write(
                f"n:{i + 1} Y:{s['ssim_y'][i]:.6f} U:{s['ssim_u'][i]:.6f} "
                f"V:{s['ssim_v'][i]:.6f} All:{s['ssim_all'][i]:.6f} "
                f"({_fmt(db, 6)})\n"
            )
        f.write(f"SSIM average:{np.mean(s['ssim_all']):.6f} "
                f"min:{np.min(s['ssim_all']):.6f} "
                f"max:{np.max(s['ssim_all']):.6f}\n")


class VMAFAnalyzer:
    """VMAF + PSNR + SSIM scoring on ``device`` with the reference's API."""

    def __init__(self, options_manager=None, device: Union[str, torch.device] = "cuda"):
        self.analysis_progress = Signal(int, name="analysis_progress")
        self.analysis_complete = Signal(dict, name="analysis_complete")
        self.analysis_failed = Signal(str, name="analysis_failed")
        self.error_occurred = Signal(str, name="error_occurred")
        self.status_update = Signal(str, name="status_update")

        self.device = torch.device(device)
        self.options_manager = options_manager
        self.output_directory: Optional[str] = None
        self.test_name: Optional[str] = None
        self.model = "vmaf_v0.6.1"
        self.pool_method = "mean"
        self.feature_subsample = 1
        self.feature_precision = None  # None/"auto": model-driven
        self.psnr_enabled = True
        self.ssim_enabled = True
        self.chunk_size = 32
        # The ClipScores of the last completed run (unrounded per-frame
        # values behind the JSON log).
        self.last_scores: Optional[ClipScores] = None
        self._lock = threading.Lock()
        self._abort = threading.Event()
        if options_manager is not None:
            self.set_options_from_manager(options_manager)

    def set_options_from_manager(self, options_manager) -> None:
        """Model, pool method, feature subsample and precision, PSNR/SSIM
        from the ``vmaf`` settings; the chunk size from ``tpu.chunk_size``
        (the settings file's category name)."""
        self.options_manager = options_manager
        vmaf = options_manager.get_setting("vmaf") or {}
        self.model = vmaf.get("default_model", self.model)
        self.pool_method = vmaf.get("pool_method", self.pool_method)
        self.feature_subsample = int(vmaf.get("feature_subsample", 1) or 1)
        fp = vmaf.get("feature_precision", "auto")
        self.feature_precision = None if fp in (None, "", "auto") else str(fp)
        self.psnr_enabled = bool(vmaf.get("psnr_enabled", True))
        self.ssim_enabled = bool(vmaf.get("ssim_enabled", True))
        chunks = options_manager.get_setting("tpu") or {}
        self.chunk_size = int(chunks.get("chunk_size", 32) or 32)

    set_options_manager = set_options_from_manager

    def set_output_directory(self, directory: str) -> None:
        self.output_directory = directory

    def set_test_name(self, name: str) -> None:
        self.test_name = name

    def terminate_analysis(self) -> None:
        """Cooperative abort, checked after every chunk."""
        self._abort.set()

    def analyze_videos(
        self,
        reference_path: str,
        distorted_path: str,
        model: Optional[str] = None,
        duration: Optional[float] = None,
    ) -> Optional[Dict]:
        """Score a ref/dist pair; returns the reference-shaped results dict
        and emits analysis_complete. On failure emits error_occurred and
        analysis_failed and returns None (the reference's contract)."""
        with self._lock:
            self._abort.clear()
            try:
                return self._analyze(reference_path, distorted_path,
                                     model or self.model, duration)
            except Exception as e:
                logger.exception("analysis failed")
                msg = f"VMAF analysis error: {e}"
                self.error_occurred.emit(msg)
                self.analysis_failed.emit(msg)
                return None

    def _analyze(self, reference_path, distorted_path, model, duration):
        for p in (reference_path, distorted_path):
            if not os.path.exists(p):
                raise FileNotFoundError(f"video file not found: {p}")

        self.status_update.emit(f"Starting VMAF analysis with model {model}...")
        self.analysis_progress.emit(5)

        ref_info = probe_video(reference_path)
        dist_info = probe_video(distorted_path)
        fps = float(ref_info.get("frame_rate") or 30.0)
        max_frames = min(ref_info["frame_count"], dist_info["frame_count"])
        if duration:
            max_frames = min(max_frames, int(round(duration * fps)))
        if self._abort.is_set():
            raise InterruptedError("analysis terminated")
        self.status_update.emit(
            f"Scoring ~{max_frames} frames at {ref_info['width']}x{ref_info['height']}...")

        n_sampled = -(-(max_frames or 1) // max(1, self.feature_subsample))
        meter = ThroughputMeter(
            n_sampled or 1,
            progress_cb=lambda p: self.analysis_progress.emit(5 + p * 75 // 100),
            status_cb=self.status_update.emit,
        )

        def on_chunk(k):
            if self._abort.is_set():
                raise InterruptedError("analysis terminated")
            meter.add(k)

        scores = stream_score(
            reference_path,
            distorted_path,
            model=model,
            chunk_size=self.chunk_size,
            max_frames=max_frames,
            with_psnr=self.psnr_enabled,
            with_ssim=self.ssim_enabled,
            frame_cb=on_chunk,
            subsample=self.feature_subsample,
            precision=self.feature_precision,
            device=self.device,
        )
        self.analysis_progress.emit(80)
        return self._finalize(
            scores, fps=fps, model=model,
            reference_path=reference_path, distorted_path=distorted_path,
            width=dist_info["width"], height=dist_info["height"],
        )

    def analyze_frames(
        self,
        ref_planes: List[Dict],
        dist_planes: List[Dict],
        fps: float = 30.0,
        model: Optional[str] = None,
        reference_name: str = "reference",
        distorted_name: str = "distorted",
        bit_depth: int = 8,
        ref_y=None,
        dist_y=None,
    ) -> Optional[Dict]:
        """Score already-decoded planar frames (``VideoReader`` output dicts),
        the decode-once entry point: the same signals, artifacts and results
        dict as :meth:`analyze_videos`. ``ref_y``/``dist_y`` may be the luma
        already on the 8-bit scale, on the device (not copied back)."""
        with self._lock:
            self._abort.clear()
            try:
                return self._analyze_frames(
                    ref_planes, dist_planes, fps, model or self.model,
                    reference_name, distorted_name, bit_depth, ref_y, dist_y)
            except Exception as e:
                logger.exception("analysis failed")
                msg = f"VMAF analysis error: {e}"
                self.error_occurred.emit(msg)
                self.analysis_failed.emit(msg)
                return None

    def _analyze_frames(self, ref_planes, dist_planes, fps, model, reference_name,
                        distorted_name, bit_depth, ref_y=None, dist_y=None):
        if not ref_planes or not dist_planes:
            raise ValueError("empty frame list")
        n = min(len(ref_planes), len(dist_planes))
        self.status_update.emit(f"Starting VMAF analysis with model {model}...")
        self.analysis_progress.emit(5)
        n_sampled = -(-n // max(1, self.feature_subsample))
        meter = ThroughputMeter(
            n_sampled or 1,
            progress_cb=lambda p: self.analysis_progress.emit(5 + p * 75 // 100),
            status_cb=self.status_update.emit,
        )

        def on_chunk(k):
            if self._abort.is_set():
                raise InterruptedError("analysis terminated")
            meter.add(k)

        scores = score_planes(
            ref_planes[:n], dist_planes[:n], model=model, chunk_size=self.chunk_size,
            with_psnr=self.psnr_enabled, with_ssim=self.ssim_enabled,
            frame_cb=on_chunk, bit_depth=bit_depth, subsample=self.feature_subsample,
            precision=self.feature_precision,
            ref_y=ref_y[:n] if ref_y is not None else None,
            dist_y=dist_y[:n] if dist_y is not None else None,
            device=self.device,
        )
        self.analysis_progress.emit(80)
        h, w = ref_planes[0]["y"].shape
        return self._finalize(
            scores, fps=fps, model=model,
            reference_path=reference_name, distorted_path=distorted_name,
            width=w, height=h,
        )

    def _finalize(self, scores: ClipScores, *, fps, model,
                  reference_path, distorted_path, width, height) -> Dict:
        """Write the artifacts and build the reference-shaped results dict."""
        self.last_scores = scores
        out_dir = self.output_directory or os.path.dirname(distorted_path) or "."
        os.makedirs(out_dir, exist_ok=True)
        base = self.test_name or os.path.splitext(os.path.basename(distorted_path))[0]
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        prefix = os.path.join(out_dir, f"{base}_{ts}")

        json_path = f"{prefix}_vmaf.json"
        psnr_path = f"{prefix}_psnr.txt"
        ssim_path = f"{prefix}_ssim.txt"
        raw_results = write_vmaf_json(scores, json_path, fps=fps)
        if scores.psnr is not None:
            write_psnr_log(scores, psnr_path)
        else:
            psnr_path = None
        if scores.ssim is not None:
            write_ssim_log(scores, ssim_path)
        else:
            ssim_path = None
        self.analysis_progress.emit(95)

        vmaf_score = pool_metric(scores.vmaf, self.pool_method)
        psnr_score = (
            float(np.mean(scores.psnr["psnr_avg"][np.isfinite(scores.psnr["psnr_avg"])]))
            if scores.psnr is not None and np.any(np.isfinite(scores.psnr["psnr_avg"]))
            else (float("inf") if scores.psnr is not None else None)
        )
        ssim_score = (
            float(np.mean(scores.ssim["ssim_all"])) if scores.ssim is not None else None
        )

        results = {
            "vmaf_score": float(vmaf_score),
            "psnr_score": psnr_score,
            "ssim_score": ssim_score,
            "json_path": json_path,
            "psnr_log": psnr_path,
            "ssim_log": ssim_path,
            "reference_video": os.path.basename(reference_path),
            "distorted_video": os.path.basename(distorted_path),
            "reference_path": reference_path,
            "distorted_path": distorted_path,
            "raw_results": raw_results,
            "model": model,
            "width": width,
            "height": height,
            "frame_count": int(scores.n_frames),
            "duration": float(scores.n_frames * scores.frame_step / fps),
        }
        self.analysis_progress.emit(100)
        self.status_update.emit(f"VMAF analysis complete! Score: {vmaf_score:.2f}")
        self.analysis_complete.emit(results)
        return results


class VMAFAnalysisThread(threading.Thread):
    """One ``analyze_videos`` run on a thread, its analyzer's signals
    re-exposed on the thread (pqa2_tpu/app/vmaf_analyzer.py:382)."""

    def __init__(self, reference_path, distorted_path, model=None, duration=None,
                 options_manager=None, device: Union[str, torch.device] = "cuda"):
        super().__init__(daemon=True)
        self.analyzer = VMAFAnalyzer(options_manager, device=device)
        self.analysis_progress = self.analyzer.analysis_progress
        self.analysis_complete = self.analyzer.analysis_complete
        self.analysis_failed = self.analyzer.analysis_failed
        self.error_occurred = self.analyzer.error_occurred
        self.status_update = self.analyzer.status_update
        self._args = (reference_path, distorted_path, model, duration)
        self.results: Optional[Dict] = None

    def run(self):
        self.results = self.analyzer.analyze_videos(*self._args)

    def terminate(self):
        self.analyzer.terminate_analysis()
