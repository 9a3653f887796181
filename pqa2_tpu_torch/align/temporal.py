"""Temporal alignment: bookend pair -> aligned frame ranges (+ xcorr refine).

Port of pqa2_tpu/align/temporal.py. ``AlignmentResult``,
``refine_offset_xcorr`` (float64 numpy), ``_select_loop`` and
``align_from_signals`` are the JAX module's code; ``thumb_series`` and
``align_bookend_clips`` run their device pass on ``device``
(:mod:`pqa2_tpu_torch.align.stats`).

Alignment produces frame ranges into the decoded clips, not trimmed files.
The optional cross-correlation refinement correlates the 8x8 thumbnails of
the candidate window with the reference's, to fix off-by-a-few-frames
capture jitter.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.bookend import Bookend, BookendConfig, BookendDetector
from pqa2_tpu_torch.align.stats import CHUNK, _thumb_chunk, stats_and_thumbs
from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AlignmentResult:
    """Mirror of the reference's alignment result dict
    (app/bookend_alignment.py:440-456), with frame ranges instead of files."""

    alignment_method: str
    ref_range: Tuple[int, int]  # [start, stop) into the reference frames
    cap_range: Tuple[int, int]  # [start, stop) into the captured frames
    offset_frames: int
    offset_seconds: float
    confidence: float
    bookends: List[Bookend]
    content_duration: float
    is_fallback: bool = False

    @property
    def n_frames(self) -> int:
        return self.ref_range[1] - self.ref_range[0]

    def as_dict(self) -> dict:
        return {
            "alignment_method": self.alignment_method,
            "offset_frames": self.offset_frames,
            "offset_seconds": self.offset_seconds,
            "confidence": self.confidence,
            "ref_range": list(self.ref_range),
            "cap_range": list(self.cap_range),
            "content_duration": self.content_duration,
            "is_fallback": self.is_fallback,
        }


def thumb_series(luma, chunk_size: int = CHUNK, *,
                 device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """(N, H, W) luma (numpy or a tensor) -> (N, 64) f32 8x8 block-mean
    thumbnails, chunk by chunk on ``device``.

    A per-frame signature for the temporal cross-correlation: scalar frame
    means are too weak when content luminance barely varies frame-to-frame,
    while 8x8 thumbnails survive capture noise and stay cheap."""
    device = resolve_device(device)
    return np.concatenate([
        _thumb_chunk(upload(luma[s : s + chunk_size], device)).cpu().numpy()
        for s in range(0, luma.shape[0], chunk_size)])


def refine_offset_xcorr(
    ref_series: np.ndarray,
    cap_series: np.ndarray,
    cap_start: int,
    max_shift: int = 10,
) -> Tuple[int, float]:
    """Best extra offset for the capture window by normalised cross-corr.

    ref_series: (N, D) per-frame signatures of the reference clip.
    cap_series: (M, D) signatures of the full capture.
    cap_start: candidate start index of the content window in the capture.
    Returns (delta, confidence in [0, 1]). A nonzero delta is only proposed
    when it beats the delta=0 correlation by a clear margin.
    """
    ref_series = np.atleast_2d(np.asarray(ref_series, dtype=np.float64))
    cap_series = np.atleast_2d(np.asarray(cap_series, dtype=np.float64))
    if ref_series.shape[0] == 1:  # (D,) scalars passed as a row
        ref_series = ref_series.T
        cap_series = cap_series.T
    n = ref_series.shape[0]
    r = (ref_series - ref_series.mean()).ravel()
    rn = np.linalg.norm(r) + 1e-9

    def corr_at(s):
        c = cap_series[s : s + n]
        c = (c - c.mean()).ravel()
        return float(np.dot(r, c) / (rn * (np.linalg.norm(c) + 1e-9)))

    corr0 = corr_at(cap_start) if 0 <= cap_start <= len(cap_series) - n else -2.0
    best_delta, best_corr = 0, corr0
    for delta in range(-max_shift, max_shift + 1):
        s = cap_start + delta
        if delta == 0 or s < 0 or s + n > len(cap_series):
            continue
        corr = corr_at(s)
        if corr > best_corr + 0.02:
            best_corr, best_delta = corr, delta
    return best_delta, max(best_corr, 0.0)


def _select_loop(
    bookends: Sequence[Bookend], n_ref: int, fps: float, buffer_frames: int
) -> Tuple[Bookend, Bookend]:
    """Pick the consecutive bookend pair whose content span best matches the
    reference length (app/bookend_alignment.py:352-390)."""
    if len(bookends) == 2:
        return bookends[0], bookends[1]
    best = (bookends[0], bookends[-1])
    best_diff = float("inf")
    for i in range(len(bookends) - 1):
        start_b, end_b = bookends[i], bookends[i + 1]
        loop_len = (end_b.start_frame - buffer_frames) - (
            start_b.end_frame + 1 + buffer_frames
        )
        diff = abs(loop_len - n_ref)
        if diff < best_diff:
            best_diff = diff
            best = (start_b, end_b)
    return best


def align_bookend_clips(
    ref_luma,
    cap_luma,
    fps: float = 30.0,
    config: Optional[BookendConfig] = None,
    refine: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
) -> AlignmentResult:
    """Full alignment: detect bookends in the capture, select the loop whose
    length best matches the reference, optionally refine with xcorr, and
    return matched frame ranges of equal length.

    ``ref_luma``/``cap_luma``: (N, H, W) numpy arrays, or tensors that stay
    where they lie when that is ``device`` (the decode-once workflow hands
    over the luma it uploaded for scoring)."""
    cfg = config or BookendConfig()
    n_ref = ref_luma.shape[0]
    n_cap = cap_luma.shape[0]

    # One packed stats+thumbnails pass over the capture: detection reads
    # the stats, the xcorr refinement below reads the thumbnails — a single
    # device round trip per chunk instead of two passes (align/stats.py).
    cap_stats, cap_thumbs = stats_and_thumbs(cap_luma, device=device)
    return align_from_signals(
        n_ref, n_cap, cap_stats, cap_thumbs,
        lambda: thumb_series(ref_luma, device=device),
        fps=fps, config=cfg, refine=refine,
    )


def align_from_signals(
    n_ref: int,
    n_cap: int,
    cap_stats,
    cap_thumbs: np.ndarray,
    ref_thumbs_fn,
    fps: float = 30.0,
    config: Optional[BookendConfig] = None,
    refine: bool = True,
) -> AlignmentResult:
    """Alignment from precomputed per-frame signals (stats + thumbnails) —
    the core shared by the in-memory path and the streamed path
    (align/streamed.py), which never materialises the clips.
    ``ref_thumbs_fn`` is called lazily, only when xcorr refinement runs."""
    cfg = config or BookendConfig()
    detector = BookendDetector(cfg)
    bookends = detector.detect(None, fps, stats=cap_stats)
    if len(bookends) < 2:
        raise ValueError("failed to detect at least two white bookend sections")
    is_fallback = any(b.is_fallback for b in bookends)

    # ~1.5 frame safety buffer next to each bookend (bookend_alignment.py:337),
    # shrunk adaptively so very short contents still leave frames to score.
    content_start = content_stop = 0
    for buffer_frames in ((1, 0) if is_fallback else (2, 1, 0)):
        first, last = _select_loop(bookends, n_ref, fps, buffer_frames)
        content_start = first.end_frame + 1 + buffer_frames
        content_stop = last.start_frame - buffer_frames  # exclusive
        if content_stop > content_start:
            break
    if content_stop <= content_start:
        raise ValueError("invalid content timing between bookends")

    # Apply the configured frame offset (reference 'frame_offset' option).
    content_start = max(0, min(content_start + cfg.frame_offset, n_cap - 1))

    confidence = 0.95  # bookend method baseline (bookend_alignment.py:444)
    offset_delta = 0
    if refine and not is_fallback:
        ref_series = ref_thumbs_fn()
        cap_series = cap_thumbs  # from the packed stats pass
        n_cmp = min(n_ref, content_stop - content_start)
        offset_delta, corr = refine_offset_xcorr(
            ref_series[:n_cmp], cap_series, content_start
        )
        # refine_offset_xcorr only proposes a nonzero delta when it beats the
        # delta=0 correlation by a clear margin; the absolute gate here just
        # rejects matches on structureless signals. Keep it permissive —
        # spatially misregistered captures legitimately correlate weakly.
        if corr > 0.25:
            content_start = max(0, content_start + offset_delta)
            confidence = max(confidence, 0.5 + 0.5 * corr)
        else:
            offset_delta = 0

    n_aligned = min(n_ref, content_stop - content_start, n_cap - content_start)
    if n_aligned <= 0:
        raise ValueError("no content frames left after alignment")

    return AlignmentResult(
        alignment_method="bookend",
        ref_range=(0, n_aligned),
        cap_range=(content_start, content_start + n_aligned),
        offset_frames=int(content_start),
        offset_seconds=float(content_start / fps),
        confidence=float(confidence),
        bookends=list(bookends),
        content_duration=float(n_aligned / fps),
        is_fallback=is_fallback,
    )
