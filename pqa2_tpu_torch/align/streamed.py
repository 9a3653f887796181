"""Memory-bounded bookend alignment: stream, detect, trim — never hold a clip
(port of pqa2_tpu/align/streamed.py).

The in-memory path (align/temporal.py) and the engine aligner materialise
both clips in host RAM. For inputs past the workflow's memory budget
(app/workflow.py) this module does the same alignment with a flat ceiling:

  pass 1 — stream each clip chunk-wise through the packed stats+thumbnails
           pass (align/stats.py) on ``device``: each chunk is uploaded and
           its packed block comes back, the frames are discarded;
  decide — align_from_signals on the collected per-frame signals;
  pass 2 — re-read each source and write the aligned trim window
           frame-by-frame with the y4m writer.

Peak memory is one chunk (~64 frames), independent of clip length.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from pqa2_tpu_torch.align.bookend import BookendConfig
from pqa2_tpu_torch.align.stats import _finish_stats, _stats_thumb_chunk
from pqa2_tpu_torch.align.temporal import AlignmentResult, align_from_signals
from pqa2_tpu_torch.io.video import VideoReader
from pqa2_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

CHUNK = 64


def streamed_stats_thumbs(path: str, chunk: int = CHUNK, *,
                          device: Union[str, torch.device] = "cuda"):
    """One bounded pass over a video: (stats dict, (N, 64) thumbs, info).

    >8-bit sources are scaled to the 8-bit range for the statistics
    (detection thresholds are 8-bit-scale), matching the in-memory
    workflow's normalisation."""
    device = resolve_device(device)
    packs = []
    with VideoReader(path) as r:
        info = r.info
        div = float(1 << (info.bit_depth - 8))
        while True:
            frames = []
            while len(frames) < chunk:
                fr = r.read_frame()
                if fr is None:
                    break
                frames.append(fr["y"])
            if not frames:
                break
            packs.append(_stats_thumb_chunk(upload(frames, device, div)).cpu().numpy())
            if len(frames) < chunk:
                break
    if not packs:
        raise ValueError(f"empty input video: {path}")
    packed = np.concatenate(packs)
    stats = _finish_stats(packed[:, 0], packed[:, 1], packed[:, 2:258],
                          info.height, info.width)
    return stats, packed[:, 258:], info


def write_trim(src_path: str, dst_path: str, start: int, stop: int,
               fps: Optional[Tuple[int, int]] = None) -> int:
    """Stream frames [start, stop) of src to a y4m trim, one frame resident
    at a time. Preserves the source bit depth. Returns frames written."""
    with VideoReader(src_path) as r:
        info = r.info
        if fps is None:
            fps = (int(round((info.frame_rate or 30.0) * 1000)), 1000)
        colorspace = ("C420mpeg2" if info.bit_depth == 8
                      else f"C420p{info.bit_depth}")
        header = Y4MHeader(width=info.width, height=info.height,
                           fps_num=fps[0], fps_den=fps[1],
                           colorspace=colorspace)
        written = 0
        writer = None
        try:
            for i in range(stop):
                fr = r.read_frame()
                if fr is None:
                    break
                if i < start:
                    continue
                if writer is None:
                    writer = Y4MWriter(dst_path, header)
                writer.write_frame(fr)
                written += 1
        finally:
            if writer is not None:
                writer.close()
        return written


def streamed_align(
    reference_path: str,
    captured_path: str,
    config: Optional[BookendConfig] = None,
    refine: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[AlignmentResult, "object", "object"]:
    """Bounded-memory alignment of a file pair, its statistics on ``device``.

    Returns (AlignmentResult, ref_info, cap_info). Trims are NOT written
    here — the caller picks destinations and calls write_trim (pass 2)."""
    cap_stats, cap_thumbs, cap_info = streamed_stats_thumbs(captured_path, device=device)

    def ref_thumbs():
        return streamed_stats_thumbs(reference_path, device=device)[1]

    # Frame count of the reference without decoding it twice when possible.
    with VideoReader(reference_path) as r:
        ref_info = r.info
    n_ref = ref_info.frame_count
    if not n_ref:
        # Containers without a frame count: one counting pass.
        with VideoReader(reference_path) as r:
            n_ref = sum(1 for _ in r)
    result = align_from_signals(
        n_ref, cap_stats["mean"].shape[0], cap_stats, cap_thumbs,
        ref_thumbs, fps=cap_info.frame_rate or 30.0, config=config,
        refine=refine,
    )
    return result, ref_info, cap_info
