# Copy of pqa2_tpu/io/video.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Unified video ingest.

Decode stays on the host CPU (the TPU consumes raw planar YUV tensors); this
module provides one `VideoReader` interface over:

  * .y4m      — the self-contained parser in y4m.py (bit-exact planes;
                used by all parity tests and benches)
  * .yuv      — raw planar files (size must be given)
  * anything else — OpenCV's bundled FFmpeg demux/decode (mp4/mkv/avi...),
                requesting raw YUV output where the backend supports it and
                falling back to BGR->I420 conversion otherwise.

`probe_video` replaces the reference's ffprobe subprocess metadata calls
(app/utils.py:572-667, app/reference_analyzer.py:20-97) with an in-process
equivalent returning the same field names the app layer expects.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pqa2_tpu_torch.io.y4m import Y4MReader

try:  # OpenCV is optional; y4m/yuv paths never need it.
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class VideoInfo:
    path: str
    width: int
    height: int
    frame_rate: float
    duration: float
    frame_count: int
    pix_fmt: str
    codec: str
    bit_depth: int = 8

    def as_dict(self) -> Dict:
        """Field layout compatible with the reference's get_video_info()
        result (app/utils.py:572-667)."""
        return {
            "path": self.path,
            "width": self.width,
            "height": self.height,
            "frame_rate": self.frame_rate,
            "duration": self.duration,
            "frame_count": self.frame_count,
            "total_frames": self.frame_count,
            "pix_fmt": self.pix_fmt,
            "codec": self.codec,
            "bit_depth": self.bit_depth,
        }


class VideoReader:
    """Iterate planar YUV frames (dict of y/u/v uint8|uint16 arrays)."""

    def __init__(self, path: str):
        self.path = str(path)
        ext = os.path.splitext(self.path)[1].lower()
        self._y4m = None
        self._cap = None
        self._pipe = None
        if ext == ".y4m":
            self._y4m = Y4MReader(self.path)
            h = self._y4m.header
            n_frames = _count_y4m_frames(self.path, h)
            self.info = VideoInfo(
                path=self.path,
                width=h.width,
                height=h.height,
                frame_rate=h.fps,
                duration=n_frames / h.fps if h.fps else 0.0,
                frame_count=n_frames,
                pix_fmt=h.pix_fmt,
                codec="rawvideo",
                bit_depth=h.bit_depth,
            )
        else:
            cap = None
            if cv2 is not None:
                cap = cv2.VideoCapture(self.path)
                if not cap.isOpened():
                    cap.release()
                    cap = None
            if cap is None:
                # OpenCV missing or its bundled FFmpeg lacks the codec:
                # fall back to an external-ffmpeg rawvideo pipe (the
                # reference's only decode path, app/utils.py:572-667).
                if not os.path.exists(self.path):
                    raise IOError(f"cannot open video: {self.path}")
                from pqa2_tpu_torch.io.ffmpeg_pipe import FFmpegPipeReader

                try:
                    self._pipe = FFmpegPipeReader(self.path)
                except RuntimeError as e:
                    raise IOError(
                        f"cannot open video: {self.path} ({e})") from e
                self.info = self._pipe.info
                return
            self._cap = cap
            fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
            self.info = VideoInfo(
                path=self.path,
                width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                frame_rate=float(fps),
                duration=n / fps if fps else 0.0,
                frame_count=n,
                pix_fmt="yuv420p",
                codec=_fourcc_name(cap),
                bit_depth=8,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._y4m is not None:
            self._y4m.close()
        if self._cap is not None:
            self._cap.release()
        if self._pipe is not None:
            self._pipe.close()

    def seek_frame(self, index: int) -> None:
        if self._cap is not None:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, index)
        else:
            raise NotImplementedError(
                "y4m/pipe readers are forward-only")

    def read_frame(self) -> Optional[Dict[str, np.ndarray]]:
        if self._y4m is not None:
            return self._y4m.read_frame()
        if self._pipe is not None:
            return self._pipe.read_frame()
        ok, frame = self._cap.read()
        if not ok:
            return None
        return bgr_to_i420_planes(frame)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr


def bgr_to_i420_planes(frame: np.ndarray) -> Dict[str, np.ndarray]:
    """BGR (H,W,3) -> planar I420 dict, BT.601 limited range (cv2 semantics)."""
    h, w = frame.shape[:2]
    i420 = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)  # (3h/2, w)
    y = i420[:h]
    u = i420[h : h + h // 4].reshape(h // 2, w // 2)
    v = i420[h + h // 4 :].reshape(h // 2, w // 2)
    return {"y": y, "u": u, "v": v}


def _fourcc_name(cap) -> str:
    try:
        v = int(cap.get(cv2.CAP_PROP_FOURCC))
        return "".join(chr((v >> (8 * i)) & 0xFF) for i in range(4)).strip() or "unknown"
    except Exception:
        return "unknown"


def _count_y4m_frames(path: str, header) -> int:
    """Frame count from file size (y4m frames are fixed-size)."""
    itemsize = 1 if header.bit_depth <= 8 else 2
    ch, cw = header.chroma_shape
    frame_bytes = len(b"FRAME\n") + itemsize * (
        header.width * header.height + 2 * ch * cw
    )
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header_len = len(f.readline())
    return max((size - header_len) // frame_bytes, 0)


def open_video(path: str) -> VideoReader:
    return VideoReader(path)


def probe_video(path: str) -> Dict:
    """In-process replacement for the reference's ffprobe metadata calls."""
    with VideoReader(path) as r:
        return r.info.as_dict()
