# Copy of pqa2_tpu/io/y4m.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""YUV4MPEG2 (.y4m) reader/writer.

Self-contained ingest for the golden-parity and benchmark paths (the
reference shells out to ffmpeg for all decode, e.g. app/vmaf_analyzer.py:411;
here uncompressed y4m is parsed directly into numpy planes so the scoring
pipeline has a dependency-free on-ramp).

Supported colorspaces: C420 (+ variants jpeg/paldv/mpeg2), C422, C444,
8/10/12-bit (e.g. C420p10). Frames come back as dict(y=..., u=..., v=...)
uint8/uint16 numpy arrays in planar layout.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int
    fps_den: int
    interlacing: str = "p"
    aspect: str = "0:0"
    colorspace: str = "C420mpeg2"

    @property
    def fps(self) -> float:
        return self.fps_num / max(self.fps_den, 1)

    @property
    def pix_fmt(self) -> str:
        """ffmpeg-style pix_fmt name for this colorspace tag."""
        cs = self.colorspace
        m = re.match(r"C(\d{3})(?:[a-z0-9]*?)(p(\d+))?$", cs)
        if not m:
            return "yuv420p"
        sub, _, depth = m.groups()
        base = {"420": "yuv420p", "422": "yuv422p", "444": "yuv444p"}.get(
            sub, "yuv420p"
        )
        if depth and int(depth) > 8:
            return f"{base}{depth}le"
        return base

    @property
    def bit_depth(self) -> int:
        m = re.search(r"p(\d+)$", self.colorspace)
        return int(m.group(1)) if m else 8

    @property
    def chroma_shape(self) -> Tuple[int, int]:
        cs = self.colorspace
        if cs.startswith("C444"):
            return (self.height, self.width)
        if cs.startswith("C422"):
            return (self.height, self.width // 2)
        return (self.height // 2, self.width // 2)


def _parse_header_line(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a y4m stream (missing YUV4MPEG2 magic)")
    h = Y4MHeader(width=0, height=0, fps_num=30, fps_den=1)
    for tok in line.decode("ascii", "replace").split()[1:]:
        tag, val = tok[0], tok[1:]
        if tag == "W":
            h.width = int(val)
        elif tag == "H":
            h.height = int(val)
        elif tag == "F":
            num, den = val.split(":")
            h.fps_num, h.fps_den = int(num), int(den)
        elif tag == "I":
            h.interlacing = val
        elif tag == "A":
            h.aspect = val
        elif tag == "C":
            h.colorspace = "C" + val
    if h.width <= 0 or h.height <= 0:
        raise ValueError("y4m header missing W/H")
    return h


class Y4MReader:
    """Streaming y4m reader; iterate to get per-frame plane dicts."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f = open(path_or_file, "rb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self.header = _parse_header_line(self._f.readline().rstrip(b"\n"))
        self._dtype = np.uint8 if self.header.bit_depth <= 8 else np.uint16
        ch, cw = self.header.chroma_shape
        itemsize = np.dtype(self._dtype).itemsize
        self._ysize = self.header.width * self.header.height * itemsize
        self._csize = ch * cw * itemsize
        self._chroma_shape = (ch, cw)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._owns:
            self._f.close()

    def read_frame(self) -> Optional[Dict[str, np.ndarray]]:
        line = self._f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad y4m frame marker: {line[:20]!r}")
        h = self.header
        buf = self._f.read(self._ysize + 2 * self._csize)
        if len(buf) < self._ysize + 2 * self._csize:
            raise ValueError("truncated y4m frame")
        y = np.frombuffer(buf, self._dtype, count=h.width * h.height).reshape(
            h.height, h.width
        )
        off = self._ysize
        n_c = self._chroma_shape[0] * self._chroma_shape[1]
        u = np.frombuffer(buf, self._dtype, count=n_c, offset=off).reshape(
            self._chroma_shape
        )
        v = np.frombuffer(
            buf, self._dtype, count=n_c, offset=off + self._csize
        ).reshape(self._chroma_shape)
        return {"y": y, "u": u, "v": v}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr


def header_line(header: Y4MHeader) -> str:
    """The stream header line — one definition shared by the Python writer
    and the native write pump (byte-identical output contract)."""
    return (
        f"YUV4MPEG2 W{header.width} H{header.height} "
        f"F{header.fps_num}:{header.fps_den} I{header.interlacing} "
        f"A{header.aspect} {header.colorspace}\n"
    )


class Y4MWriter:
    def __init__(self, path_or_file, header: Y4MHeader):
        if isinstance(path_or_file, (str, os.PathLike)):
            self._f = open(path_or_file, "wb")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self.header = header
        self._f.write(header_line(header).encode("ascii"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._owns:
            self._f.close()

    def write_frame(self, frame: Dict[str, np.ndarray]) -> None:
        self._f.write(b"FRAME\n")
        for plane in ("y", "u", "v"):
            self._f.write(np.ascontiguousarray(frame[plane]).tobytes())


def read_y4m(path) -> Tuple[Y4MHeader, List[Dict[str, np.ndarray]]]:
    with Y4MReader(path) as r:
        return r.header, list(r)


def write_y4m(path, frames, fps=(30, 1), colorspace="C420mpeg2") -> None:
    """Write frames as y4m with the Python writer (the JAX package's native
    write pump, pqa2_tpu/io/native.py, is not part of the port)."""
    f0 = frames[0]
    header = Y4MHeader(
        width=f0["y"].shape[1],
        height=f0["y"].shape[0],
        fps_num=fps[0],
        fps_den=fps[1],
        colorspace=colorspace,
    )
    with Y4MWriter(path, header) as w:
        for fr in frames:
            w.write_frame(fr)
