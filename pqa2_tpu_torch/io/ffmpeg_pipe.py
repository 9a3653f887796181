# Copy of pqa2_tpu/io/ffmpeg_pipe.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""External-ffmpeg rawvideo pipe ingest (fallback decoder).

The reference app decodes everything through ffmpeg subprocesses
(app/utils.py:572-667 builds rawvideo pipes; app/options_manager.py:656-712
resolves the binary).  This framework decodes in-process (y4m parser /
OpenCV) — but when a container's codec is missing from the bundled OpenCV
build, this module provides the same contract: probe the stream (ffprobe
JSON, falling back to `ffmpeg -i` stderr parsing), then stream planar
yuv420p frames from a `ffmpeg ... -f rawvideo pipe:` child.

Binary resolution order: explicit argument > `PQA2_FFMPEG`/`PQA2_FFPROBE`
env > path configured via :func:`configure` (the app layer pushes the
`paths.ffmpeg_path` setting here) > `$PATH`.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

# Set by the app layer from OptionsManager ("paths" / "ffmpeg_path").
_configured: Dict[str, Optional[str]] = {"ffmpeg": None, "ffprobe": None}


def configure(ffmpeg_path: Optional[str] = None,
              ffprobe_path: Optional[str] = None) -> None:
    """Install the app-level configured binary paths (paths.ffmpeg_path)."""
    if ffmpeg_path:
        _configured["ffmpeg"] = ffmpeg_path
    if ffprobe_path:
        _configured["ffprobe"] = ffprobe_path


def resolve_ffmpeg(explicit: Optional[str] = None) -> Optional[str]:
    return (explicit or os.environ.get("PQA2_FFMPEG")
            or _configured["ffmpeg"] or shutil.which("ffmpeg"))


def resolve_ffprobe(explicit: Optional[str] = None) -> Optional[str]:
    p = (explicit or os.environ.get("PQA2_FFPROBE")
         or _configured["ffprobe"] or shutil.which("ffprobe"))
    if p:
        return p
    # Common layout: ffprobe sits next to a configured ffmpeg.
    ff = resolve_ffmpeg()
    if ff:
        cand = os.path.join(os.path.dirname(ff), "ffprobe")
        if os.path.isfile(cand):
            return cand
    return None


def _parse_rate(expr: str) -> float:
    if "/" in expr:
        num, den = expr.split("/", 1)
        den_f = float(den)
        return float(num) / den_f if den_f else 0.0
    try:
        return float(expr)
    except ValueError:
        return 0.0


def probe_stream(path: str, ffprobe: Optional[str] = None,
                 ffmpeg: Optional[str] = None, timeout: float = 30.0) -> Dict:
    """Geometry/rate/codec for the first video stream.

    Prefers `ffprobe -of json`; falls back to parsing `ffmpeg -i` stderr
    (the reference's own fallback, app/utils.py:619-667)."""
    probe = resolve_ffprobe(ffprobe)
    if probe:
        cmd = [probe, "-v", "error", "-select_streams", "v:0",
               "-show_entries",
               "stream=width,height,r_frame_rate,avg_frame_rate,nb_frames,"
               "pix_fmt,codec_name,duration",
               "-of", "json", path]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout, check=False)
            data = json.loads(out.stdout or "{}")
            streams = data.get("streams") or []
            if streams:
                s = streams[0]
                rate = _parse_rate(s.get("avg_frame_rate")
                                   or s.get("r_frame_rate") or "0")
                duration = float(s.get("duration") or 0.0)
                n = int(s.get("nb_frames") or 0)
                if not n and duration and rate:
                    n = int(round(duration * rate))
                return {
                    "width": int(s.get("width") or 0),
                    "height": int(s.get("height") or 0),
                    "frame_rate": rate,
                    "frame_count": n,
                    "duration": duration or (n / rate if rate else 0.0),
                    "pix_fmt": s.get("pix_fmt") or "yuv420p",
                    "codec": s.get("codec_name") or "unknown",
                }
        except Exception as e:
            logger.debug("ffprobe failed (%s); trying ffmpeg -i", e)

    ff = resolve_ffmpeg(ffmpeg)
    if not ff:
        raise RuntimeError(
            "no ffprobe/ffmpeg binary available to probe the stream "
            "(set paths.ffmpeg_path or PQA2_FFMPEG)")
    out = subprocess.run([ff, "-hide_banner", "-i", path],
                         capture_output=True, text=True, timeout=timeout,
                         check=False)
    text = out.stderr
    # Strip parenthesized stream metadata before matching: lines like
    # "Video: h264 (High) (avc1 / ...), yuv420p10le(tv, bt2020nc, ...)"
    # would otherwise let the pix_fmt capture land on "bt2020nc" and a
    # 10-bit source silently decode as 8-bit (ADVICE round-2).
    line_m = re.search(r"Video:[^\n]*", text)
    m = None
    if line_m:
        clean = re.sub(r"\([^()]*\)", " ", line_m.group(0))
        m = re.search(
            r"Video:\s*(\w+)\s*,\s*([A-Za-z]\w*)\s*,?\s*(\d+)x(\d+)"
            r".*?([\d.]+)\s*fps",
            clean)
    if not m:  # lenient fallback (original pattern) for exotic layouts
        m = re.search(
            r"Video:\s*(\w+).*?,\s*(\w+)[^,]*,\s*(\d+)x(\d+).*?([\d.]+)\s*fps",
            text, re.DOTALL)
    if not m:
        raise IOError(f"cannot probe video stream in {path!r}")
    codec, pix_fmt, w, h, fps = m.groups()
    dm = re.search(r"Duration:\s*(\d+):(\d+):([\d.]+)", text)
    duration = 0.0
    if dm:
        hh, mm, ss = dm.groups()
        duration = int(hh) * 3600 + int(mm) * 60 + float(ss)
    rate = float(fps)
    return {
        "width": int(w), "height": int(h), "frame_rate": rate,
        "frame_count": int(round(duration * rate)) if rate else 0,
        "duration": duration, "pix_fmt": pix_fmt, "codec": codec,
    }


class FFmpegPipeReader:
    """Stream planar yuv420p frames from an ffmpeg rawvideo pipe.

    Same frame-dict interface as io.video.VideoReader / io.y4m.Y4MReader:
    read_frame() -> {"y", "u", "v"} uint8 (or uint16 for >8-bit sources)."""

    def __init__(self, path: str, ffmpeg: Optional[str] = None,
                 ffprobe: Optional[str] = None):
        self.path = str(path)
        ff = resolve_ffmpeg(ffmpeg)
        if not ff:
            raise RuntimeError(
                f"cannot decode {path!r}: OpenCV could not open it and no "
                "ffmpeg binary is available (set paths.ffmpeg_path or "
                "PQA2_FFMPEG)")
        meta = probe_stream(self.path, ffprobe=ffprobe, ffmpeg=ff)
        self.width = meta["width"]
        self.height = meta["height"]
        if not self.width or not self.height:
            raise IOError(f"probe returned empty geometry for {path!r}")
        src_fmt = meta.get("pix_fmt") or "yuv420p"
        depth_m = re.search(r"p(\d{2})(?:le|be)?$", src_fmt)
        self.bit_depth = int(depth_m.group(1)) if depth_m else 8
        if self.bit_depth > 8:
            self._pix_fmt = f"yuv420p{self.bit_depth}le"
            self._dtype = np.uint16
        else:
            self._pix_fmt = "yuv420p"
            self._dtype = np.uint8
        self.meta = meta
        itemsize = np.dtype(self._dtype).itemsize
        # yuv420p chroma planes are ceil(w/2) x ceil(h/2) — odd-dimension
        # sources would desynchronise the pipe with a w*h*3//2 assumption.
        self._cw = (self.width + 1) // 2
        self._ch = (self.height + 1) // 2
        self._frame_bytes = itemsize * (
            self.width * self.height + 2 * self._cw * self._ch)
        # The decode child spawns LAZILY on the first read: constructing a
        # reader just for .info (workflow size probes, probe_video) must not
        # launch a whole-file rawvideo decode.
        self._ff = ff
        self._proc = None

    def _ensure_proc(self):
        if self._proc is None:
            self._proc = subprocess.Popen(
                [self._ff, "-v", "error", "-nostdin", "-i", self.path,
                 "-map", "0:v:0", "-f", "rawvideo", "-pix_fmt",
                 self._pix_fmt, "pipe:1"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            # Drain stderr on a background thread, keeping only a bounded
            # tail for error reporting. A corrupt source can make ffmpeg
            # emit more error text than the pipe buffer holds; without a
            # drain ffmpeg blocks on stderr, stdout stalls, and
            # read_frame() hangs forever (ADVICE round-2; same failure
            # mode DeckLinkBackend.capture drains in app/capture.py).
            import collections
            import threading

            self._stderr_tail = collections.deque(maxlen=64)

            def _drain(pipe, tail):
                try:
                    for raw in iter(pipe.readline, b""):
                        tail.append(raw)
                except Exception:
                    pass
                finally:
                    try:
                        pipe.close()
                    except Exception:
                        pass

            self._stderr_thread = threading.Thread(
                target=_drain, args=(self._proc.stderr, self._stderr_tail),
                daemon=True)
            self._stderr_thread.start()
        return self._proc

    # VideoReader-compatible surface -----------------------------------
    @property
    def info(self):
        from pqa2_tpu_torch.io.video import VideoInfo

        return VideoInfo(
            path=self.path, width=self.width, height=self.height,
            frame_rate=self.meta["frame_rate"],
            duration=self.meta["duration"],
            frame_count=self.meta["frame_count"],
            pix_fmt=self._pix_fmt, codec=self.meta["codec"],
            bit_depth=self.bit_depth,
        )

    def read_frame(self) -> Optional[Dict[str, np.ndarray]]:
        buf = self._ensure_proc().stdout.read(self._frame_bytes)
        if not buf:
            self._check_child()
            return None
        if len(buf) < self._frame_bytes:
            self._check_child()
            raise IOError(
                f"truncated rawvideo frame from ffmpeg pipe ({len(buf)} of "
                f"{self._frame_bytes} bytes) for {self.path!r}")
        w, h = self.width, self.height
        cw, ch = self._cw, self._ch
        a = np.frombuffer(buf, dtype=self._dtype)
        y = a[: w * h].reshape(h, w)
        u = a[w * h : w * h + cw * ch].reshape(ch, cw)
        v = a[w * h + cw * ch :].reshape(ch, cw)
        return {"y": y, "u": u, "v": v}

    def _check_child(self):
        rc = self._proc.poll()
        if rc not in (None, 0):
            t = getattr(self, "_stderr_thread", None)
            if t is not None:
                t.join(timeout=2)  # let the drain collect the final lines
            err = b"".join(getattr(self, "_stderr_tail", []) or [])
            raise IOError(
                f"ffmpeg pipe decoder exited rc={rc} for {self.path!r}: "
                f"{err.decode(errors='replace')[-400:]}")

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self):
        if self._proc is not None:
            try:
                self._proc.stdout.close()
            except Exception:
                pass
            try:
                self._proc.terminate()
                self._proc.wait(timeout=5)
            except Exception:
                try:
                    self._proc.kill()
                except Exception:
                    pass
            self._proc = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort: never leak the child
        try:
            self.close()
        except Exception:
            pass
