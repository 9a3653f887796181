"""Video ingest of the port: y4m, OpenCV when present, and the ffmpeg pipe.

Copies of ``pqa2_tpu/io/{y4m,video,ffmpeg_pipe,repair}.py`` with their
imports pointed at this package, exported as ``pqa2_tpu/io/__init__.py``
does. The JAX package's native decode/write pump (``pqa2_tpu/io/native.py``)
is not part of the port yet (ROADMAP Q1.9).
"""

from pqa2_tpu_torch.io.y4m import Y4MReader, Y4MWriter, read_y4m, write_y4m
from pqa2_tpu_torch.io.video import VideoReader, open_video, probe_video
from pqa2_tpu_torch.io.ffmpeg_pipe import FFmpegPipeReader

__all__ = [
    "Y4MReader",
    "Y4MWriter",
    "read_y4m",
    "write_y4m",
    "VideoReader",
    "open_video",
    "probe_video",
    "FFmpegPipeReader",
]
