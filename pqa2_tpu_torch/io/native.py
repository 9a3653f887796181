"""ctypes binding for the native frame pump (copy of pqa2_tpu/io/native.py).

The C++ source is the port's own copy, ``pqa2_tpu_torch/csrc/framepump.cpp``
(byte-equal to the JAX package's ``native/framepump.cpp``). The shared
library is built on first use with g++ into
``build/pqa2_tpu_torch/libframepump.so`` at the repository root (through a
temporary file and a rename, so processes building at once never load a
half-written library), and exposes a NativeY4MReader with the same
frame-dict interface as the Python Y4MReader — but with a C++ reader thread
prefetching into a ring, so decode I/O overlaps Python-side work and the
H2D copy. ``is_available()`` is False when no compiler is available.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Dict, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pqa2_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libframepump.so")
_SRC_PATH = os.path.join(_PKG_DIR, "csrc", "framepump.cpp")

_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
             "-o", tmp, _SRC_PATH, "-lpthread"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("native framepump build failed: %s", e)
        return False


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)
        ):
            if not os.path.exists(_SRC_PATH) or not _build():
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fp_open.restype = ctypes.c_void_p
        lib.fp_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.fp_info.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int64)]
        lib.fp_next.restype = ctypes.c_int
        lib.fp_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8)]
        lib.fp_next_batch.restype = ctypes.c_int
        lib.fp_next_batch.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int]
        lib.fp_close.argtypes = [ctypes.c_void_p]
        lib.fw_open.restype = ctypes.c_void_p
        lib.fw_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int64, ctypes.c_int]
        lib.fw_write.restype = ctypes.c_int
        lib.fw_write.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint8)]
        lib.fw_close.restype = ctypes.c_int
        lib.fw_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


class NativeY4MReader:
    """Threaded-prefetch y4m reader over the C++ pump."""

    def __init__(self, path: str, ring_size: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native framepump unavailable (no g++?)")
        self._lib = lib
        self._h = lib.fp_open(os.fsencode(path), ring_size)
        if not self._h:
            raise IOError(f"cannot open y4m: {path}")
        info = (ctypes.c_int64 * 8)()
        lib.fp_info(self._h, info)
        (self.width, self.height, self.fps_num, self.fps_den,
         self.bit_depth, self.chroma_w, self.chroma_h,
         self.frame_bytes) = (int(v) for v in info)
        self._dtype = np.uint8 if self.bit_depth <= 8 else np.uint16
        self._samp = 1 if self.bit_depth <= 8 else 2

    @property
    def fps(self) -> float:
        return self.fps_num / max(self.fps_den, 1)

    def read_frame(self) -> Optional[Dict[str, np.ndarray]]:
        buf = np.empty(self.frame_bytes, dtype=np.uint8)
        r = self._lib.fp_next(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        )
        if r == 0:
            return None
        if r < 0:
            raise IOError("native framepump read error (truncated/corrupt y4m)")
        return self._split(buf)

    def read_batch(self, n: int) -> list:
        """Read up to n frames with one native call (one big contiguous copy)."""
        buf = np.empty(n * self.frame_bytes, dtype=np.uint8)
        got = self._lib.fp_next_batch(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n
        )
        if got < 0:
            raise IOError("native framepump read error (truncated/corrupt y4m)")
        return [
            self._split(buf[i * self.frame_bytes:(i + 1) * self.frame_bytes])
            for i in range(got)
        ]

    def _split(self, buf: np.ndarray) -> Dict[str, np.ndarray]:
        ny = self.width * self.height
        nc = self.chroma_w * self.chroma_h
        flat = buf.view(self._dtype)
        y = flat[:ny].reshape(self.height, self.width)
        u = flat[ny:ny + nc].reshape(self.chroma_h, self.chroma_w)
        v = flat[ny + nc:ny + 2 * nc].reshape(self.chroma_h, self.chroma_w)
        return {"y": y, "u": u, "v": v}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr

    def close(self) -> None:
        if self._h:
            self._lib.fp_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeY4MWriter:
    """Threaded y4m writer over the C++ write pump (native/framepump.cpp
    fw_*): frames queue into a ring and a C++ thread drains them to disk,
    so scoring/alignment never block on artifact writes. Byte-identical
    output to io.y4m.Y4MWriter (same header line, FRAME markers, plane
    order) — pinned by test_native.py."""

    def __init__(self, path: str, header_line: str, frame_bytes: int,
                 ring_size: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native framepump unavailable (no g++?)")
        self._lib = lib
        self.frame_bytes = int(frame_bytes)
        self._h = lib.fw_open(os.fsencode(path), header_line.encode(),
                              self.frame_bytes, ring_size)
        if not self._h:
            raise IOError(f"cannot open y4m for writing: {path}")

    def write_payload(self, payload: np.ndarray) -> None:
        """Queue one frame payload (concatenated y+u+v bytes)."""
        buf = np.ascontiguousarray(payload).view(np.uint8).ravel()
        if buf.nbytes != self.frame_bytes:
            raise ValueError(
                f"payload is {buf.nbytes} bytes, expected {self.frame_bytes}")
        r = self._lib.fw_write(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r < 0:
            raise IOError("native framewriter failed (disk full?)")

    def close(self) -> None:
        if self._h:
            rc = self._lib.fw_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("native framewriter flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
