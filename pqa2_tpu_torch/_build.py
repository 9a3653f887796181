"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

All ``csrc/*.cu`` files are compiled on first use into one shared library
with a plain C interface, ``build/pqa2_tpu_torch/libpqa2_kernels.so`` at the
repository root, and loaded with ctypes: one nvcc process per source, all
started together, then one link. The build key is a hash of the sources and
the flags: a change to either rebuilds, an unchanged tree loads the
existing library.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
--fmad=false``. ``--fmad=false`` keeps every ``a*b+c`` as two roundings:
the VIF double gain chain, the ADM f32 angle test and the SSIM window
formula are pinned to separately rounded products (the kernels also spell
those with ``__dmul_rn``/``__fmul_rn``). ``--use_fast_math`` is never used.

Each kernel's C launcher returns ``cudaGetLastError()``; :func:`launch`
raises on anything but ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from pqa2_tpu_torch._device import require_cuda

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pqa2_tpu_torch"
LIB_NAME = "libpqa2_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: Seconds the last nvcc build took in this process (None: loaded a
#: library built earlier, or nothing loaded yet).
build_seconds: Optional[float] = None


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_key() -> str:
    """Hash of the flags and every source file's name and bytes."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is current."""
    global build_seconds
    lib_path = BUILD_DIR / LIB_NAME
    key_path = BUILD_DIR / (LIB_NAME + ".key")
    key = source_key()
    if lib_path.exists() and key_path.exists() and key_path.read_text() == key:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-8000:])
    os.replace(tmp, lib_path)
    key_path.write_text(key)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library(device=None) -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Needs an sm_90 card."""
    global _lib
    require_cuda(device)
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pqa2_error_string.restype = ctypes.c_char_p
            lib.pqa2_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def function(name: str, argtypes: Sequence, device=None):
    """A launcher from the library with its C signature set. Pointers and
    the stream must be ctypes.c_void_p (a bare int would be cut to 32
    bits)."""
    fn = getattr(library(device), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: Sequence, *args) -> None:
    """Call launcher ``name`` and raise on a refused launch."""
    fn = function(name, argtypes)
    rc = fn(*args)
    if rc != 0:
        msg = _lib.pqa2_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_count_lock = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count (``wrapper.<attr>``) under a
    lock: the sharded scorers launch from one worker thread per device."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim`` dims
    on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
