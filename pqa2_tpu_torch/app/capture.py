# Copy of pqa2_tpu/app/capture.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""CaptureManager — bookend capture orchestration with pluggable backends.

Rebuild of the reference CaptureManager/CaptureMonitor (app/capture.py):
same state machine (CaptureState), signal channels (status_update/
progress_update/state_changed/capture_started/capture_finished/
frame_available), duration policy (loops x (ref + 2 x bookend) x 1.2 margin,
ceil — capture.py:855-888) and output-path policy. Hardware I/O stays a
host-side concern (SURVEY.md section 2.3 N12): the DeckLink backend shells
out to ``ffmpeg -f decklink`` exactly like the reference when an ffmpeg
binary exists, and a file-playback backend simulates the full capture chain
(white bookends + looped content) so every downstream stage is testable
without a card — the test double the reference's fallback tables imply
(SURVEY.md section 4, item 5).
"""

from __future__ import annotations

import contextlib
import enum
import json
import logging
import math
import os
import re
import shutil
import signal as _signal
import subprocess
import tempfile
import threading
import time
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from pqa2_tpu_torch.utils.signals import Signal

logger = logging.getLogger(__name__)

MAX_REPAIR_ATTEMPTS = 3

# -- capture child hygiene ----------------------------------------------------
#
# The reference sweeps *every* process named ffmpeg before each capture
# (app/capture.py:412-454, psutil name match) so a crashed run can't hold the
# DeckLink device. A name-match kill is a shotgun; this framework keeps a
# registry of the capture children it spawned (pid + cmdline) and the sweep
# kills only registered pids whose live cmdline still matches the recorded
# one — same de-conflict guarantee, zero collateral.

# Per-user path: a shared /tmp file would make a second user's capture die
# on os.replace(PermissionError) with the ffmpeg child already running.
_DEFAULT_REGISTRY = os.path.join(
    tempfile.gettempdir(),
    f"pqa2_capture_pids_{getattr(os, 'getuid', lambda: 0)()}.json",
)


@contextlib.contextmanager
def _registry_lock(path: str):
    """Serialise read-modify-write cycles on the registry across processes.

    Without it a sweep racing another process's register can overwrite and
    drop the fresh pid entry, leaving that child unsweepable after a crash
    (ADVICE round-2). flock on a sidecar .lock file; on platforms without
    fcntl the lock degrades to a no-op (single-user Windows desktops — the
    reference app's own domain — run one capture at a time anyway)."""
    try:
        import fcntl
    except ImportError:  # non-POSIX fallback
        yield
        return
    with open(f"{path}.lock", "a+") as lockf:
        fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)


def _read_registry(path: str) -> List[Dict]:
    try:
        with open(path) as f:
            return json.load(f) or []
    except (OSError, ValueError):
        return []


def _write_registry(path: str, entries: List[Dict]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(entries, f)
    os.replace(tmp, path)


def _live_cmdline(pid: int) -> Optional[List[str]]:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return [a.decode(errors="replace") for a in raw.split(b"\0") if a]


def register_capture_pid(pid: int, cmd: List[str],
                         registry_path: str = _DEFAULT_REGISTRY) -> None:
    with _registry_lock(registry_path):
        entries = _read_registry(registry_path)
        entries.append({"pid": int(pid), "cmd": list(map(str, cmd))})
        _write_registry(registry_path, entries)


def unregister_capture_pid(pid: int,
                           registry_path: str = _DEFAULT_REGISTRY) -> None:
    with _registry_lock(registry_path):
        entries = [e for e in _read_registry(registry_path)
                   if e.get("pid") != int(pid)]
        _write_registry(registry_path, entries)


def sweep_lingering_captures(registry_path: str = _DEFAULT_REGISTRY,
                             kill_wait: float = 2.0) -> int:
    """Kill capture children left over from crashed runs (pre-capture
    hygiene, reference app/capture.py:412-454). Only pids we registered AND
    whose current cmdline equals the recorded one are touched (a recycled
    pid never matches). Returns the number of processes stopped."""
    with _registry_lock(registry_path):
        return _sweep_locked(registry_path, kill_wait)


def _sweep_locked(registry_path: str, kill_wait: float) -> int:
    entries = _read_registry(registry_path)
    if not entries:
        return 0
    stopped = 0
    survivors: List[Dict] = []
    for e in entries:
        pid, cmd = int(e.get("pid", -1)), e.get("cmd") or []
        live = _live_cmdline(pid) if pid > 0 else None
        if live is None:
            continue  # exited already; drop the stale entry
        if live != cmd:
            logger.info("pid %d was recycled (cmdline mismatch); skipping", pid)
            continue
        logger.info("stopping lingering capture child pid %d", pid)
        try:
            os.kill(pid, _signal.SIGINT)
            deadline = time.time() + kill_wait
            while time.time() < deadline and _live_cmdline(pid) == cmd:
                time.sleep(0.05)
            if _live_cmdline(pid) == cmd:
                os.kill(pid, _signal.SIGKILL)
            stopped += 1
        except OSError as err:
            logger.warning("could not stop pid %d: %s", pid, err)
            survivors.append(e)
    _write_registry(registry_path, survivors)
    return stopped


def graceful_stop(proc: subprocess.Popen, quit_wait: float = 5.0,
                  int_wait: float = 10.0, term_wait: float = 5.0) -> Optional[int]:
    """Stop an ffmpeg-style child through the escalation ladder the
    reference uses (app/capture.py:189-256): 'q' on stdin (lets ffmpeg
    finalise the container index), then SIGINT, then terminate(), then
    kill(). Each rung waits before escalating. Returns the exit code."""
    if proc.poll() is not None:
        return proc.returncode

    def _wait(seconds: float) -> bool:
        try:
            proc.wait(timeout=seconds)
            return True
        except subprocess.TimeoutExpired:
            return False

    if proc.stdin is not None:
        try:
            data = "q\n" if getattr(proc.stdin, "encoding", None) else b"q\n"
            proc.stdin.write(data)
            proc.stdin.flush()
            logger.info("sent 'q' to capture child")
            if _wait(quit_wait):
                return proc.returncode
        except (OSError, ValueError) as e:
            logger.debug("could not send 'q': %s", e)
    try:
        proc.send_signal(_signal.SIGINT)
        logger.info("sent SIGINT to capture child")
        if _wait(int_wait):
            return proc.returncode
    except OSError:
        pass
    try:
        proc.terminate()
        logger.info("terminated capture child")
        if _wait(term_wait):
            return proc.returncode
    except OSError:
        pass
    logger.warning("capture child ignored all signals; killing")
    try:
        proc.kill()
        proc.wait(timeout=5.0)
    except (OSError, subprocess.TimeoutExpired):
        pass
    return proc.returncode


class CaptureState(enum.Enum):
    IDLE = 0
    INITIALIZING = 1
    CAPTURING = 2
    PROCESSING = 3
    COMPLETED = 4
    ERROR = 5


# -- backends ---------------------------------------------------------------


class CaptureBackend:
    """One capture attempt: produce a video file at output_path."""

    def capture(self, device_name: str, duration: float, output_path: str,
                options: Dict, progress_cb) -> bool:
        raise NotImplementedError

    def stop(self) -> None:
        """Request a graceful stop of an in-flight capture (optional)."""

    # Set by the manager: called with the captured frame count as the
    # backend learns it (the reference's CaptureMonitor frame counter,
    # app/capture.py:29-261 -> capture_tab.update_frame_counter).
    frame_cb = None


class DeckLinkBackend(CaptureBackend):
    """ffmpeg -f decklink capture (the reference's hardware path,
    app/capture.py:917-998). Requires an ffmpeg binary + a card."""

    def __init__(self, ffmpeg_path: Optional[str] = None,
                 registry_path: str = _DEFAULT_REGISTRY):
        self.ffmpeg_path = ffmpeg_path or shutil.which("ffmpeg")
        self.registry_path = registry_path
        self._proc: Optional[subprocess.Popen] = None

    def build_command(self, device_name: str, duration: float,
                      output_path: str, options: Dict) -> List[str]:
        fmt = options.get("format_code", "Hp29")
        pix = options.get("pixel_format", "uyvy422")
        encoder = options.get("encoder", "libx264")
        crf = options.get("crf", 18)
        preset = options.get("preset", "fast")
        cmd = [
            self.ffmpeg_path or "ffmpeg", "-y", "-hide_banner",
            "-f", "decklink",
            "-format_code", str(fmt),
            "-video_input", str(options.get("video_input", "hdmi")),
            "-i", device_name,
            "-t", f"{duration:.3f}",
            "-c:v", encoder, "-crf", str(crf), "-preset", preset,
            "-pix_fmt", "yuv420p" if pix == "uyvy422" else pix,
        ]
        if options.get("disable_audio"):
            cmd.append("-an")
        cmd.append(output_path)
        return cmd

    def capture(self, device_name, duration, output_path, options, progress_cb):
        if not self.ffmpeg_path:
            raise RuntimeError("ffmpeg binary not found; DeckLink capture unavailable")
        # Pre-capture hygiene: a crashed earlier run may still hold the
        # card; stop any child we previously registered (reference
        # app/capture.py:412-454 sweeps by process name — see the registry
        # docstring for why this is pid+cmdline instead).
        swept = sweep_lingering_captures(self.registry_path)
        if swept:
            logger.info("swept %d lingering capture process(es)", swept)
            time.sleep(0.5)  # let the capture card be released
        cmd = self.build_command(device_name, duration, output_path, options)
        logger.info("capture command: %s", " ".join(cmd))
        proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
        )
        self._proc = proc
        register_capture_pid(proc.pid, cmd, self.registry_path)
        # Drain stderr continuously: ffmpeg writes stats throughout a
        # capture and blocks once the 64KB pipe buffer fills — a long
        # capture would stall mid-run if nobody reads. Keep only a tail
        # for the error message.
        err_tail: List[str] = []
        frame_re = re.compile(r"frame=\s*(\d+)")

        def _drain():
            try:
                for line in proc.stderr:
                    err_tail.append(line)
                    if len(err_tail) > 50:
                        del err_tail[:-50]
                    if self.frame_cb is not None:
                        m = frame_re.search(line)
                        if m:
                            self.frame_cb(int(m.group(1)))
            except (OSError, ValueError):
                pass

        drain = threading.Thread(target=_drain, daemon=True)
        drain.start()
        try:
            start = time.time()
            watchdog = duration * 2 + 10  # terminate runaways (capture.py:80-85)
            while proc.poll() is None:
                elapsed = time.time() - start
                progress_cb(min(int(100 * elapsed / max(duration, 0.01)), 99))
                if elapsed > watchdog:
                    graceful_stop(proc)
                    raise TimeoutError("capture exceeded 2x expected duration")
                time.sleep(0.25)
            if proc.returncode != 0:
                drain.join(timeout=2.0)
                stderr = "".join(err_tail)
                raise RuntimeError(f"ffmpeg capture failed: {stderr[-400:]}")
            return True
        finally:
            self._proc = None
            unregister_capture_pid(proc.pid, self.registry_path)

    def stop(self) -> None:
        """Graceful-stop ladder on the in-flight child ('q' -> SIGINT ->
        terminate -> kill, reference app/capture.py:189-256)."""
        proc = self._proc
        if proc is not None:
            graceful_stop(proc)


class FilePlaybackBackend(CaptureBackend):
    """Fake capture: synthesises what the DUT chain would produce — white
    bookends around looped reference content, written as .y4m. Drives the
    whole pipeline without hardware."""

    def __init__(self, reference_path: Optional[str] = None,
                 noise_sigma: float = 2.0, realtime: bool = False):
        self.reference_path = reference_path
        self.noise_sigma = noise_sigma
        self.realtime = realtime

    def capture(self, device_name, duration, output_path, options, progress_cb):
        from pqa2_tpu_torch.io.video import VideoReader
        from pqa2_tpu_torch.io.y4m import write_y4m

        src = self.reference_path or options.get("reference_path")
        if not src or not os.path.exists(src):
            raise FileNotFoundError(f"playback source not found: {src!r}")
        with VideoReader(src) as r:
            frames = list(r)
            fps = r.info.frame_rate or 30.0
        if not frames:
            raise ValueError("playback source has no frames")

        bookend_s = float(options.get("bookend_duration", 0.2))
        n_bookend = max(int(round(bookend_s * fps)), 3)
        h, w = frames[0]["y"].shape
        ch, cw = frames[0]["u"].shape
        white = {
            "y": np.full((h, w), 235, np.uint8),
            "u": np.full((ch, cw), 128, np.uint8),
            "v": np.full((ch, cw), 128, np.uint8),
        }
        rng = np.random.default_rng(0)

        def degrade(fr):
            if self.noise_sigma <= 0:
                return fr
            out = {}
            for p, v in fr.items():
                noise = rng.normal(0, self.noise_sigma, v.shape)
                out[p] = np.clip(v.astype(np.float32) + noise, 0, 255).astype(np.uint8)
            return out

        total = int(round(duration * fps))
        captured = []
        loop = [white] * n_bookend + [degrade(f) for f in frames]
        i = 0
        while len(captured) < total:
            captured.append(loop[i % len(loop)])
            i += 1
            if i % 10 == 0:
                progress_cb(min(int(100 * len(captured) / total), 99))
                if self.frame_cb is not None:
                    self.frame_cb(len(captured))
            if self.realtime:
                time.sleep(1.0 / fps)
        captured += [white] * n_bookend  # closing bookend
        write_y4m(output_path, captured, fps=(int(round(fps * 1000)), 1000))
        return True


# -- manager ----------------------------------------------------------------


class CaptureManager:
    """Bookend capture orchestration (app/capture.py:263-1063)."""

    def __init__(self, options_manager=None, backend: Optional[CaptureBackend] = None):
        self.status_update = Signal(str, name="status_update")
        self.progress_update = Signal(int, name="progress_update")
        self.state_changed = Signal(object, name="state_changed")
        self.capture_started = Signal(name="capture_started")
        self.capture_finished = Signal(bool, str, name="capture_finished")
        self.frame_available = Signal(object, name="frame_available")
        # (captured_frames, estimated_total) — the CaptureMonitor counter
        # channel (reference app/capture.py:29-261).
        self.frame_count_updated = Signal(int, int, name="frame_count_updated")

        self.options_manager = options_manager
        self.backend = backend or FilePlaybackBackend()
        self.state = CaptureState.IDLE
        self.reference_info: Optional[Dict] = None
        self.output_directory: Optional[str] = None
        self.test_name: Optional[str] = None
        self.current_output_path: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- configuration ------------------------------------------------------

    def set_output_directory(self, output_dir: str) -> None:
        self.output_directory = output_dir

    def set_test_name(self, test_name: str) -> None:
        self.test_name = test_name

    def set_reference_video(self, reference_info: Dict) -> None:
        self.reference_info = reference_info
        if isinstance(self.backend, FilePlaybackBackend):
            self.backend.reference_path = reference_info.get("path")

    def is_capturing(self) -> bool:
        return self.state == CaptureState.CAPTURING

    def _set_state(self, state: CaptureState) -> None:
        self.state = state
        self.state_changed.emit(state)

    # -- policies -----------------------------------------------------------

    def _calculate_capture_duration(self) -> float:
        """loops x (ref + 2 x bookend), x1.2 margin, ceil to whole seconds
        (app/capture.py:855-888)."""
        ref_duration = float((self.reference_info or {}).get("duration", 0.0))
        opts = {}
        if self.options_manager is not None:
            opts = self.options_manager.get_setting("bookend") or {}
        min_loops = int(opts.get("min_loops", 3))
        max_loops = int(opts.get("max_loops", 10))
        bookend_s = float(opts.get("bookend_duration", 0.2))
        min_time = float(opts.get("min_capture_time", 5))
        max_time = float(opts.get("max_capture_time", 30))

        loop_s = ref_duration + 2.0 * bookend_s
        loops = min_loops
        while loops < max_loops and loops * loop_s < min_time:
            loops += 1
        duration = loops * loop_s * 1.2
        duration = min(max(duration, min_time), max_time)
        return float(math.ceil(duration))

    def _prepare_output_path(self) -> str:
        """Per-test output path policy (app/capture.py:359-410)."""
        out_dir = self.output_directory or os.getcwd()
        name = self.test_name or "capture"
        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        os.makedirs(out_dir, exist_ok=True)
        return os.path.join(out_dir, f"{name}_{ts}.y4m")

    # -- capture lifecycle --------------------------------------------------

    def start_bookend_capture(self, device_name: str) -> bool:
        """Asynchronous capture (app/capture.py:830-1013)."""
        if self.is_capturing():
            self.status_update.emit("Capture already in progress")
            return False
        self._set_state(CaptureState.INITIALIZING)
        self._stop.clear()
        duration = self._calculate_capture_duration()
        if duration <= 0:
            self._set_state(CaptureState.ERROR)
            self.capture_finished.emit(False, "no reference video set")
            return False
        self.current_output_path = self._prepare_output_path()
        options: Dict = {}
        if self.options_manager is not None:
            options.update(self.options_manager.get_setting("capture") or {})
            options.update(self.options_manager.get_setting("bookend") or {})
        if self.reference_info:
            options["reference_path"] = self.reference_info.get("path")

        fps_est = float(options.get("frame_rate") or 30.0)
        total_est = int(round(duration * fps_est))
        self.backend.frame_cb = (
            lambda nf: self.frame_count_updated.emit(int(nf), total_est))

        def worker():
            self._set_state(CaptureState.CAPTURING)
            self.capture_started.emit()
            self.status_update.emit(
                f"Capturing {duration:.0f}s from {device_name}..."
            )
            try:
                ok = self.backend.capture(
                    device_name, duration, self.current_output_path, options,
                    self.progress_update.emit,
                )
                if self._stop.is_set():
                    raise InterruptedError("capture stopped by user")
                self._set_state(CaptureState.PROCESSING)
                self.progress_update.emit(100)
                self._set_state(CaptureState.COMPLETED)
                self.status_update.emit("Capture complete")
                self.capture_finished.emit(bool(ok), self.current_output_path)
            except Exception as e:
                logger.exception("capture failed")
                self._set_state(CaptureState.ERROR)
                self.status_update.emit(f"Capture failed: {e}")
                self.capture_finished.emit(False, str(e))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return True

    def stop_capture(self, cleanup_temp: bool = False) -> None:
        """Graceful stop (app/capture.py:770-828): signal the worker, run
        the backend's stop ladder on any in-flight child, then join."""
        self._stop.set()
        try:
            self.backend.stop()
        except Exception:
            logger.exception("backend stop failed")
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if cleanup_temp and self.current_output_path:
            try:
                os.remove(self.current_output_path)
            except OSError:
                pass
        if self.state == CaptureState.CAPTURING:
            self._set_state(CaptureState.IDLE)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the capture worker (test/headless convenience)."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- preview (synthetic status frames, app/capture.py:489-605) ----------

    def start_preview(self, fps: float = 5.0) -> None:
        """Emit frame_available with synthetic status frames — the
        reference draws these with OpenCV when no live signal is shown."""
        if getattr(self, "_preview_stop", None) is not None:
            return
        self._preview_stop = threading.Event()

        def loop():
            h, w = 180, 320
            i = 0
            while not self._preview_stop.is_set():
                frame = np.full((h, w), 32, np.uint8)
                frame[10:20, 10 + 4 * (i % 60):14 + 4 * (i % 60)] = 220
                msg = self.state.name
                # coarse "text": brightness bars encode the state enum value
                frame[40:48, 10:10 + 12 * (self.state.value + 1)] = 180
                self.frame_available.emit(frame)
                i += 1
                time.sleep(1.0 / fps)

        self._preview_thread = threading.Thread(target=loop, daemon=True)
        self._preview_thread.start()

    def stop_preview(self) -> None:
        stop = getattr(self, "_preview_stop", None)
        if stop is not None:
            stop.set()
            self._preview_thread.join(timeout=2.0)
            self._preview_stop = None
