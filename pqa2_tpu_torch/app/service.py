"""Production scoring service: persistent HTTP daemon, one device owner
(port of pqa2_tpu/app/service.py).

A single worker thread owns the card and drains a FIFO job queue, so

* the kernel library is loaded once per process, by the worker (it builds
  with nvcc first where the build directory has no current library), and
  the log2 table audit runs once per device: every later job launches
  only its kernels; :meth:`ScoringService.warmup` pays for both before
  the first request, and
* device work is strictly serialized (one owner of the card).

HTTP handling runs on its own threads and never touches the device. A job
that fails on the card is reported as ``status: "error"`` and the worker
goes on; nothing reruns it elsewhere. After a sticky CUDA error every later
job fails the same way, and is reported so.
Artifacts use the same on-disk contract as interactive runs
(``<test>_<ts>_vmaf.json`` / ``_psnr.txt`` / ``_ssim.txt``,
the reference app's results dir layout, app/vmaf_analyzer.py:281-311),
so the results-history browser sees served jobs too.

Endpoints (all JSON):

  GET  /healthz            liveness: backend, queue depth, uptime, counters
  GET  /models             packaged model registry
  GET  /jobs               all jobs, most recent first
  GET  /jobs/<id>          a single job
  POST /score              submit a job -> 202 {"job_id": ...}
        body: {"reference": path, "distorted": path, "model"?: name,
               "precision"?: auto|integer|integer_fast|float,
               "subsample"?: int, "pool"?: mean|min|max|harmonic_mean,
               "psnr"?: bool, "ssim"?: bool, "duration"?: seconds,
               "test_name"?: str}
  POST /jobs/<id>/cancel   cancel a QUEUED job (a running job completes)

CLI: ``python -m pqa2_tpu_torch.cli serve [--host H] [--port P] [--out DIR]
[--warmup] [--device cuda|cpu]``.  Binds 127.0.0.1 by default — front it
with a real proxy for anything beyond localhost. ``device`` defaults to
``"cuda"``: :func:`serve_forever` refuses to start without the card, before
it binds a socket.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.pipeline.scoring import resolve_device

logger = logging.getLogger(__name__)

_JOB_FIELDS = ("reference", "distorted")
_OPT_FIELDS = {
    "model": str,
    "precision": str,
    "subsample": int,
    "pool": str,
    "psnr": bool,
    "ssim": bool,
    "duration": (int, float),
    "test_name": str,
}
_PRECISIONS = ("auto", "integer", "integer_fast", "float")
_POOLS = ("mean", "min", "max", "harmonic_mean")
# Finished jobs retained for GET /jobs (specs + results are kept in RAM;
# a long-lived daemon must not grow without bound).
_MAX_FINISHED_JOBS = 512


def _json_safe(obj):
    """Results dicts carry numpy scalars; make them JSON-serializable. The
    port's results dict holds no torch values (``VMAFAnalyzer._finalize``
    and the JSON writer convert every score with ``float``/``int``)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()  # fall through: item() can yield inf/nan floats
    if isinstance(obj, np.ndarray):
        return [_json_safe(v) for v in obj.tolist()]
    if isinstance(obj, float) and not np.isfinite(obj):
        # RFC 8259 has no Infinity/NaN literals; strict clients reject them.
        if np.isnan(obj):
            return None
        return 1e9 if obj > 0 else -1e9
    return obj


@dataclass
class Job:
    id: str
    spec: Dict
    status: str = "queued"  # queued | running | done | error | cancelled
    result: Optional[Dict] = None
    error: Optional[str] = None
    progress: int = 0
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None

    def to_dict(self) -> Dict:
        d = {
            "job_id": self.id,
            "status": self.status,
            "progress": self.progress,
            "spec": self.spec,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
        }
        if self.result is not None:
            d["result"] = self.result
        if self.error is not None:
            d["error"] = self.error
        return d


class ScoringService:
    """Job queue + single scoring worker.  Start with :meth:`start`,
    submit via :meth:`submit`, serve HTTP via :meth:`make_server`. Jobs
    score on ``device`` (``"cpu"``: the plain versions)."""

    def __init__(self, out_dir: Optional[str] = None, options_manager=None,
                 device: Union[str, torch.device] = "cuda"):
        self.out_dir = out_dir
        self.device = torch.device(device)
        self._options_manager = options_manager
        self._jobs: Dict[str, Job] = {}
        self._order: List[str] = []
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._analyzer = None  # built lazily in the worker thread
        self._t0 = time.time()
        self.jobs_done = 0
        self.jobs_failed = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()  # support start() after stop()
        self._worker = threading.Thread(
            target=self._worker_loop, name="pqa2-score-worker", daemon=True
        )
        self._worker.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None

    # -- job API -----------------------------------------------------------

    def validate_spec(self, spec: Dict) -> Optional[str]:
        """Returns an error message for a bad spec, None when acceptable."""
        if not isinstance(spec, dict):
            return "body must be a JSON object"
        for k in _JOB_FIELDS:
            v = spec.get(k)
            if not v or not isinstance(v, str):
                return f"missing required field {k!r}"
        for k, t in _OPT_FIELDS.items():
            v = spec.get(k)
            if v is None:  # absent or explicit null = use the default
                continue
            # bool subclasses int: reject true/false for numeric fields.
            if not isinstance(v, t) or (t is not bool
                                        and isinstance(v, bool)):
                return f"field {k!r} has wrong type"
        if spec.get("precision") not in (None, *_PRECISIONS):
            return f"precision must be one of {_PRECISIONS}"
        if spec.get("pool") not in (None, *_POOLS):
            return f"pool must be one of {_POOLS}"
        unknown = set(spec) - set(_JOB_FIELDS) - set(_OPT_FIELDS)
        if unknown:
            return f"unknown fields: {sorted(unknown)}"
        return None

    def submit(self, spec: Dict) -> Job:
        err = self.validate_spec(spec)
        if err:
            raise ValueError(err)
        with self._lock:
            job = Job(id=f"job-{next(self._ids)}", spec=dict(spec))
            self._jobs[job.id] = job
            self._order.append(job.id)
            self._prune_locked()
        self._q.put(job.id)
        return job

    def _prune_locked(self) -> None:
        """Drop the oldest finished jobs beyond the retention cap (held
        lock required).  Queued/running jobs are never dropped."""
        finished = [i for i in self._order
                    if self._jobs[i].status not in ("queued", "running")]
        for i in finished[:max(0, len(finished) - _MAX_FINISHED_JOBS)]:
            del self._jobs[i]
            self._order.remove(i)

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self, limit: Optional[int] = None) -> List[Dict]:
        with self._lock:
            ids = list(reversed(self._order))
            if limit is not None:
                ids = ids[:max(0, limit)]
            return [self._jobs[i].to_dict() for i in ids]

    def cancel(self, job_id: str) -> bool:
        """Cancel a queued job.  Running/finished jobs are not interrupted
        (device steps are short; mid-clip abort is the analyzer's
        terminate_analysis, reserved for interactive use)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.status != "queued":
                return False
            job.status = "cancelled"
            job.finished_at = time.time()
            return True

    def stats(self) -> Dict:
        with self._lock:
            queued = sum(1 for j in self._jobs.values() if j.status == "queued")
            running = sum(1 for j in self._jobs.values() if j.status == "running")
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self._t0, 1),
            "jobs_queued": queued,
            "jobs_running": running,
            "jobs_done": self.jobs_done,
            "jobs_failed": self.jobs_failed,
        }

    # -- worker ------------------------------------------------------------

    def _build_analyzer(self):
        from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

        analyzer = VMAFAnalyzer(self._options_manager, device=self.device)
        if self.out_dir:
            analyzer.set_output_directory(self.out_dir)
        return analyzer

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            job_id = self._q.get()
            if job_id is None:
                continue
            with self._lock:
                job = self._jobs.get(job_id)
                if job is None or job.status != "queued":
                    continue  # cancelled while queued
                job.status = "running"
                job.started_at = time.time()
            try:
                self._run_job(job)
            except Exception as e:  # worker must survive any job failure
                logger.exception("job %s failed", job.id)
                job.error = str(e)
                job.status = "error"
                self.jobs_failed += 1
            finally:
                if job.finished_at is None:
                    job.finished_at = time.time()

    def _run_job(self, job: Job) -> None:
        if self._analyzer is None:
            self._analyzer = self._build_analyzer()
        analyzer = self._analyzer
        spec = job.spec

        analyzer.model = spec.get("model") or "vmaf_v0.6.1"
        precision = spec.get("precision")
        analyzer.feature_precision = (
            None if precision in (None, "auto") else precision
        )
        analyzer.pool_method = spec.get("pool") or "mean"
        analyzer.feature_subsample = int(spec.get("subsample") or 1)
        # Explicit JSON null means "use the default" (enabled), like the
        # other optional fields — only a real false disables a metric.
        psnr = spec.get("psnr")
        ssim = spec.get("ssim")
        analyzer.psnr_enabled = True if psnr is None else bool(psnr)
        analyzer.ssim_enabled = True if ssim is None else bool(ssim)
        analyzer.set_test_name(spec.get("test_name") or job.id)

        errors: List[str] = []
        with analyzer.analysis_progress.connected(
            lambda p: setattr(job, "progress", int(p))
        ), analyzer.analysis_failed.connected(errors.append):
            results = analyzer.analyze_videos(
                spec["reference"], spec["distorted"],
                model=analyzer.model, duration=spec.get("duration"),
            )
        job.finished_at = time.time()
        if results is None:
            job.error = errors[-1] if errors else "analysis failed"
            job.status = "error"
            self.jobs_failed += 1
            return
        # Lean response: pooled scores + artifact paths.  The per-frame
        # series lives in json_path (libvmaf log schema) on disk.
        job.result = _json_safe(
            {k: v for k, v in results.items() if k != "raw_results"}
        )
        job.result["pooled_metrics"] = _json_safe(
            results["raw_results"].get("pooled_metrics", {})
        )
        job.result["elapsed_s"] = round(job.finished_at - job.started_at, 3)
        job.progress = 100
        job.status = "done"
        self.jobs_done += 1

    # -- HTTP --------------------------------------------------------------

    def make_server(self, host: str = "127.0.0.1", port: int = 8990):
        """Build (without starting) the HTTP server bound to this service."""
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, obj) -> None:
                body = json.dumps(obj, indent=2).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self):
                """-> (path sans query/trailing-slash, parsed query dict)."""
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                return parts.path.rstrip("/"), parse_qs(parts.query)

            def _read_body(self) -> bytes:
                """Always drain the request body — an unread body desyncs
                the next request on an HTTP/1.1 keep-alive connection."""
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                path, q = self._route()
                if path in ("", "/healthz"):
                    return self._reply(200, service.stats())
                if path == "/models":
                    from pqa2_tpu_torch.models.registry import available_models

                    return self._reply(200, {"models": available_models()})
                if path == "/jobs":
                    try:
                        limit = int(q["limit"][0]) if "limit" in q else None
                    except ValueError:
                        return self._reply(400,
                                           {"error": "limit must be an int"})
                    return self._reply(200, {"jobs": service.jobs(limit)})
                if path.startswith("/jobs/"):
                    job = service.get(path.split("/", 2)[2])
                    if job is None:
                        return self._reply(404, {"error": "no such job"})
                    return self._reply(200, job.to_dict())
                return self._reply(404, {"error": f"no route {self.path!r}"})

            def do_POST(self):
                path, _ = self._route()
                body = self._read_body()
                if path == "/score":
                    try:
                        spec = json.loads(body or b"{}")
                    except (ValueError, json.JSONDecodeError) as e:
                        return self._reply(400, {"error": f"bad JSON: {e}"})
                    try:
                        job = service.submit(spec)
                    except ValueError as e:
                        return self._reply(400, {"error": str(e)})
                    return self._reply(202, {"job_id": job.id})
                if path.startswith("/jobs/") and path.endswith("/cancel"):
                    job_id = path.split("/", 3)[2]
                    if service.cancel(job_id):
                        return self._reply(200, {"job_id": job_id,
                                                 "status": "cancelled"})
                    job = service.get(job_id)
                    if job is None:
                        return self._reply(404, {"error": "no such job"})
                    return self._reply(
                        409, {"error": f"job is {job.status}, not queued"})
                return self._reply(404, {"error": f"no route {self.path!r}"})

        return ThreadingHTTPServer((host, port), Handler)

    def warmup(self, frames: int = 4, h: int = 216, w: int = 384) -> Job:
        """Run one tiny synthetic pair through the full job path so the
        first real request never pays the library load (or the nvcc build)
        and the log2 table audit. Returns the finished job."""
        import tempfile

        from pqa2_tpu_torch.io.y4m import write_y4m

        rng = np.random.default_rng(0)
        y = rng.integers(16, 235, (frames, h, w)).astype(np.uint8)
        d = np.clip(y.astype(np.int16) + rng.integers(-4, 5, y.shape),
                    0, 255).astype(np.uint8)

        def mk(arr):
            return [{"y": f,
                     "u": np.full((h // 2, w // 2), 128, np.uint8),
                     "v": np.full((h // 2, w // 2), 128, np.uint8)}
                    for f in arr]

        with tempfile.TemporaryDirectory(prefix="pqa2_warmup_") as td:
            rp, dp = os.path.join(td, "r.y4m"), os.path.join(td, "d.y4m")
            write_y4m(rp, mk(y))
            write_y4m(dp, mk(d))
            job = self.submit({"reference": rp, "distorted": dp,
                               "test_name": "warmup"})
            while job.status in ("queued", "running"):
                time.sleep(0.1)
            logger.info("warmup %s (%.1fs)", job.status,
                        (job.finished_at or 0) - (job.started_at or 0))
        return job


def serve_forever(host: str = "127.0.0.1", port: int = 8990,
                  out_dir: Optional[str] = None, warmup: bool = False,
                  device: Union[str, torch.device] = "cuda") -> None:
    """Blocking entry point used by ``python -m pqa2_tpu_torch serve``.
    Raises without the card (``device="cuda"``) before it binds a socket."""
    resolve_device(device)
    service = ScoringService(out_dir=out_dir, device=device)
    service.start()
    if warmup:
        job = service.warmup()
        print(f"[serve] warmup {job.status} in "
              f"{(job.finished_at or 0) - job.submitted_at:.3f} s"
              + (f": {job.error}" if job.error else ""), flush=True)
    httpd = service.make_server(host, port)
    port = httpd.server_address[1]
    logger.info("pqa2 scoring service on http://%s:%d", host, port)
    print(f"[serve] listening on http://{host}:{port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.stop()
