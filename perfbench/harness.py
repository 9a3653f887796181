"""One run of one benchmark cell: set-up, the measured window, the check of
what the window produced, and the result line.

Everything that belongs to one cell is data found by name:
``BENCHMARK.json`` names the cell, its configuration file and its traffic
file (``perfbench/workloads/<traffic>.json``); each metric is read by
``perfbench/metrics/<name>.py``; each stage's work and kernel names are in
``perfbench/stages/<stage>.py``; the program functions that get spans in a
traced run are listed in ``perfbench/spans.json``.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from perfbench import check, peaks
from perfbench.inputs import Clips
from perfbench.trace import WINDOW_SPAN, TraceSummary, breakdown, reduce_trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pqa2_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file, by path (metric and stage names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_dyn_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_stages() -> Dict[str, object]:
    return {os.path.basename(p)[:-3]: load_module(p, "stage_" + os.path.basename(p)[:-3])
            for p in sorted(glob.glob(os.path.join(HERE, "stages", "*.py")))}


def load_cell(name: str, bench: Optional[Dict] = None):
    """(benchmark, cell, configuration, traffic) of a cell by name."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "workloads", cell["traffic"] + ".json"))
    return bench, cell, cfg, traffic


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``pqa2_tpu_torch`` is not ``pqa2_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def process_start() -> float:
    """The process's start on the ``time.time`` clock (/proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def pin_allocator() -> bool:
    """Fix glibc's malloc thresholds at the values its dynamic rule
    converges to in a long-running process (mmap above 32 MiB, the heap's
    top trimmed above 64 MiB), so that every run of a cell allocates alike.

    Left dynamic, the program's per-chunk host buffers (16.6 MB of 1080p
    chroma per ``np.stack``) come from the heap, warm, in some processes
    and from fresh page-faulted mappings in others, by the order of earlier
    allocations: 1080p runs fell into a fast and a slow mode. Buffers over
    32 MiB (4K) are mapped fresh either way. False where glibc is absent."""
    import ctypes

    try:
        libc = ctypes.CDLL(None)
        m_trim_threshold, m_mmap_threshold = -1, -3
        return bool(libc.mallopt(m_mmap_threshold, 32 << 20)
                    and libc.mallopt(m_trim_threshold, 64 << 20))
    except (OSError, AttributeError):
        return False


def minor_faults() -> int:
    import resource

    return int(resource.getrusage(resource.RUSAGE_SELF).ru_minflt)


def launch_counters() -> Dict[str, int]:
    """Every launch counter of the program's ``ops/cuda_*`` wrappers:
    ``module.function.attribute`` -> count."""
    import pkgutil

    import pqa2_tpu_torch.ops as ops

    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        if not info.name.startswith("cuda_"):
            continue
        mod = importlib.import_module(f"pqa2_tpu_torch.ops.{info.name}")
        for fname, fn in vars(mod).items():
            if not callable(fn) or getattr(fn, "__module__", None) != mod.__name__:
                continue
            for attr, v in vars(fn).items() if hasattr(fn, "__dict__") else ():
                if (attr == "launches" or attr.endswith("_launches")) and isinstance(v, int):
                    out[f"{info.name}.{fname}.{attr}"] = v
    return out


@dataclass
class Record:
    """One request of the window."""

    index: int
    rung: int
    seconds: float
    results: Optional[Dict]
    json_text: Optional[str]
    scores: object = None


@dataclass
class Context:
    """What the metric readers read."""

    cfg: Dict
    traffic: Dict
    setup_s: float
    window_s: float
    frames: int
    request_seconds: List[float]
    launches: Optional[Dict[str, int]]
    trace: Optional[TraceSummary]
    stages: Dict[str, object] = field(default_factory=dict)
    peaks: object = peaks

    def stage_share(self, name: str):
        """(least seconds, device seconds) of a stage over the window, or
        None where the trace shows none of its kernels."""
        st = self.stages.get(name)
        if st is None or self.trace is None or not getattr(st, "PATTERNS", None):
            return None
        dev = sum(s for k, s in self.trace.device_s.items()
                  if any(re.search(p, k) for p in st.PATTERNS))
        if dev <= 0:
            return None
        b, o = st.work(self.cfg)
        return self.frames * peaks.least_seconds(b, o), dev


def install_spans(torch) -> Callable[[], None]:
    """Wrap the program functions listed in ``spans.json`` in profiler
    spans named after them; returns the function that restores them."""
    undo = []
    for entry in load_json(os.path.join(HERE, "spans.json"))["spans"]:
        mod_name, attr = entry.split(":")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError:
            continue
        orig = getattr(mod, attr, None)
        if not callable(orig):
            continue

        def wrapped(*a, _orig=orig, _name=attr, **k):
            with torch.profiler.record_function(_name):
                return _orig(*a, **k)

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)

    return restore


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def git_head() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() if out.returncode == 0 else "not a git checkout"
    except (OSError, subprocess.SubprocessError):
        return "not a git checkout"


class Run:
    """One run of a cell on ``device``. ``precision`` overrides the
    analyzer's feature precision and ``override`` the values the check
    reads (both for the control, ``perfbench/control.py``)."""

    def __init__(self, bench: Dict, cell: Dict, cfg: Dict, traffic: Dict, *, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 precision: Optional[str] = None, override: Optional[Callable] = None,
                 t_process: Optional[float] = None):
        self.bench, self.cell, self.cfg, self.traffic = bench, cell, cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.precision = precision
        self.override = override
        self.t_process = process_start() if t_process is None else t_process
        self.records: List[Record] = []
        self.clips: Optional[Clips] = None
        self.paths: List[str] = []
        self.allocator_pinned = False

    # -- set-up -------------------------------------------------------------

    def _setup(self, torch, tmp: str):
        from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

        if self.device != "cpu":
            from pqa2_tpu_torch import _build

            _build.library(torch.device(self.device))
            self.build_seconds = _build.build_seconds
        else:
            self.build_seconds = None
        if self.traffic["entry"] == "files":
            from pqa2_tpu_torch.io import native

            native.is_available()
        self.clips = Clips(self.cfg, self.traffic, self.seed, self.device)
        if self.traffic["entry"] == "files":
            self.paths = self.clips.write_files(tmp)
        a = VMAFAnalyzer(device=self.device)
        a.model = self.cfg["model"]
        a.chunk_size = int(self.cfg["chunk_size"])
        a.psnr_enabled = bool(self.cfg["psnr"])
        a.ssim_enabled = bool(self.cfg["ssim"])
        a.feature_precision = self.precision
        self.analyzer = a

    def _request(self, rung: int, out_dir: str):
        a = self.analyzer
        a.set_output_directory(out_dir)
        if self.traffic["entry"] == "files":
            return a.analyze_videos(self.paths[0], self.paths[1 + rung])
        c = self.clips
        return a.analyze_frames(
            c.frame_lists[0], c.frame_lists[1 + rung], fps=float(self.cfg["fps"]),
            model=self.cfg["model"], reference_name="ref", distorted_name=f"rung{rung}",
            bit_depth=int(self.cfg["bit_depth"]), ref_y=c.device_luma[0],
            dist_y=c.device_luma[1 + rung])

    def _one(self, torch, index: int, art: str, keep: bool) -> Record:
        rung = index % len(self.traffic["rungs"])
        d = tempfile.mkdtemp(dir=art)
        try:
            with torch.profiler.record_function("perfbench.request"):
                t0 = time.perf_counter()
                res = self._request(rung, d)
                t1 = time.perf_counter()
            text = None
            if res is not None and keep:
                with open(res["json_path"]) as f:
                    text = f.read()
                res = {k: v for k, v in res.items() if k != "raw_results"}
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return Record(index, rung, t1 - t0, res, text,
                      self.analyzer.last_scores if keep and res is not None else None)

    # -- the run ------------------------------------------------------------

    def execute(self) -> Dict:
        import torch

        tmp = tempfile.mkdtemp(prefix="perfbench-")
        try:
            return self._execute(torch, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _execute(self, torch, tmp: str) -> Dict:
        cuda = self.device != "cpu"
        art = os.path.join(tmp, "artifacts")
        os.makedirs(art)
        self._setup(torch, tmp)
        self._one(torch, 0, art, keep=False)  # warm-up: one request of the cell's shapes
        prof = restore = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts):
                # The profiler's first start in a process is slow: pay it here.
                torch.zeros(1, device=self.device).add_(1)
            restore = install_spans(torch)
            prof = torch.profiler.profile(activities=acts)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = launch_counters()
        faults0 = minor_faults()
        setup_s = time.time() - self.t_process
        if prof is not None:
            prof.start()
        t_start = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            while True:
                self.records.append(self._one(torch, len(self.records), art, keep=True))
                if time.perf_counter() - t_start >= self.seconds:
                    break
        window_s = time.perf_counter() - t_start
        faults = minor_faults() - faults0
        summary = None
        if prof is not None:
            prof.stop()
            restore()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            summary = reduce_trace(path)
            os.remove(path)
        after = launch_counters()
        launches = {k: after[k] - before.get(k, 0) for k in after}
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        ok = [r for r in self.records if r.results is not None]
        frames = sum(int(r.results["frame_count"]) for r in ok)
        ctx = Context(cfg=self.cfg, traffic=self.traffic, setup_s=setup_s, window_s=window_s,
                      frames=frames, request_seconds=[r.seconds for r in self.records],
                      launches=launches, trace=summary, stages=load_stages())
        kind = "per_layer" if self.trace else "end_to_end"
        metrics = {}
        for m in cell_metrics(self.bench, self.cell["name"], kind):
            v = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                            "metric_" + m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        # The program's state is freed before the reference runs.
        self.clips.free_device()
        self.analyzer = None
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        verdict = check.judge(self.records, self.clips, self.cfg, self.traffic, self.seed,
                              override=self.override)
        check_s = time.perf_counter() - t_check
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": peak}
        if summary is not None:
            device["busy_s"] = summary.busy_s
            device["window_s"] = summary.window_s
        out = {"correct": verdict["correct"], "attempted": len(self.records),
               "failed": len(self.records) - len(ok), "metrics": metrics, "device": device}
        if summary is not None:
            out["breakdown"] = breakdown(summary)
        out["checks"] = verdict["checks"]
        self.stamp = {"requests": len(self.records), "frames": frames, "window_s": window_s,
                      "setup_s": setup_s, "build_seconds": self.build_seconds,
                      "memory_peak_bytes": peak, "launches": launches, "check_s": check_s,
                      "minor_faults": faults, "allocator_pinned": self.allocator_pinned,
                      "frames_compared": verdict["frames_compared"],
                      "requests_compared": verdict["requests_compared"],
                      "request_seconds": [r.seconds for r in self.records]}
        return out


def main(argv=None, t_process: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pinned = pin_allocator()
    bench, cell, cfg, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(bench, cell, cfg, traffic, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t_process=t_process)
    run.allocator_pinned = pinned
    out = run.execute()
    return emit(out, run)


def emit(out: Dict, run: "Run") -> int:
    """Print the stamps, the checks on standard error, and the result line;
    refuse to print a result where a forbidden module was loaded."""
    st = run.stamp
    print(f"git head: {git_head()}")
    print(f"card: {card_line()}")
    print(f"requests: {st['requests']} completed in {st['window_s']:.6f} s, "
          f"{st['frames']} frames; setup_s {st['setup_s']:.6f}; "
          f"nvcc build_seconds {st['build_seconds']}; "
          f"max_memory_allocated {st['memory_peak_bytes']}")
    print(f"host: {st['minor_faults']} minor page faults in the window; "
          f"malloc thresholds pinned {st['allocator_pinned']}")
    print(f"check: {st['frames_compared']} frames of {st['requests_compared']} requests "
          f"against the reference in {st['check_s']:.3f} s")
    print("request seconds: " + json.dumps(st["request_seconds"]))
    print("launches: " + json.dumps({k: v for k, v in st["launches"].items() if v}))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
