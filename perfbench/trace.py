"""Reduction of a torch.profiler trace of the measured window: the seconds
the device was busy, device time by operation, and the idle gaps named by
what the host was doing.

The trace is the profiler's Chrome-trace export. Device activity is every
complete event of the categories ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; host activity is every complete event of the host
categories (operators, the benchmark's own spans, CUDA runtime calls). The
window is the benchmark's ``perfbench.window`` span.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "perfbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"}


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: Device seconds by the operation's full name (kernel names as the
    #: profiler gives them).
    device_s: Dict[str, float] = field(default_factory=dict)
    #: Idle seconds by the innermost host event that spans the gap's middle.
    idle_s: Dict[str, float] = field(default_factory=dict)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and parameters
    (short template arguments kept: they tell a kernel's variants apart); other
    operations as they are."""
    s = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    if s.startswith("Memcpy") or s.startswith("Memset"):
        return s
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            s = s[:i].strip()
            break
    if "<" in s and len(s) > 80:  # a library kernel's long template: its name alone
        s = s[:s.index("<")]
    return s


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_at(host: List[Tuple[float, float, str]], starts: List[float], t: float,
             scan: Optional[int] = None) -> Optional[str]:
    """The latest-starting host event that contains time ``t`` (on one
    thread, the innermost), looking back at most ``scan`` events."""
    i = bisect.bisect_right(starts, t) - 1
    stop = -1 if scan is None else max(i - scan, -1)
    for j in range(i, stop, -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return None


def reduce_trace(path: str) -> Optional[TraceSummary]:
    """Read a Chrome-trace export; None when it holds no window span."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = None
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e["dur"])
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev.append((a, b, name))
        elif cat in HOST_CATS:
            if name == WINDOW_SPAN:
                win = (a, b)
            else:
                host.append((a, b, name))
                if cat == "user_annotation":
                    spans.append((a, b, name))
    if win is None:
        return None
    w0, w1 = win
    device_s: Dict[str, float] = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            device_s[name] = device_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host.sort()
    spans.sort()
    starts = [h[0] for h in host]
    span_starts = [h[0] for h in spans]
    idle_s: Dict[str, float] = {}
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            m = 0.5 * (a + t)
            # Operators first (a short look back), then the spans, which are few.
            name = (_host_at(host, starts, m, scan=400) or _host_at(spans, span_starts, m)
                    or "(no host event)")
            idle_s[name] = idle_s.get(name, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, device_s=device_s,
                        idle_s=idle_s)


def breakdown(summary: TraceSummary, top: int = 10) -> Dict[str, List]:
    """The contract's ``breakdown``: the device operations that took most
    time (by short name) and the idle time by host event, largest first."""
    ops: Dict[str, float] = {}
    for name, s in summary.device_s.items():
        k = short_name(name)
        ops[k] = ops.get(k, 0.0) + s
    return {
        "device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in
                      sorted(summary.idle_s.items(), key=lambda kv: -kv[1])[:top]],
    }
