"""The comparison that decides ``correct``.

Once the window has closed, a sample of its completed requests, drawn
from the seed with one of each rung among them, is judged frame by frame
against the plain reference (``perfbench/reference``), which is handed the
same code planes the program was handed. Each sampled request gives the
frames on both sides of a chunk boundary (or the clip's first and last)
and frames drawn from the seed inside the chunks. What is judged is what the request produced: the unrounded
per-frame scores behind its artifacts (the analyzer's ``last_scores``),
the libvmaf-schema JSON file it wrote, and the pooled scores of its
results dict.

The numbers compared, each against the limit the configuration states:

* ``feature_gap``: the widest gap of a frame's integer VIF (four scales),
  ADM2, motion or motion2 from the reference, relative to the larger of 1
  and the reference's value;
* ``vmaf_gap``: the widest gap of a frame's VMAF from the reference's, and
  of the pooled VMAF (results dict and JSON) from the mean of the frames';
* ``psnr_gap``: the widest gap of a frame's PSNR of a plane or of the
  frame (dB), and of the pooled PSNR from the mean of the frames';
* ``ssim_gap``: the widest gap of a frame's SSIM of a plane or of the
  frame, and of the pooled SSIM from the mean of the frames';
* ``failed_requests``, ``frames_missing`` and ``json_mismatches`` (limit
  0): requests of the window that returned no result, frames a sampled
  result lacks, and values of a sampled JSON file that are not its scores
  rounded to six decimals.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from perfbench.inputs import sub_seeds
from perfbench.reference.frame import frame_reference_kw

FEATURES = ("adm2", "motion", "motion2", "vif_scale0", "vif_scale1", "vif_scale2",
            "vif_scale3")
GAPS = ("feature_gap", "vmaf_gap", "psnr_gap", "ssim_gap")


@dataclass
class Item:
    record: object
    frame: int


def plan(records, n_frames: int, chunk: int, traffic: Dict, seed: int) -> List[Item]:
    """The sampled (request, frame) pairs. Requests are drawn from the seed
    among those that returned a result: one of each rung the window ran,
    then others up to the traffic's ``requests``. Frames, in order: each
    chunk boundary (its last frame and the next chunk's first, one
    boundary a request), the clip's first and last frames, then frames
    drawn from the seed among the rest, which lie inside chunks."""
    rng = np.random.default_rng(sub_seeds(seed, 4)[3])
    ok = [r for r in records if r.results is not None]
    if not ok:
        return []
    spec = traffic["check"]
    chosen = [int(rng.choice([i for i, r in enumerate(ok) if r.rung == g]))
              for g in sorted({r.rung for r in ok})]
    rest = [i for i in range(len(ok)) if i not in chosen]
    extra = min(max(0, int(spec["requests"]) - len(chosen)), len(rest))
    if extra:
        chosen += [int(i) for i in rng.choice(rest, size=extra, replace=False)]
    pairs = [(c - 1, c) for c in range(chunk, n_frames, chunk)] + [(0, n_frames - 1)]
    per = min(int(spec["frames_per_request"]), n_frames)
    items = []
    for j, idx in enumerate(sorted(chosen)):
        frames = list(pairs[j][:per]) if j < len(pairs) else []
        others = [t for t in range(n_frames) if t not in frames]
        frames += [int(t) for t in rng.choice(others, size=per - len(frames), replace=False)]
        items += [Item(ok[idx], t) for t in sorted(frames)]
    return items


PLANE_KEYS = [f"psnr_{p}" for p in ("y", "u", "v", "avg")] + \
    [f"ssim_{p}" for p in ("y", "u", "v", "all")]


def program_values(item: Item) -> Dict[str, float]:
    """What the request produced for one frame, unrounded: the per-frame
    arrays of the analyzer's ``last_scores`` behind its JSON and logs."""
    sc, t = item.record.scores, item.frame
    out = {n: float(sc.features[n][t]) for n in FEATURES}
    out["vmaf"] = float(sc.vmaf[t])
    for k in PLANE_KEYS:
        src = sc.psnr if k.startswith("psnr") else sc.ssim
        out[k] = float(src[k][t])
    return out


def json_mismatches(record) -> int:
    """Per-frame values of the request's libvmaf-schema JSON file that
    differ from its unrounded scores rounded to the file's six decimals."""
    frames = json.loads(record.json_text)["frames"]
    sc = record.scores
    bad = 0
    for t, f in enumerate(frames):
        m = f["metrics"]
        want = {n: sc.features[n][t] for n in FEATURES}
        want["vmaf"] = sc.vmaf[t]
        want.update({f"psnr_{p}": sc.psnr[f"psnr_{p}"][t] for p in "yuv"})
        want["ssim"] = sc.ssim["ssim_all"][t]
        for k, v in want.items():
            v = float(v) if np.isfinite(v) else float(np.copysign(1e9, v))
            bad += int(_metric(m, k) != round(v, 6))
    return bad


def _metric(metrics: Dict, name: str) -> float:
    for key in ("integer_" + name, "float_" + name, name):
        if key in metrics:
            return float(metrics[key])
    raise KeyError(name)


def pooled_gaps(record) -> Dict[str, float]:
    """Gaps of a result's pooled scores (its results dict and the JSON's
    ``pooled_metrics``) from the mean of its per-frame values: the pooling
    the configuration states."""
    obj = json.loads(record.json_text)
    sc, res = record.scores, record.results
    vm = float(np.mean(np.asarray(sc.vmaf, dtype=np.float64)))
    sm = float(np.mean(np.asarray(sc.ssim["ssim_all"], dtype=np.float64)))
    pa = np.asarray(sc.psnr["psnr_avg"], dtype=np.float64)
    pm = float(np.mean(pa[np.isfinite(pa)])) if np.isfinite(pa).any() else float("inf")
    return {
        "vmaf_gap": float(np.max([abs(float(res["vmaf_score"]) - vm),
                                  abs(float(obj["pooled_metrics"]["vmaf"]["mean"]) - vm)])),
        "ssim_gap": abs(float(res["ssim_score"]) - sm),
        "psnr_gap": abs(float(res["psnr_score"]) - pm),
    }


def _task(item: Item, clips, cfg: Dict) -> Dict:
    t, n = item.frame, clips.n_frames
    lo, hi = max(t - 1, 0), min(t + 2, n)
    dist = clips.dists[item.record.rung]
    return dict(
        ref_y=[clips.ref["y"][i] for i in range(lo, hi)], t_in=t - lo,
        dist={k: dist[k][t] for k in ("y", "u", "v")},
        ref={k: clips.ref[k][t] for k in ("y", "u", "v")},
        bit_depth=int(cfg["bit_depth"]), model_file=cfg["reference_model_file"],
        vif_gain=cfg["vif_enhn_gain_limit"], adm_gain=float(cfg["adm_enhn_gain_limit"]),
        first=t == 0, last=t == n - 1)


def reference_values(items: List[Item], clips, cfg: Dict, workers: int) -> List[Dict]:
    """The reference of every sampled frame, in ``workers`` processes
    (spawned; they import NumPy and the reference alone)."""
    tasks = [_task(it, clips, cfg) for it in items]
    if workers <= 1 or len(tasks) <= 1:
        return [frame_reference_kw(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(tasks)), mp_context=ctx) as ex:
        return list(ex.map(frame_reference_kw, tasks))


def frame_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """A frame's gaps; a feature's relative to the larger of 1 and the
    reference's value (motion runs to tens, the ratios stay below 1)."""
    def widest(keys, rel=False):
        return float(np.max([abs(prog[k] - ref[k]) / (max(1.0, abs(ref[k])) if rel else 1.0)
                             for k in keys]))  # NaN propagates

    return {
        "feature_gap": widest(FEATURES, rel=True),
        "vmaf_gap": widest(["vmaf"]),
        "psnr_gap": widest([k for k in PLANE_KEYS if k.startswith("psnr")]),
        "ssim_gap": widest([k for k in PLANE_KEYS if k.startswith("ssim")]),
    }


def _worse(a: float, b: float) -> float:
    """The larger gap; NaN (an answer that is no number) wins."""
    return b if (b != b or b > a) else a


def judge(records, clips, cfg: Dict, traffic: Dict, seed: int,
          override: Optional[Callable] = None) -> Dict:
    """-> {"correct": bool, "checks": {name: {"value", "limit"}}, ...}.
    ``override(item, values, reference, clips)`` may replace the program's
    values of a frame (the control puts a lower-precision computation in
    their place)."""
    limits = cfg["limits"]
    items = plan(records, clips.n_frames, int(cfg["chunk_size"]), traffic, seed)
    gaps = {g: 0.0 for g in GAPS}
    missing = mismatched = 0
    sampled = {id(it.record): it.record for it in items}
    for rec in sampled.values():
        obj = json.loads(rec.json_text)
        missing += max(0, clips.n_frames - len(obj["frames"]))
        missing += max(0, clips.n_frames - int(rec.results["frame_count"]))
    if not missing:
        mismatched = sum(json_mismatches(rec) for rec in sampled.values())
        workers = int(traffic["check"].get("workers", os.cpu_count() or 1))
        refs = reference_values(items, clips, cfg, workers)
        for it, ref in zip(items, refs):
            prog = program_values(it)
            if override is not None:
                prog = override(it, prog, ref, clips)
            for g, v in frame_gaps(prog, ref).items():
                gaps[g] = _worse(gaps[g], v)
        for rec in sampled.values():
            for g, v in pooled_gaps(rec).items():
                gaps[g] = _worse(gaps[g], v)
    else:
        gaps = {g: float("inf") for g in GAPS}
    failed = sum(1 for r in records if r.results is None)
    checks = {g: {"value": gaps[g], "limit": float(limits[g])} for g in GAPS}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    checks["frames_missing"] = {"value": missing, "limit": 0}
    checks["json_mismatches"] = {"value": mismatched, "limit": 0}
    correct = (bool(items) and all(gaps[g] <= float(limits[g]) for g in GAPS)
               and failed == 0 and missing == 0 and mismatched == 0)
    return {"correct": correct, "checks": checks, "frames_compared": len(items),
            "requests_compared": len(sampled)}
