"""Batch throughput suite: multi-clip codec/bitrate ladder scoring (port of
pqa2_tpu/pipeline/batch.py).

Without a mesh, each ladder entry is scored through one ``VMAFAnalyzer``
on ``device``; its ``analyze_videos`` decodes each rung. Per-clip
directories hold the JSON log, the PSNR/SSIM logs, ``<name>_report.html``
and ``<name>_frames.csv``; ``batch_summary.json`` has the JAX package's
schema. With ``mesh=`` (a :func:`parallel.mesh.make_mesh` result) the
entries' frames are laid over the mesh's devices instead
(:func:`_run_batch_suite_sharded`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from pqa2_tpu_torch.pipeline.scoring import resolve_device


def _entries(spec: Dict) -> List[Dict]:
    entries: List[Dict] = []
    for pair in spec.get("pairs", []):
        entries.append({"reference": pair[0], "distorted": pair[1]})
    entries.extend(spec.get("entries", []))
    if not entries:
        raise ValueError("batch spec has no pairs/entries")
    return entries


def run_batch_suite(
    spec: Dict,
    out_dir: str,
    model: str = "vmaf_v0.6.1",
    log: Optional[Callable[[str], None]] = None,
    device: Union[str, torch.device] = "cuda",
    mesh=None,
) -> Dict:
    """spec: {"pairs": [[ref, dist], ...]} or
    {"entries": [{"reference": .., "distorted": .., "name": .., "model": ..}]}.

    Returns a summary dict (also written to <out_dir>/batch_summary.json).
    ``device="cuda"`` needs the card and raises without one before anything
    is written; ``"cpu"`` runs the plain versions.

    ``mesh``: a data-only mesh (parallel/mesh.py); the entries are then
    scored through the sharded scorer on the mesh's devices (``device`` is
    not used), one scorer per (model, depth). The VMAF/feature JSON logs
    keep their schema; the separate-pass PSNR/SSIM columns are ``None`` on
    the sharded sweep, as in the JAX package.
    """
    if mesh is not None:
        return _run_batch_suite_sharded(spec, out_dir, mesh=mesh, model=model, log=log)
    from pqa2_tpu_torch.app.report_generator import ReportGenerator
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    device = resolve_device(device)
    log = log or (lambda m: None)
    entries = _entries(spec)

    os.makedirs(out_dir, exist_ok=True)
    analyzer = VMAFAnalyzer(device=device)
    gen = ReportGenerator()
    rows: List[Dict] = []
    t_start = time.perf_counter()
    total_frames = 0

    for i, entry in enumerate(entries):
        name = entry.get("name") or os.path.splitext(
            os.path.basename(entry["distorted"])
        )[0]
        log(f"[{i + 1}/{len(entries)}] scoring {name}")
        clip_dir = os.path.join(out_dir, name)
        os.makedirs(clip_dir, exist_ok=True)
        analyzer.set_output_directory(clip_dir)
        analyzer.set_test_name(name)
        t0 = time.perf_counter()
        results = analyzer.analyze_videos(
            entry["reference"], entry["distorted"],
            model=entry.get("model", model),
        )
        dt = time.perf_counter() - t0
        if results is None:
            rows.append({"name": name, "error": "analysis failed"})
            continue
        html = gen.generate_html_report(
            results, os.path.join(clip_dir, f"{name}_report.html")
        )
        gen.export_csv(results, os.path.join(clip_dir, f"{name}_frames.csv"))
        total_frames += results["frame_count"]
        rows.append({
            "name": name,
            "vmaf": results["vmaf_score"],
            "psnr": results["psnr_score"],
            "ssim": results["ssim_score"],
            "frames": results["frame_count"],
            "seconds": round(dt, 3),
            "fps": round(results["frame_count"] / dt, 2) if dt > 0 else None,
            "json_path": results["json_path"],
            "html_report": html,
        })

    wall = time.perf_counter() - t_start
    summary = {
        "model": model,
        "clips": rows,
        "n_clips": len(entries),
        "total_frames": total_frames,
        "wall_seconds": round(wall, 3),
        "aggregate_fps": round(total_frames / wall, 2) if wall > 0 else None,
    }
    with open(os.path.join(out_dir, "batch_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def _run_batch_suite_sharded(
    spec: Dict,
    out_dir: str,
    mesh,
    model: str = "vmaf_v0.6.1",
    log: Optional[Callable[[str], None]] = None,
) -> Dict:
    """Ladder sweep over a device mesh: decode on the host, lay each
    entry's frames over the mesh's data axis, and reuse one scorer per
    (model, depth) across entries. A decoded clip stays in an LRU cache of
    five, so a ladder's shared reference is decoded once; each decode and
    each cache hit is logged. An entry that fails gets an error row and the
    sweep goes on."""
    import numpy as np

    from pqa2_tpu_torch.io.video import VideoReader
    from pqa2_tpu_torch.models.registry import get_model
    from pqa2_tpu_torch.parallel.scoring import make_shardmap_scorer, score_clip_sharded
    from pqa2_tpu_torch.pipeline.json_out import write_vmaf_json
    from pqa2_tpu_torch.pipeline.scoring import ClipScores

    log = log or (lambda m: None)
    entries = _entries(spec)

    os.makedirs(out_dir, exist_ok=True)
    scorers: Dict[object, object] = {}  # one per (model, depth)
    luma_cache: Dict[str, tuple] = {}  # ladders reuse one reference

    def luma_of(path: str):
        """-> (luma (N,H,W) in source dtype, source bit depth)."""
        if path in luma_cache:
            # LRU touch: a ladder's shared reference is hit on every rung;
            # FIFO would evict it first (it is the oldest insertion) and
            # decode it again per rung.
            luma_cache[path] = luma_cache.pop(path)
            log(f"  luma cache hit: {path}")
        else:
            if len(luma_cache) > 4:  # bound host memory on big sweeps
                luma_cache.pop(next(iter(luma_cache)))
            log(f"  decode: {path}")
            with VideoReader(path) as r:
                depth = int(r.info.bit_depth)
                y = np.stack([f["y"] for f in r])
            if depth > 8:
                # Converted once at fill time: a ladder uses its reference
                # on every rung.
                y = y.astype(np.float32) / (1 << (depth - 8))
            luma_cache[path] = (y, depth)
        return luma_cache[path]

    nd = mesh.shape["data"]
    rows: List[Dict] = []
    t_start = time.perf_counter()
    total_frames = 0
    for i, entry in enumerate(entries):
        name = entry.get("name") or os.path.splitext(
            os.path.basename(entry["distorted"])
        )[0]
        mname = entry.get("model", model)
        log(f"[{i + 1}/{len(entries)}] scoring {name} (mesh data={nd})")
        clip_dir = os.path.join(out_dir, name)
        os.makedirs(clip_dir, exist_ok=True)
        t0 = time.perf_counter()
        try:
            ref_y, ref_depth = luma_of(entry["reference"])
            dist_y, dist_depth = luma_of(entry["distorted"])
            # A pair deeper than 8 bits scores as f32 on the 8-bit scale
            # with bit_depth the deeper grid (mixed pairs promote, as
            # stream_score does); only a mixed pair's shallow member still
            # needs promoting here.
            depth = max(ref_depth, dist_depth)
            if depth > 8:
                ref_y = ref_y.astype(np.float32, copy=False)
                dist_y = dist_y.astype(np.float32, copy=False)
            key = (mname, depth)
            if key not in scorers:
                scorers[key] = make_shardmap_scorer(mesh, mname, bit_depth=depth)
            res = score_clip_sharded(ref_y, dist_y, mesh, model=mname,
                                     scorer=scorers[key], bit_depth=depth)
        except Exception as e:  # keep sweeping; record the failure
            log(f"  failed: {e}")
            rows.append({"name": name, "error": str(e)})
            continue
        dt = time.perf_counter() - t0
        n = res.pop("n_frames")
        vmaf = res.pop("vmaf")
        res.pop("vmaf_bootstrap", None)
        emdl = get_model(mname)  # the JSON schema follows the entry's model
        scores = ClipScores(
            model_name=mname, feature_names=tuple(emdl.feature_names),
            features=res, vmaf=vmaf,
            peak=float((1 << depth) - 1),
            uses_integer_features=getattr(emdl, "uses_integer_features", True),
        )
        json_path = os.path.join(clip_dir, f"{name}_vmaf.json")
        write_vmaf_json(scores, json_path)
        total_frames += n
        rows.append({
            "name": name,
            "vmaf": float(np.mean(vmaf)),
            "psnr": None,  # separate-pass metrics skipped on the mesh sweep
            "ssim": None,
            "frames": n,
            "seconds": round(dt, 3),
            "fps": round(n / dt, 2) if dt > 0 else None,
            "json_path": json_path,
        })

    wall = time.perf_counter() - t_start
    summary = {
        "model": model,
        "mesh_devices": int(nd),
        "clips": rows,
        "n_clips": len(entries),
        "total_frames": total_frames,
        "wall_seconds": round(wall, 3),
        "aggregate_fps": round(total_frames / wall, 2) if wall > 0 else None,
        "aggregate_fps_per_device": (
            round(total_frames / wall / max(nd, 1), 2) if wall > 0 else None),
    }
    with open(os.path.join(out_dir, "batch_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary
