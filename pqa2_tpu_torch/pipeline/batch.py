"""Batch throughput suite: multi-clip codec/bitrate ladder scoring (port of
pqa2_tpu/pipeline/batch.py:18-104).

Each ladder entry is scored through one ``VMAFAnalyzer`` on ``device``; its
``analyze_videos`` decodes each rung. Per-clip directories hold the JSON
log, the PSNR/SSIM logs, ``<name>_report.html`` and ``<name>_frames.csv``;
``batch_summary.json`` has the JAX package's schema. The JAX function's
``mesh=`` sweep (frames sharded across devices) waits for multi-GPU scoring
(ROADMAP Q1.14), so this function takes no ``mesh``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from pqa2_tpu_torch.pipeline.scoring import resolve_device


def run_batch_suite(
    spec: Dict,
    out_dir: str,
    model: str = "vmaf_v0.6.1",
    log: Optional[Callable[[str], None]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """spec: {"pairs": [[ref, dist], ...]} or
    {"entries": [{"reference": .., "distorted": .., "name": .., "model": ..}]}.

    Returns a summary dict (also written to <out_dir>/batch_summary.json).
    ``device="cuda"`` needs the card and raises without one before anything
    is written; ``"cpu"`` runs the plain versions.
    """
    from pqa2_tpu_torch.app.report_generator import ReportGenerator
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    device = resolve_device(device)
    log = log or (lambda m: None)
    entries: List[Dict] = []
    for pair in spec.get("pairs", []):
        entries.append({"reference": pair[0], "distorted": pair[1]})
    entries.extend(spec.get("entries", []))
    if not entries:
        raise ValueError("batch spec has no pairs/entries")

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
