# Copy of pqa2_tpu/app/results_store.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Result persistence + history browser.

Rebuild of the results tab's disk contract (app/ui/tabs/results_tab.py):
immutable per-test directories ``<test>_<timestamp>/`` holding
``*_vmaf.json`` / ``*_psnr.txt`` / ``*_ssim.txt`` plus a compact
``metadata.json`` keeping the first/last 5 frames (:2642-2679), a history
scanner re-hydrating past results from disk (:3081-3244), per-test CSV
export (:2906-3065 — lives in report_generator.export_csv) and a combined
multi-test CSV (:3644-3696).
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from datetime import datetime
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

COMPACT_FRAME_KEEP = 5  # first/last N frames kept in metadata.json


def write_compact_metadata(results: Dict, test_dir: str,
                           extra: Optional[Dict] = None) -> str:
    """Compact metadata.json for fast history reload
    (results_tab.py:2642-2679)."""
    raw = results.get("raw_results") or {}
    frames = raw.get("frames", [])
    if len(frames) > 2 * COMPACT_FRAME_KEEP:
        kept = frames[:COMPACT_FRAME_KEEP] + frames[-COMPACT_FRAME_KEEP:]
        truncated = True
    else:
        kept = frames
        truncated = False
    meta = {
        "saved_at": datetime.now().isoformat(timespec="seconds"),
        "vmaf_score": results.get("vmaf_score"),
        "psnr_score": results.get("psnr_score"),
        "ssim_score": results.get("ssim_score"),
        "model": results.get("model"),
        "width": results.get("width"),
        "height": results.get("height"),
        "frame_count": results.get("frame_count", len(frames)),
        "reference_video": results.get("reference_video"),
        "distorted_video": results.get("distorted_video"),
        "json_path": results.get("json_path"),
        "frames_truncated": truncated,
        "frames": kept,
    }
    if extra:
        meta.update(extra)
    path = os.path.join(test_dir, "metadata.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


class ResultsStore:
    """History over a base results directory of ``<test>_<ts>/`` dirs."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def save(self, results: Dict, test_name: str,
             timestamp: Optional[str] = None,
             extra_metadata: Optional[Dict] = None) -> str:
        ts = timestamp or datetime.now().strftime("%Y%m%d_%H%M%S")
        test_dir = os.path.join(self.base_dir, f"{test_name}_{ts}")
        os.makedirs(test_dir, exist_ok=True)
        write_compact_metadata(results, test_dir, extra_metadata)
        return test_dir

    def list_tests(self) -> List[Dict]:
        """Scan for past results (results_tab.py:3081-3244): any directory
        holding a *_vmaf.json or metadata.json."""
        out: List[Dict] = []
        if not os.path.isdir(self.base_dir):
            return out
        for entry in sorted(os.listdir(self.base_dir)):
            d = os.path.join(self.base_dir, entry)
            if not os.path.isdir(d):
                continue
            rec = self._load_test_dir(d)
            if rec is not None:
                out.append(rec)
        out.sort(key=lambda r: r.get("timestamp", ""), reverse=True)
        return out

    def _load_test_dir(self, d: str) -> Optional[Dict]:
        meta_path = os.path.join(d, "metadata.json")
        rec: Dict = {"test_dir": d, "test_name": os.path.basename(d)}
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                rec.update(meta)
            except (json.JSONDecodeError, OSError) as e:
                logger.warning("bad metadata.json in %s: %s", d, e)
        vmaf_jsons = sorted(glob.glob(os.path.join(d, "*_vmaf.json")))
        if vmaf_jsons:
            rec.setdefault("json_path", vmaf_jsons[-1])
            if "vmaf_score" not in rec:
                try:
                    with open(vmaf_jsons[-1]) as f:
                        data = json.load(f)
                    rec["vmaf_score"] = (
                        data.get("pooled_metrics", {}).get("vmaf", {}).get("mean")
                    )
                except (json.JSONDecodeError, OSError):
                    pass
        if "vmaf_score" not in rec and not vmaf_jsons:
            return None
        ts = rec["test_name"].rsplit("_", 2)
        if len(ts) >= 3:
            rec.setdefault("timestamp", f"{ts[-2]}_{ts[-1]}")
        return rec

    def load_full(self, test_dir: str) -> Optional[Dict]:
        """Re-hydrate the full per-frame results from the *_vmaf.json."""
        vmaf_jsons = sorted(glob.glob(os.path.join(test_dir, "*_vmaf.json")))
        if not vmaf_jsons:
            return None
        with open(vmaf_jsons[-1]) as f:
            return json.load(f)

    def delete(self, test_dir: str) -> bool:
        """Delete one result dir (results_tab.py bulk ops)."""
        import shutil

        if not os.path.isdir(test_dir) or not os.path.dirname(
            os.path.abspath(test_dir)
        ) == os.path.abspath(self.base_dir):
            return False
        shutil.rmtree(test_dir, ignore_errors=True)
        return True

    def export_combined_csv(self, path: str) -> str:
        """One row per historical test (results_tab.py:3644-3696)."""
        rows = self.list_tests()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["test_name", "timestamp", "model", "vmaf_score",
                        "psnr_score", "ssim_score", "frame_count",
                        "reference_video", "distorted_video"])
            for r in rows:
                w.writerow([
                    r.get("test_name", ""), r.get("timestamp", ""),
                    r.get("model", ""), r.get("vmaf_score", ""),
                    r.get("psnr_score", ""), r.get("ssim_score", ""),
                    r.get("frame_count", ""), r.get("reference_video", ""),
                    r.get("distorted_video", ""),
                ])
        return path
