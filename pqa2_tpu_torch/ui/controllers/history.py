# Copy of pqa2_tpu/ui/controllers/history.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Results-history browsing: list / view / delete / bulk export.

The controller behind the ResultsTab history pane. Reference behavior:
app/ui/tabs/results_tab.py:3081-3244 (scan + row labels), :3255-3310
(view: metadata.json first, bare *_vmaf.json fallback building a minimal
results dict), :3321-3400 (delete with outcome reporting), :3644-3696
(bulk combined CSV).
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

from pqa2_tpu_torch.app.results_store import ResultsStore

logger = logging.getLogger(__name__)


class HistoryController:
    """Qt-free engine for the history list UI."""

    def __init__(self, store: ResultsStore):
        self.store = store
        self.rows: List[Dict] = []

    # -- listing -------------------------------------------------------------

    def refresh(self) -> List[Dict]:
        """Scan the store; each row carries a display label + test_dir."""
        self.rows = []
        for rec in self.store.list_tests():
            rec = dict(rec)
            rec["label"] = self.row_label(rec)
            self.rows.append(rec)
        return self.rows

    @staticmethod
    def row_label(rec: Dict) -> str:
        """'name  VMAF 97.53  (1920x1080, model)' — the list row text."""
        parts = [str(rec.get("test_name", "?"))]
        v = rec.get("vmaf_score")
        if isinstance(v, (int, float)):
            parts.append(f"VMAF {v:.2f}")
        w, h = rec.get("width"), rec.get("height")
        extras = []
        if w and h:
            extras.append(f"{w}x{h}")
        if rec.get("model"):
            extras.append(str(rec["model"]))
        if extras:
            parts.append("(" + ", ".join(extras) + ")")
        return "  ".join(parts)

    # -- view ----------------------------------------------------------------

    def view(self, test_dir: str) -> Tuple[Optional[Dict], str]:
        """Load a historical result for display.

        Returns (results_dict, message). Preference order mirrors the
        reference: metadata.json (fast compact form), else the newest
        *_vmaf.json rebuilt into a minimal results dict, else (None, why).
        """
        meta_path = os.path.join(test_dir, "metadata.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    return json.load(f), "loaded metadata"
            except (json.JSONDecodeError, OSError) as e:
                logger.warning("bad metadata.json in %s: %s", test_dir, e)
        jsons = sorted(glob.glob(os.path.join(test_dir, "*_vmaf.json")))
        if not jsons:
            return None, f"no VMAF results found in {test_dir}"
        try:
            with open(jsons[-1]) as f:
                vmaf_data = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            return None, f"unreadable VMAF json: {e}"
        score = (vmaf_data.get("pooled_metrics", {})
                 .get("vmaf", {}).get("mean"))
        return (
            {
                "vmaf_score": score,
                "json_path": jsons[-1],
                "raw_results": vmaf_data,
            },
            "rebuilt from vmaf json",
        )

    # -- delete --------------------------------------------------------------

    def delete(self, test_dirs: Sequence[str]) -> Tuple[int, List[str]]:
        """Delete result dirs; returns (n_deleted, failure messages).
        Store-level containment check prevents escaping the base dir."""
        deleted = 0
        failures: List[str] = []
        for d in test_dirs:
            if self.store.delete(d):
                deleted += 1
            else:
                failures.append(f"could not delete {d}")
        self.refresh()
        return deleted, failures

    # -- bulk export ---------------------------------------------------------

    def export_combined(self, path: str) -> str:
        return self.store.export_combined_csv(path)
