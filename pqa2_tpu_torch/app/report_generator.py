# Copy of pqa2_tpu/app/report_generator.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu. The PDF needs
# matplotlib, imported only when a PDF is asked for.
"""ReportGenerator — PDF / HTML / CSV result reports.

Rebuild of the reference ReportGenerator (app/report_generator.py:50-471):
score summary with the same interpretation bands (VMAF 90/80/70/60
:395-409, PSNR 40/30/20 :411-423, SSIM .95/.90/.80/.70 :425-439), file
info, per-frame metric charts, a sampled frame table, and a certification
block. PDF rendering uses matplotlib's PdfPages (reportlab-free); the CSV
export mirrors the results tab's per-frame table
(app/ui/tabs/results_tab.py:2906-3065).
"""

from __future__ import annotations

import csv
import html
import logging
import os
import threading
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pqa2_tpu_torch.utils.signals import Signal

logger = logging.getLogger(__name__)


# -- interpretation bands (reference thresholds) ----------------------------


def interpret_vmaf(score: Optional[float]) -> str:
    if score is None:
        return "N/A"
    if score >= 90:
        return "Excellent"
    if score >= 80:
        return "Good"
    if score >= 70:
        return "Fair"
    if score >= 60:
        return "Poor"
    return "Bad"


def interpret_psnr(score: Optional[float]) -> str:
    if score is None:
        return "N/A"
    if score >= 40:
        return "Excellent"
    if score >= 30:
        return "Good"
    if score >= 20:
        return "Fair"
    return "Poor"


def interpret_ssim(score: Optional[float]) -> str:
    if score is None:
        return "N/A"
    if score >= 0.95:
        return "Excellent"
    if score >= 0.90:
        return "Good"
    if score >= 0.80:
        return "Fair"
    if score >= 0.70:
        return "Poor"
    return "Bad"


def _frame_series(results: Dict) -> Dict[str, List[float]]:
    """Per-frame metric series out of the raw (libvmaf-schema) results."""
    series: Dict[str, List[float]] = {"vmaf": [], "psnr": [], "ssim": []}
    raw = results.get("raw_results") or {}
    for fr in raw.get("frames", []):
        m = fr.get("metrics", {})
        if "vmaf" in m:
            series["vmaf"].append(m["vmaf"])
        if "psnr_y" in m:
            series["psnr"].append(m["psnr_y"])
        if "float_ssim" in m:
            series["ssim"].append(m["float_ssim"])
    return {k: v for k, v in series.items() if v}


class ReportGenerator:
    """PDF/HTML report + CSV export from a VMAFAnalyzer results dict."""

    def __init__(self, options_manager=None):
        self.report_progress = Signal(int, name="report_progress")
        self.report_complete = Signal(str, name="report_complete")
        self.error_occurred = Signal(str, name="error_occurred")
        self.options_manager = options_manager

    # -- summary assembly ---------------------------------------------------

    def _summary_rows(self, results: Dict) -> List[Tuple[str, str, str]]:
        vmaf = results.get("vmaf_score")
        psnr = results.get("psnr_score")
        ssim = results.get("ssim_score")
        fmt = lambda v, nd=2: ("inf" if v is not None and not np.isfinite(v)
                               else ("N/A" if v is None else f"{v:.{nd}f}"))
        return [
            ("VMAF", fmt(vmaf), interpret_vmaf(vmaf)),
            ("PSNR (dB)", fmt(psnr), interpret_psnr(
                psnr if psnr is None or np.isfinite(psnr) else 100.0)),
            ("SSIM", fmt(ssim, 4), interpret_ssim(ssim)),
        ]

    def _branding(self) -> Dict:
        if self.options_manager is not None:
            return self.options_manager.get_setting("branding") or {}
        return {}

    # -- PDF ---------------------------------------------------------------

    def generate_report(self, results: Dict, output_path: str,
                        test_metadata: Optional[Dict] = None) -> Optional[str]:
        """Multi-page PDF (app/report_generator.py:50-286)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from matplotlib.backends.backend_pdf import PdfPages

            self.report_progress.emit(10)
            brand = self._branding()
            app_name = brand.get("app_name", "VMAF Test App")
            series = _frame_series(results)
            meta = test_metadata or {}

            with PdfPages(output_path) as pdf:
                # Page 1: summary table + file info + certification block.
                fig, ax = plt.subplots(figsize=(8.27, 11.69))  # A4
                ax.axis("off")
                y = 0.95
                ax.text(0.5, y, f"{app_name} — Quality Report",
                        ha="center", fontsize=18, weight="bold")
                y -= 0.04
                ax.text(0.5, y, datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                        ha="center", fontsize=9, color="gray")
                y -= 0.05
                rows = self._summary_rows(results)
                table = ax.table(
                    cellText=[list(r) for r in rows],
                    colLabels=["Metric", "Score", "Interpretation"],
                    cellLoc="center", bbox=[0.1, y - 0.18, 0.8, 0.16],
                )
                table.auto_set_font_size(False)
                table.set_fontsize(11)
                y -= 0.24
                info_lines = [
                    f"Reference: {results.get('reference_video', 'N/A')}",
                    f"Distorted: {results.get('distorted_video', 'N/A')}",
                    f"Model: {results.get('model', 'N/A')}",
                    f"Resolution: {results.get('width', '?')}x{results.get('height', '?')}",
                    f"Frames: {results.get('frame_count', len(series.get('vmaf', [])) or 'N/A')}",
                ]
                for k, v in meta.items():
                    info_lines.append(f"{k}: {v}")
                for line in info_lines:
                    ax.text(0.1, y, line, fontsize=10)
                    y -= 0.025
                # Sampled frame table (10 rows, report_generator.py:184-230).
                if series.get("vmaf"):
                    n = len(series["vmaf"])
                    idx = np.linspace(0, n - 1, min(10, n)).astype(int)
                    cells = []
                    for i in idx:
                        cells.append([
                            str(i),
                            f"{series['vmaf'][i]:.2f}",
                            f"{series['psnr'][i]:.2f}" if series.get("psnr") else "-",
                            f"{series['ssim'][i]:.4f}" if series.get("ssim") else "-",
                        ])
                    y -= 0.02
                    ax.text(0.1, y, "Sampled frames:", fontsize=11, weight="bold")
                    ax.table(
                        cellText=cells,
                        colLabels=["Frame", "VMAF", "PSNR", "SSIM"],
                        cellLoc="center",
                        bbox=[0.1, y - 0.3, 0.8, 0.28],
                    )
                    y -= 0.36
                # Certification block (report_generator.py:232-262).
                tester = meta.get("tester_name", "")
                ax.text(0.1, max(y, 0.1),
                        f"Certified by: {tester or '________________'}    "
                        f"Signature: ________________",
                        fontsize=10)
                ax.text(0.5, 0.03, brand.get("footer_text", ""),
                        ha="center", fontsize=8, color="gray")
                pdf.savefig(fig)
                plt.close(fig)
                self.report_progress.emit(50)

                # Chart pages: per-metric series + combined 3-pane
                # (report_generator.py:288-393).
                for name, vals in series.items():
                    fig, ax = plt.subplots(figsize=(8.27, 4.5))
                    ax.plot(vals, lw=1.0)
                    ax.set_title(f"{name.upper()} per frame")
                    ax.set_xlabel("frame")
                    ax.set_ylabel(name.upper())
                    ax.grid(alpha=0.3)
                    pdf.savefig(fig)
                    plt.close(fig)
                if len(series) > 1:
                    fig, axes = plt.subplots(
                        len(series), 1, figsize=(8.27, 11.69), sharex=True
                    )
                    for ax, (name, vals) in zip(np.atleast_1d(axes), series.items()):
                        ax.plot(vals, lw=1.0)
                        ax.set_ylabel(name.upper())
                        ax.grid(alpha=0.3)
                    np.atleast_1d(axes)[-1].set_xlabel("frame")
                    pdf.savefig(fig)
                    plt.close(fig)

            self.report_progress.emit(100)
            self.report_complete.emit(output_path)
            return output_path
        except Exception as e:
            logger.exception("report generation failed")
            self.error_occurred.emit(f"Error generating report: {e}")
            return None

    # -- HTML ---------------------------------------------------------------

    def generate_html_report(self, results: Dict, output_path: str,
                             test_metadata: Optional[Dict] = None) -> Optional[str]:
        """Self-contained HTML report (batch-suite output format)."""
        try:
            brand = self._branding()
            rows = self._summary_rows(results)
            series = _frame_series(results)
            esc = html.escape
            parts = [
                "<!doctype html><html><head><meta charset='utf-8'>",
                f"<title>{esc(brand.get('app_name', 'VMAF Test App'))} report</title>",
                "<style>body{font-family:sans-serif;margin:2em}"
                "table{border-collapse:collapse}td,th{border:1px solid #999;"
                "padding:4px 10px}</style></head><body>",
                f"<h1>{esc(brand.get('app_name', 'VMAF Test App'))} — Quality Report</h1>",
                f"<p>{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}</p>",
                "<table><tr><th>Metric</th><th>Score</th><th>Interpretation</th></tr>",
            ]
            for metric, score, interp in rows:
                parts.append(
                    f"<tr><td>{esc(metric)}</td><td>{esc(score)}</td>"
                    f"<td>{esc(interp)}</td></tr>"
                )
            parts.append("</table>")
            parts.append(
                f"<p>Reference: {esc(str(results.get('reference_video')))}<br>"
                f"Distorted: {esc(str(results.get('distorted_video')))}<br>"
                f"Model: {esc(str(results.get('model')))}<br>"
                f"Resolution: {results.get('width')}x{results.get('height')}</p>"
            )
            if series.get("vmaf"):
                vals = series["vmaf"]
                parts.append("<h2>Per-frame VMAF</h2><table><tr><th>Frame</th>"
                             "<th>VMAF</th></tr>")
                for i, v in enumerate(vals):
                    parts.append(f"<tr><td>{i}</td><td>{v:.2f}</td></tr>")
                parts.append("</table>")
            footer = brand.get("footer_text", "")
            parts.append(f"<footer><small>{esc(footer)}</small></footer>")
            parts.append("</body></html>")
            with open(output_path, "w") as f:
                f.write("".join(parts))
            self.report_complete.emit(output_path)
            return output_path
        except Exception as e:
            logger.exception("html report failed")
            self.error_occurred.emit(f"Error generating HTML report: {e}")
            return None

    # -- CSV ----------------------------------------------------------------

    def export_csv(self, results: Dict, output_path: str) -> Optional[str]:
        """Per-frame metric table (results_tab.py:2906-3065)."""
        try:
            raw = results.get("raw_results") or {}
            frames = raw.get("frames", [])
            keys: List[str] = []
            for fr in frames:
                for k in fr.get("metrics", {}):
                    if k not in keys:
                        keys.append(k)
            with open(output_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["test", results.get("model", "")])
                w.writerow(["vmaf_score", results.get("vmaf_score", "")])
                w.writerow(["psnr_score", results.get("psnr_score", "")])
                w.writerow(["ssim_score", results.get("ssim_score", "")])
                w.writerow([])
                w.writerow(["frame"] + keys)
                for fr in frames:
                    m = fr.get("metrics", {})
                    w.writerow([fr.get("frameNum", "")] +
                               [m.get(k, "") for k in keys])
            return output_path
        except Exception as e:
            logger.exception("csv export failed")
            self.error_occurred.emit(f"Error exporting CSV: {e}")
            return None


class ReportGeneratorThread(threading.Thread):
    """Thread wrapper (app/report_generator.py:441-471)."""

    def __init__(self, results: Dict, output_path: str,
                 test_metadata: Optional[Dict] = None, options_manager=None,
                 fmt: str = "pdf"):
        super().__init__(daemon=True)
        self.generator = ReportGenerator(options_manager)
        self.report_progress = self.generator.report_progress
        self.report_complete = self.generator.report_complete
        self.error_occurred = self.generator.error_occurred
        self._args = (results, output_path, test_metadata)
        self._fmt = fmt
        self.output: Optional[str] = None

    def run(self):
        if self._fmt == "html":
            self.output = self.generator.generate_html_report(*self._args)
        else:
            self.output = self.generator.generate_report(*self._args)
