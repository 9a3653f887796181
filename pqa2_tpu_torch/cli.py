"""Command line of the PyTorch/CUDA port.

  python -m pqa2_tpu_torch.cli score REF DIST [--model M] [--out DIR]
                                    [--precision P] [--device cuda|cpu] ...
  python -m pqa2_tpu_torch.cli align REF CAPTURE [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli full REF CAPTURE [--out DIR] [--model M]
                                   [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli probe VIDEO
  python -m pqa2_tpu_torch.cli models

``score`` prints one JSON line with the pooled scores and the JSON log's
path; ``--device cpu`` runs the plain PyTorch versions instead of the
kernels. ``align`` bookend-aligns a capture to its reference and writes the
aligned .y4m pair next to the capture; ``full`` aligns, scores the aligned
window (decoding each file once) and writes HTML and CSV reports, and a PDF
where matplotlib is installed. ``probe`` prints a video's metadata,
``models`` the packaged models.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import List, Optional


def cmd_score(args) -> int:
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    analyzer = VMAFAnalyzer(device=args.device)
    analyzer.model = args.model
    analyzer.pool_method = args.pool
    analyzer.feature_subsample = args.subsample
    analyzer.feature_precision = None if args.precision == "auto" else args.precision
    analyzer.psnr_enabled = not args.no_psnr
    analyzer.ssim_enabled = not args.no_ssim
    if args.out:
        analyzer.set_output_directory(args.out)
    if args.test_name:
        analyzer.set_test_name(args.test_name)
    analyzer.status_update.connect(lambda m: print(f"[score] {m}", file=sys.stderr))
    analyzer.analysis_failed.connect(lambda m: print(f"[score] {m}", file=sys.stderr))
    results = analyzer.analyze_videos(
        args.reference, args.distorted, model=args.model, duration=args.duration)
    if results is None:
        return 1
    print(json.dumps({
        "vmaf": results["vmaf_score"],
        "psnr": results["psnr_score"],
        "ssim": results["ssim_score"],
        "frames": results["frame_count"],
        "json_path": results["json_path"],
    }, default=str))
    return 0


def cmd_align(args) -> int:
    from pqa2_tpu_torch.app.bookend_aligner import BookendAligner

    aligner = BookendAligner(device=args.device)
    aligner.status_update.connect(lambda m: print(f"[align] {m}", file=sys.stderr))
    aligner.error_occurred.connect(lambda m: print(f"[align] {m}", file=sys.stderr))
    res = aligner.align_bookend_videos(args.reference, args.capture)
    if res is None:
        return 1
    print(json.dumps({k: res[k] for k in (
        "aligned_reference", "aligned_captured", "offset_frames",
        "offset_seconds", "confidence", "is_fallback")}))
    return 0


def cmd_full(args) -> int:
    """Align, score the aligned window and write the reports; each file is
    decoded once (app/workflow.py)."""
    from pqa2_tpu_torch.app.report_generator import ReportGenerator
    from pqa2_tpu_torch.app.workflow import run_combined_workflow

    out_dir = args.out or os.path.dirname(args.capture) or "."
    combined = run_combined_workflow(
        args.reference, args.capture, out_dir=out_dir, model=args.model,
        device=args.device)
    if combined is None:
        return 1
    res = combined["alignment"]
    results = combined["analysis"]
    gen = ReportGenerator()
    pdf = (gen.generate_report(results, os.path.join(out_dir, "report.pdf"))
           if importlib.util.find_spec("matplotlib") else None)
    html = gen.generate_html_report(results, os.path.join(out_dir, "report.html"))
    csvp = gen.export_csv(results, os.path.join(out_dir, "frames.csv"))
    print(json.dumps({
        "vmaf": results["vmaf_score"],
        "psnr": results["psnr_score"],
        "ssim": results["ssim_score"],
        "alignment_confidence": res["confidence"],
        "report_pdf": pdf, "report_html": html, "csv": csvp,
    }, default=str))
    return 0


def cmd_probe(args) -> int:
    from pqa2_tpu_torch.io.video import probe_video

    print(json.dumps(probe_video(args.video), default=str))
    return 0


def cmd_models(args) -> int:
    from pqa2_tpu_torch.models.registry import available_models, get_model

    out = {}
    for name in available_models():
        m = get_model(name)
        if hasattr(m, "models"):
            out[name] = {"type": "bootstrap", "n_models": m.n_models,
                         "features": list(m.feature_names)}
        else:
            out[name] = {"type": "nusvr", "n_sv": m.n_sv,
                         "features": list(m.feature_names)}
    print(json.dumps(out, indent=2))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="pqa2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = "torch device: cuda runs the kernels, cpu the plain versions"
    p = sub.add_parser("score", help="score a ref/dist pair")
    p.add_argument("reference")
    p.add_argument("distorted")
    p.add_argument("--model", default="vmaf_v0.6.1")
    p.add_argument("--device", default="cuda", help=device_help)
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--test-name", default=None)
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--pool", default="mean",
                   choices=["mean", "min", "max", "harmonic_mean"])
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument("--precision", default="auto",
                   choices=["auto", "integer", "integer_fast", "float"],
                   help="feature family: auto follows the model (integer "
                        "models -> integer, the bit-faithful fixed-point "
                        "path incl. the exact LUT statistic); integer_fast "
                        "smooths the statistic's logs to f32 (score delta "
                        "<=1e-3); float forces the f32 kernels")
    p.add_argument("--no-psnr", action="store_true")
    p.add_argument("--no-ssim", action="store_true")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("align", help="bookend-align a capture to a reference")
    p.add_argument("reference")
    p.add_argument("capture")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("full", help="align + score + report")
    p.add_argument("reference")
    p.add_argument("capture")
    p.add_argument("--model", default="vmaf_v0.6.1")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_full)

    p = sub.add_parser("probe", help="video metadata")
    p.add_argument("video")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("models", help="list packaged models")
    p.set_defaults(fn=cmd_models)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
