"""Command line of the PyTorch/CUDA port.

  python -m pqa2_tpu_torch.cli [-v] [--models-dir DIR] COMMAND ...
  python -m pqa2_tpu_torch.cli score REF DIST [--model M] [--out DIR]
                                    [--precision P] [--device cuda|cpu] ...
  python -m pqa2_tpu_torch.cli align REF CAPTURE [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli capture REF [--device NAME] [--out DIR]
                                      (file-playback capture backend)
  python -m pqa2_tpu_torch.cli full REF CAPTURE [--out DIR] [--model M]
                                   [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli batch LADDER.json [--out DIR] [--model M]
                                    [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli serve [--port P] [--warmup] [--device cuda|cpu]
  python -m pqa2_tpu_torch.cli probe VIDEO
  python -m pqa2_tpu_torch.cli models

``score`` prints one JSON line with the pooled scores and the JSON log's
path; ``--device cpu`` runs the plain PyTorch versions instead of the
kernels. ``align`` bookend-aligns a capture to its reference and writes the
aligned .y4m pair next to the capture; ``capture`` simulates a capture
chain (white bookends around looped, noisy reference content) and prints
the capture's path, without touching the card (its ``--device`` names the
capture device); ``full`` aligns, scores the aligned window (decoding each
file once) and writes HTML and CSV reports, and a PDF where matplotlib is
installed. ``batch`` scores a ladder of pairs with a report per clip and
prints the summary; ``serve`` runs the HTTP scoring service
(app/service.py), ``--warmup`` scoring a tiny pair before it listens.
``batch`` and ``serve`` refuse to start without the card unless given
``--device cpu``. ``probe`` prints a video's metadata, ``models`` the
packaged models.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
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


def cmd_capture(args) -> int:
    from pqa2_tpu_torch.app.capture import CaptureManager, FilePlaybackBackend
    from pqa2_tpu_torch.io.video import probe_video

    info = probe_video(args.reference)
    cm = CaptureManager(backend=FilePlaybackBackend(noise_sigma=args.noise))
    cm.set_output_directory(args.out or ".")
    cm.set_test_name(args.test_name or "capture")
    cm.set_reference_video(info)
    done: List = []
    cm.capture_finished.connect(lambda ok, p: done.append((ok, p)))
    cm.status_update.connect(lambda m: print(f"[capture] {m}", file=sys.stderr))
    if not cm.start_bookend_capture(args.device):
        return 1
    cm.wait()
    if not done or not done[0][0]:
        return 1
    print(json.dumps({"capture_path": done[0][1]}))
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


def cmd_batch(args) -> int:
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite

    with open(args.ladder) as f:
        spec = json.load(f)
    summary = run_batch_suite(
        spec, out_dir=args.out or "batch_results", model=args.model,
        log=lambda m: print(f"[batch] {m}", file=sys.stderr), device=args.device)
    print(json.dumps(summary, default=str))
    return 0


def cmd_serve(args) -> int:
    """The HTTP scoring service (app/service.py): one worker thread owns
    the card, jobs arrive over HTTP."""
    from pqa2_tpu_torch.app.service import serve_forever

    serve_forever(host=args.host, port=args.port, out_dir=args.out,
                  warmup=args.warmup, device=args.device)
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
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--models-dir", default=None,
        help="directory of user libvmaf model JSONs (also: PQA2_MODELS_DIR "
             "env var, or the paths.models_dir setting)")
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

    p = sub.add_parser("capture", help="simulated capture (file playback)")
    p.add_argument("reference")
    p.add_argument("--device", default="FilePlayback",
                   help="capture device name (no torch device: capture does no "
                        "GPU work)")
    p.add_argument("--out", default=None,
                   help="output DIRECTORY (the capture file is named "
                        "inside it, CaptureManager path policy)")
    p.add_argument("--test-name", default=None)
    p.add_argument("--noise", type=float, default=2.0)
    p.set_defaults(fn=cmd_capture)

    p = sub.add_parser("full", help="align + score + report")
    p.add_argument("reference")
    p.add_argument("capture")
    p.add_argument("--model", default="vmaf_v0.6.1")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_full)

    p = sub.add_parser("batch", help="multi-clip ladder suite")
    p.add_argument("ladder", help="JSON spec: {pairs: [[ref, dist], ...]}")
    p.add_argument("--model", default="vmaf_v0.6.1")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("serve", help="persistent scoring service (HTTP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8990)
    p.add_argument("--out", default=None, help="artifact directory")
    p.add_argument("--warmup", action="store_true",
                   help="load the kernels and audit the log2 table with a tiny "
                        "synthetic job before listening")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("probe", help="video metadata")
    p.add_argument("video")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("models", help="list packaged models")
    p.set_defaults(fn=cmd_models)

    args = parser.parse_args(argv)
    if args.models_dir:
        from pqa2_tpu_torch.models.registry import set_user_models_dir

        set_user_models_dir(args.models_dir)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
