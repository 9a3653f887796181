"""Command line of the PyTorch/CUDA port.

  python -m pqa2_tpu_torch.cli score REF DIST [--model M] [--out DIR]
                                    [--device cuda|cpu] ...

Prints one JSON line with the pooled scores and the JSON log's path.
``--device cpu`` runs the plain PyTorch versions instead of the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def cmd_score(args) -> int:
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    analyzer = VMAFAnalyzer(device=args.device)
    analyzer.model = args.model
    analyzer.pool_method = args.pool
    analyzer.feature_subsample = args.subsample
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


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="pqa2_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("score", help="score a ref/dist pair")
    p.add_argument("reference")
    p.add_argument("distorted")
    p.add_argument("--model", default="vmaf_v0.6.1")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain versions")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--test-name", default=None)
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--pool", default="mean",
                   choices=["mean", "min", "max", "harmonic_mean"])
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument("--no-psnr", action="store_true")
    p.add_argument("--no-ssim", action="store_true")
    p.set_defaults(fn=cmd_score)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
