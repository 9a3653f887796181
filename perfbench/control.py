"""Readings for the limits of the check: sound runs of the program and its
control, several seeds in one process. The benchmark's own runs never run
this.

    python3 -m perfbench.control --workload <cell> --seconds <s> --seeds 1,2,3 [--control]

Each seed runs the cell as ``perfbench.run`` does (set-up, a window of
``--seconds``, the check) and prints one JSON line with the numbers the
check compared. With ``--control`` the program runs its lower-precision
path (``precision="integer_fast"``: VIF's smooth-log statistic in place of
libvmaf's integer one); the per-frame VMAF the check reads is the
reference's SVR computed in bfloat16 on the reference's features, and the
per-frame PSNR and SSIM are the reference's computed in bfloat16 on the
same planes: the controls of the float32 SVR and plane metrics.
"""

from __future__ import annotations

import json
import sys
from typing import Dict

import numpy as np


def ssim_plane_bf16(torch, r: np.ndarray, d: np.ndarray, bit_depth: int) -> float:
    """ffmpeg's SSIM of one plane (4x4 block sums, 8x8 windows on a 4-pixel
    grid, the constants of the native peak), every operation in bfloat16."""
    bf = torch.bfloat16
    a = torch.from_numpy(r.astype(np.float32)).to(bf)
    b = torch.from_numpy(d.astype(np.float32)).to(bf)
    h4, w4 = a.shape[0] // 4, a.shape[1] // 4

    def blocks(x):
        return x[: h4 * 4, : w4 * 4].reshape(h4, 4, w4, 4).sum(dim=(1, 3), dtype=bf)

    def group(x):
        return x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]

    s1, s2 = group(blocks(a)), group(blocks(b))
    ss, s12 = group(blocks(a * a) + blocks(b * b)), group(blocks(a * b))
    mx = (1 << bit_depth) - 1
    c1 = float(int(0.01 * 0.01 * mx * mx * 64 + 0.5))
    c2 = float(int(0.03 * 0.03 * mx * mx * 64 * 63 + 0.5))
    vars_ = ss * 64.0 - s1 * s1 - s2 * s2
    covar = s12 * 64.0 - s1 * s2
    num = (2.0 * s1 * s2 + c1) * (2.0 * covar + c2)
    den = (s1 * s1 + s2 * s2 + c1) * (vars_ + c2)
    return float((num / den).mean(dtype=bf))


def planes_bf16(torch, ref: Dict[str, np.ndarray], dist: Dict[str, np.ndarray],
                bit_depth: int) -> Dict[str, float]:
    """PSNR and SSIM of each plane of one frame, in bfloat16."""
    out, tot, tot_w = {}, 0.0, 0
    peak = float((1 << bit_depth) - 1)
    for p in "yuv":
        r = torch.from_numpy(ref[p].astype(np.float32)).to(torch.bfloat16)
        d = torch.from_numpy(dist[p].astype(np.float32)).to(torch.bfloat16)
        mse = float(((r - d) * (r - d)).mean(dtype=torch.bfloat16))
        out[f"psnr_{p}"] = float(10.0 * np.log10(peak * peak / mse)) if mse > 0 else float("inf")
        v = ssim_plane_bf16(torch, ref[p], dist[p], bit_depth)
        out[f"ssim_{p}"] = v
        tot += v * ref[p].size
        tot_w += ref[p].size
    out["ssim_all"] = tot / tot_w
    sse = {p: float(((torch.from_numpy(ref[p].astype(np.float32)) -
                      torch.from_numpy(dist[p].astype(np.float32))).to(torch.bfloat16) ** 2)
                    .sum(dtype=torch.bfloat16)) for p in "yuv"}
    mse_avg = sum(sse.values()) / sum(ref[p].size for p in "yuv")
    out["psnr_avg"] = (float(10.0 * np.log10(peak * peak / mse_avg)) if mse_avg > 0
                       else float("inf"))
    return out


def svr_bf16(torch, features: Dict[str, float], model_file: str) -> float:
    """The reference's SVR (perfbench/reference/frame.py:svr_vmaf) with
    every operation in bfloat16."""
    import os

    from perfbench.reference.frame import MODELS_DIR

    bf = torch.bfloat16
    m = np.load(os.path.join(MODELS_DIR, model_file))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(bf)

    names = [str(n) for n in m["feature_names"]]
    slopes, icpt = t(m["slopes"]), t(m["intercepts"])
    x = t([features[n] for n in names]) * slopes[1:] + icpt[1:]
    d2 = ((x[None, :] - t(m["sv"])) ** 2).sum(dim=1, dtype=bf)
    raw = (t(m["sv_coef"]) * torch.exp(-t(m["gamma"]) * d2)).sum(dtype=bf) - t(m["rho"])
    score = (raw - icpt[0]) / slopes[0]
    if "score_transform" in m.files:
        p0, p1, p2, out_gte_in = (t(v) for v in m["score_transform"])
        y = p0 + p1 * score + p2 * score * score
        score = torch.maximum(y, score) if float(out_gte_in) else y
    if "score_clip" in m.files:
        score = score.clamp(float(m["score_clip"][0]), float(m["score_clip"][1]))
    return float(score)


def bf16_override(torch, cfg: Dict):
    """The check's override that puts, for each sampled frame, the
    reference's SVR and plane metrics computed in bfloat16 in the place of
    the program's VMAF, PSNR and SSIM."""
    depth = int(cfg["bit_depth"])

    def override(item, values, reference, clips):
        t = item.frame
        ref = {k: clips.ref[k][t] for k in "yuv"}
        dist = {k: clips.dists[item.record.rung][k][t] for k in "yuv"}
        out = dict(values, **planes_bf16(torch, ref, dist, depth))
        out["vmaf"] = svr_bf16(torch, reference, cfg["reference_model_file"])
        return out

    return override


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench import harness

    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, cell, cfg, traffic, seed=seed, seconds=args.seconds,
                          trace=False, precision="integer_fast" if args.control else None,
                          override=bf16_override(torch, cfg) if args.control else None)
        out = run.execute()
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "metrics": out["metrics"], "check_s": run.stamp["check_s"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
