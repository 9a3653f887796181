#!/usr/bin/env python3
"""Smoke run of pqa2_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                  # needs one sm_90 card
    python3 chip_smoke.py --profile DIR    # plus a torch.profiler pass

Phases (each prints its lines; any failure raises and the exit code is 1):

  1. the card (nvidia-smi name and power limit), torch's CUDA version, and
     the nvcc build of ``pqa2_tpu_torch/csrc`` (its time when it built);
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes: a 34-frame 1080p luma chunk (32 core frames and
     both halos) and 960x540 chroma, plus one 3840x2160 and one 4096x4096
     pair for VIF and ADM. Integer outputs must be equal; SSIM within
     1e-6; the log2 audit 0 mismatches;
  3. the slice: a synthetic 1920x1080 4:2:0 y4m pair of 72 frames through
     ``VMAFAnalyzer(device="cuda").analyze_videos`` with vmaf_v0.6.1 and
     PSNR+SSIM (chunks 32+32+8), its artifacts, every kernel's launch
     count over that run, and frames 0 and 32 against the numpy oracles
     of pqa2_tpu.golden;
  4. CUDA-event times of each kernel against its plain version at 1080p,
     and the slice's frames per second.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

WORK_DIR = os.path.join(HERE, "build", "chip_smoke")

# Kernel wrapper -> (source, the TPU kernel's pl.pallas_call it replaces).
KERNELS = {
    "vif_int_scale": ("pqa2_tpu_torch/csrc/vif_int.cu",
                      "pqa2_tpu/ops/pallas_vif_int.py:1021"),
    "log2_table_audit": ("pqa2_tpu_torch/csrc/vif_int.cu",
                         "pqa2_tpu/ops/pallas_vif_int.py:152"),
    "adm_int_level": ("pqa2_tpu_torch/csrc/adm_int.cu",
                      "pqa2_tpu/ops/pallas_adm_int.py:381"),
    "ssim_sse_plane": ("pqa2_tpu_torch/csrc/ssim.cu",
                       "pqa2_tpu/ops/pallas_ssim.py:225"),
}

# Tolerances against the numpy oracles (pqa2_tpu.golden): the features are
# f32 while the oracles combine in float64.
VIF_ATOL = 2e-6      # the budget of tests/test_integer.py:80
ADM_ATOL = 2e-6      # f32 cbrt/rounding chain
MOTION_RTOL = 1e-6   # f32 rounding of an exact integer SAD
SSIM_ATOL = 1e-6     # kernel vs plain: float64 sums in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def smooth_frames(torch, n, h, w, seed, device, moving=True):
    """Smooth, moving 8-bit luma-like frames (uint8 (n, h, w)) on device."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    ph = torch.rand((4,), generator=g, device=device) * 6.28
    frames = []
    for t in range(n):
        s = 3.0 * t if moving else 0.0
        v = (128.0
             + 50.0 * torch.sin((xx + s) / 37.0 + ph[0]) * torch.cos((yy - 0.5 * s) / 53.0 + ph[1])
             + 30.0 * torch.sin((xx - yy + 2.0 * s) / 17.0 + ph[2])
             + 12.0 * torch.cos((xx * 0.7 + yy * 1.3 + s) / 5.0 + ph[3]))
        frames.append(v)
    return torch.stack(frames).clamp(0, 255).round().to(torch.uint8)


def distort(torch, ref, seed, radius=1, noise=8):
    """(2r+1)^2 box blur plus uniform noise in [-noise, noise]."""
    g = torch.Generator(device=ref.device).manual_seed(seed)
    r = radius
    x = torch.nn.functional.pad(ref.float()[:, None], (r, r, r, r), mode="replicate")[:, 0]
    h, w = ref.shape[-2:]
    k = 2 * r + 1
    b = sum(x[:, i: i + h, j: j + w] for i in range(k) for j in range(k)) / float(k * k)
    n = torch.randint(-noise, noise + 1, ref.shape, generator=g, device=ref.device)
    return (b.round() + n).clamp(0, 255).to(torch.uint8)


def check_equal(torch, name, a, b) -> float:
    """Max |a - b| of two integer outputs; raises unless they are equal."""
    if a is None and b is None:
        return 0.0
    if a.shape != b.shape:
        raise AssertionError(f"{name}: kernel shape {tuple(a.shape)} != plain {tuple(b.shape)}")
    diff = float((a.long() - b.long()).abs().max().item()) if a.numel() else 0.0
    if diff != 0.0:
        raise AssertionError(f"{name}: kernel != plain (max |diff| {diff})")
    return diff


def phase_kernels(torch, device, results):
    """Phase 2: each kernel's wrapper on CUDA tensors against its plain
    version on the same tensors."""
    from pqa2_tpu.golden.fixedpoint import ADM_BAND_Q
    from pqa2_tpu_torch.ops import cuda_adm_int, cuda_ssim, cuda_vif_int
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain, level_input
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain
    from pqa2_tpu_torch.ops.vif_int import to_native_grid, vif_int_scale_plain

    mism = cuda_vif_int.log2_table_audit(device)
    log(f"[kernels] log2 audit: {mism} mismatches of 32768 mantissas (x2 shifts)")
    results["log2_table_audit"]["max_abs_err"] = float(mism)

    err = {"vif_int_scale": 0.0, "adm_int_level": 0.0}

    def vif_all_scales(ref, dist, core_ref, label):
        r, in_q = to_native_grid(ref, 8)
        d, _ = to_native_grid(dist, 8)
        mref = to_native_grid(core_ref, 8)[0] if core_ref is not None else None
        for scale in range(4):
            kw = dict(scale=scale, in_q=in_q, gain_limit=float("inf"),
                      decimate=scale < 3, motion_ref=mref if scale == 0 else None)
            got = cuda_vif_int.vif_int_scale(r, d, **kw)
            want = vif_int_scale_plain(r, d, **kw)
            for nm, a, b in zip(("stats", "next_ref", "next_dist", "sad"), got, want):
                err["vif_int_scale"] = max(err["vif_int_scale"], check_equal(
                    torch, f"vif {label} scale {scale} {nm}", a, b))
            torch.cuda.synchronize()
            del want
            r, d, in_q = got[1], got[2], 8
        log(f"[kernels] vif_int_scale {label}: LUT accumulators, decimated planes"
            f"{' and SAD' if core_ref is not None else ''} equal at all 4 scales")

    def adm_all_levels(ref, dist, label):
        r, drop = level_input(ref, 8)
        d, _ = level_input(dist, 8)
        for lvl in range(4):
            if lvl:
                drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
            kw = dict(level=lvl, extra_row_shift=drop, gain_limit=100.0)
            got = cuda_adm_int.adm_int_level(r, d, **kw)
            want = adm_level_plain(r, d, **kw)
            for nm, a, b in zip(("cube sums", "ref approx", "dist approx"), got, want):
                err["adm_int_level"] = max(err["adm_int_level"], check_equal(
                    torch, f"adm {label} level {lvl} {nm}", a, b))
            torch.cuda.synchronize()
            del want
            r, d = got[1], got[2]
        log(f"[kernels] adm_int_level {label}: pooled cube sums and approximation "
            f"planes equal at all 4 levels")

    # 1080p chunk: 32 core frames with a halo frame on each side.
    ref = smooth_frames(torch, 34, 1080, 1920, 1, device)
    dist = distort(torch, ref, 2)
    vif_all_scales(ref[1:33], dist[1:33], ref, "1080p 32+2 frames")
    adm_all_levels(ref[1:33], dist[1:33], "1080p 32 frames")
    for label, (h, w) in (("3840x2160", (2160, 3840)), ("4096x4096", (4096, 4096))):
        r1 = smooth_frames(torch, 1, h, w, 3, device)
        d1 = distort(torch, r1, 4)
        vif_all_scales(r1, d1, None, label)
        adm_all_levels(r1, d1, label)
        del r1, d1
    for k, v in err.items():
        results[k]["max_abs_err"] = v

    worst = 0.0
    chroma = torch.nn.functional.avg_pool2d(ref[1:33].float()[:, None], 2)[:, 0].round()
    chroma_d = torch.nn.functional.avg_pool2d(dist[1:33].float()[:, None], 2)[:, 0].round()
    for label, (r, d) in (("1080p luma", (ref[1:33].float(), dist[1:33].float())),
                          ("960x540 chroma", (chroma.contiguous(), chroma_d.contiguous()))):
        s_k, e_k = cuda_ssim.ssim_sse_plane(r, d, bit_depth=8)
        s_p, e_p = ssim_sse_plane_plain(r, d, bit_depth=8)
        err = (s_k.double() - s_p.double()).abs().max().item()
        if err > SSIM_ATOL:
            raise AssertionError(f"ssim {label}: kernel vs plain {err} > {SSIM_ATOL}")
        if not torch.equal(e_k, e_p):
            raise AssertionError(f"sse {label}: kernel != plain")
        worst = max(worst, err)
        log(f"[kernels] ssim_sse_plane {label}: max |ssim diff| {err:.3e}, SSE equal")
    results["ssim_sse_plane"]["max_abs_err"] = worst
    return ref, dist


def time_call(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(torch, device, results, ref, dist, card):
    """Phase 4a: each kernel against its plain version at 1080p, CUDA events."""
    from pqa2_tpu_torch.ops import cuda_adm_int, cuda_ssim, cuda_vif_int
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain, level_input
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain
    from pqa2_tpu_torch.ops.vif_int import to_native_grid, vif_int_scale_plain

    r = to_native_grid(ref[1:33], 8)[0]
    d = to_native_grid(dist[1:33], 8)[0]
    m = to_native_grid(ref, 8)[0]
    kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True, motion_ref=m)
    ra, _ = level_input(ref[1:33], 8)
    da, _ = level_input(dist[1:33], 8)
    akw = dict(level=0, extra_row_shift=0, gain_limit=100.0)
    rl, dl = ref[1:33].float(), dist[1:33].float()
    cases = {
        "vif_int_scale": (lambda: cuda_vif_int.vif_int_scale(r, d, **kw),
                          lambda: vif_int_scale_plain(r, d, **kw),
                          "scale 0, 32 core frames + motion over 34, 1080p"),
        "log2_table_audit": (lambda: cuda_vif_int.log2_table_audit(device),
                             lambda: cuda_vif_int._audit_plain(device),
                             "32768 mantissas x 2"),
        "adm_int_level": (lambda: cuda_adm_int.adm_int_level(ra, da, **akw),
                          lambda: adm_level_plain(ra, da, **akw),
                          "level 0, 32 frames, 1080p"),
        "ssim_sse_plane": (lambda: cuda_ssim.ssim_sse_plane(rl, dl, 8),
                           lambda: ssim_sse_plane_plain(rl, dl, 8),
                           "32 frames, 1080p luma"),
    }
    for name, (kern, plain, what) in cases.items():
        k_ms = time_call(torch, kern, 10)
        p_ms = time_call(torch, plain, 3)
        results[name]["ms"] = k_ms
        results[name]["plain_ms"] = p_ms
        log(f"[times] {name} ({what}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"[{card}]")


def write_pair(n, h, w, ref_path, dist_path, torch, device):
    """Synthetic 8-bit 4:2:0 y4m pair (pqa2_tpu.io.write_y4m)."""
    from pqa2_tpu.io import write_y4m

    ref = smooth_frames(torch, n, h, w, 11, device)
    dist = distort(torch, ref, 12, radius=3, noise=16)

    def planes(y):
        c = torch.nn.functional.avg_pool2d(y.float()[:, None], 2)[:, 0].round().to(torch.uint8)
        return y.cpu().numpy(), c.cpu().numpy()

    ry, rc = planes(ref)
    dy, dc = planes(dist)
    write_y4m(ref_path, [{"y": ry[i], "u": rc[i], "v": 255 - rc[i]} for i in range(n)])
    write_y4m(dist_path, [{"y": dy[i], "u": dc[i], "v": 255 - dc[i]} for i in range(n)])
    return ry, dy


def phase_slice(torch, device, results, card, profile_dir=None):
    """Phase 3 (+ 4b): the main path end to end, then the oracle checks."""
    import numpy as np

    from pqa2_tpu.golden.adm_int import adm_features_int
    from pqa2_tpu.golden.motion_int import motion_features_int
    from pqa2_tpu.golden.vif_int import vif_features_int
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.ops import cuda_adm_int, cuda_ssim, cuda_vif_int

    os.makedirs(WORK_DIR, exist_ok=True)
    ref_path = os.path.join(WORK_DIR, "ref_1080p.y4m")
    dist_path = os.path.join(WORK_DIR, "dist_1080p.y4m")
    n = 72
    ry, dy = write_pair(n, 1080, 1920, ref_path, dist_path, torch, device)
    log(f"[slice] wrote {n}-frame 1920x1080 4:2:0 y4m pair")

    wrappers = {"vif_int_scale": cuda_vif_int.vif_int_scale,
                "log2_table_audit": cuda_vif_int.log2_table_audit,
                "adm_int_level": cuda_adm_int.adm_int_level,
                "ssim_sse_plane": cuda_ssim.ssim_sse_plane}
    analyzer = VMAFAnalyzer(device="cuda")
    analyzer.set_output_directory(os.path.join(WORK_DIR, "out"))
    analyzer.set_test_name("smoke")
    failures = []
    analyzer.analysis_failed.connect(failures.append)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = analyzer.analyze_videos(ref_path, dist_path, model="vmaf_v0.6.1")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    if res is None:
        raise AssertionError(f"analyze_videos failed: {failures}")
    for k, c in counts.items():
        results[k]["launches"] = c
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"[slice] launches on the main path: {counts}")

    keys = {"vmaf_score", "psnr_score", "ssim_score", "json_path", "psnr_log",
            "ssim_log", "reference_video", "distorted_video", "reference_path",
            "distorted_path", "raw_results", "model", "width", "height",
            "frame_count", "duration"}
    if set(res) != keys:
        raise AssertionError(f"results keys differ: {sorted(set(res) ^ keys)}")
    if res["frame_count"] != n or (res["width"], res["height"]) != (1920, 1080):
        raise AssertionError(f"bad geometry/frames in results: {res['frame_count']}")
    with open(res["json_path"]) as f:
        log_json = json.load(f)
    frames = log_json["frames"]
    if len(frames) != n:
        raise AssertionError(f"JSON log has {len(frames)} frames")
    vmaf = np.array([fr["metrics"]["vmaf"] for fr in frames])
    psnr = np.array([fr["metrics"]["psnr_y"] for fr in frames])
    ssim = np.array([fr["metrics"]["float_ssim"] for fr in frames])
    for nm, v in (("vmaf", vmaf), ("psnr_y", psnr), ("ssim", ssim)):
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"non-finite {nm} in the JSON log")
    if not (vmaf.max() < 95.0 and vmaf.min() > 5.0):
        raise AssertionError(f"VMAF range {vmaf.min()}..{vmaf.max()} outside (5, 95)")
    for path in (res["psnr_log"], res["ssim_log"]):
        with open(path) as f:
            lines = f.read().splitlines()
        if len(lines) != n + 1 or "average" not in lines[-1]:
            raise AssertionError(f"{path}: {len(lines)} lines")
    log(f"[slice] vmaf {res['vmaf_score']:.4f} (per frame {vmaf.min():.3f}..{vmaf.max():.3f}), "
        f"psnr {res['psnr_score']:.4f} dB, ssim {res['ssim_score']:.6f}; "
        f"artifacts checked")

    # Frames 0 and 32 (a chunk boundary) against the numpy oracles, on the
    # unrounded features of the run (the JSON rounds to 6 decimals).
    scores_feats = analyzer.last_scores.features
    for i in (0, 32):
        vo = np.array(vif_features_int(ry[i], dy[i]))
        ao = adm_features_int(ry[i], dy[i])[0]
        vp = np.array([scores_feats[f"vif_scale{s}"][i] for s in range(4)])
        if np.max(np.abs(vp - vo)) > VIF_ATOL:
            raise AssertionError(f"frame {i} vif {vp} vs oracle {vo}")
        if abs(scores_feats["adm2"][i] - ao) > ADM_ATOL:
            raise AssertionError(f"frame {i} adm2 {scores_feats['adm2'][i]} vs oracle {ao}")
        log(f"[oracle] frame {i}: max |vif - oracle| {np.max(np.abs(vp - vo)):.3e}, "
            f"|adm2 - oracle| {abs(scores_feats['adm2'][i] - ao):.3e}")
    mo, m2o = motion_features_int(ry[31:34])
    for nm, want in (("motion", mo[1]), ("motion2", m2o[1])):
        got = scores_feats[nm][32]
        if abs(got - want) > MOTION_RTOL * abs(want):
            raise AssertionError(f"frame 32 {nm} {got} vs oracle {want}")
    log(f"[oracle] frame 32: motion {scores_feats['motion'][32]:.6f} "
        f"(oracle {mo[1]:.6f}), motion2 {scores_feats['motion2'][32]:.6f} "
        f"(oracle {m2o[1]:.6f})")

    # Phase 4b: a second, warm run of the same call for the frame rate.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = analyzer.analyze_videos(ref_path, dist_path, model="vmaf_v0.6.1")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if profile_dir:
        profile_run(torch, lambda: analyzer.analyze_videos(ref_path, dist_path),
                    profile_dir, card)
    if res2 is None or abs(res2["vmaf_score"] - res["vmaf_score"]) > 0:
        raise AssertionError("second run differs from the first")
    log(f"[times] slice 1080p vmaf_v0.6.1+PSNR+SSIM, {n} frames: first run "
        f"{elapsed:.3f} s ({n / elapsed:.2f} fps), warm run {warm:.3f} s "
        f"({n / warm:.2f} fps) [{card}]")


def profile_run(torch, run, out_dir, card):
    """torch.profiler over one more warm run of the slice: device busy time
    against wall time, and the kernel table, written to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us[e.name] = busy_us.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(busy_us.values()) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, "slice_profile.txt"), "w") as f:
        f.write(f"{card}\nwall {wall * 1e3:.3f} ms, device busy {total:.3f} ms\n\n")
        for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1]):
            f.write(f"{us / 1e3:10.3f} ms  {name}\n")
        f.write("\n" + table)
    log(f"[profile] slice warm run under torch.profiler: wall {wall * 1e3:.3f} ms, "
        f"device busy {total:.3f} ms ({100.0 * (1 - total / (wall * 1e3)):.1f} % idle) "
        f"[{card}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one warm slice run; tables go to DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pqa2_tpu_torch import _build
    from pqa2_tpu_torch._device import require_cuda

    device = require_cuda("cuda")
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    _build.library(device)
    log(f"[build] {_build.BUILD_DIR / _build.LIB_NAME}: "
        + (f"nvcc build {_build.build_seconds:.2f} s" if _build.build_seconds is not None
           else f"up to date (loaded in {time.perf_counter() - t0:.2f} s)"))
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    results = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep,
                   "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None}
               for k, (src, rep) in KERNELS.items()}
    ref, dist = phase_kernels(torch, device, results)
    phase_times(torch, device, results, ref, dist, card)
    del ref, dist
    torch.cuda.empty_cache()
    phase_slice(torch, device, results, card, args.profile)
    log(card)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
