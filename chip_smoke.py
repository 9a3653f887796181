#!/usr/bin/env python3
"""Smoke run of pqa2_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                  # needs one sm_90 card
    python3 chip_smoke.py --profile DIR    # plus torch.profiler passes
    python3 chip_smoke.py --sass DIR       # plus the VIF and ADM kernels' SASS opcodes

Phases, run in the order 1, 3, 2, 4 so that the slices run in a process
that has done nothing else yet, as a user's does (each prints its lines;
any failure raises and the exit code is 1):

  1. the card (nvidia-smi name and power limit), torch's CUDA version, and
     the nvcc build of ``pqa2_tpu_torch/csrc`` (one nvcc per source, all
     started together; its time when it built);
  2. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes: a 34-frame 1080p luma chunk (32 core frames and
     both halos; integer VIF on the uint8 luma as the main path hands it
     over and on int32 codes) and 960x540 chroma, plus one 3840x2160 and
     one 4096x4096 pair for VIF and ADM. Integer outputs must be equal;
     SSIM within 1e-6; the log2 audit 0 mismatches. The float kernels (VIF
     with the classic statistic, gain inf and 1.0; ADM, gain 100 and 1.0;
     the motion SAD) on the 1080p chunk and a 3840x2160 pair (ADM also on
     a 4096x4096 one): decimated and approximation planes equal in every
     bit, per-frame sums within 1e-5 relative, features within 1e-5, and a
     second launch on the same input gives the same bits. Both VIF kernels also on edge frames at 1080p and
     3840x2160 (all-peak against all-0 and the reverse, 0/peak
     checkerboards of single pixels and of 8x8 blocks against their
     inverses) at 8 bits (integer VIF on uint8 and int32), 10 and 16 bits
     (the largest codes; float VIF on the 8-bit scale, both statistics).
     Integer VIF's fast form (kernel 1f, ``precision="integer_fast"``) on
     the 1080p chunk (uint8 and int32), the 3840x2160 pair and the edge
     frames at 8, 10 and 16 bits, gain inf and 1.0: decimated planes and
     SAD equal, {num, den} sums within 1e-5 relative, features within
     2e-6, a second launch the same bits.
     Integer ADM on uint8 luma (the core frames a slice of the chunk, as
     the main path hands them over) and int32 Q4 codes, at gain 100 and
     1.0, and on the same edge frames at 8, 10, 12 and 16 bits; float ADM
     on the edge frames as f32 on the 8-bit scale, gain 100 and 1.0. The
     audit of integer ADM's quotient routine: 0 mismatches;
  3. the slices: a synthetic 1920x1080 4:2:0 y4m pair of 72 frames through
     ``VMAFAnalyzer(device="cuda").analyze_videos``, with ``vmaf_v0.6.1``
     (the integer family), with ``vmaf_float_v0.6.1`` (the float family)
     and with ``vmaf_v0.6.1`` at ``feature_precision="integer_fast"``, all
     with PSNR+SSIM (chunks 32+32+8): their artifacts, every kernel's launch
     count over each run (the counts are set to 0 just before it and read
     just after; the float run must launch kernels 5-7 and none of kernels
     1-3, the integer_fast run kernel 1f and neither kernel 1 nor the log2
     audit), frames 0 and 32 against the port's numpy oracles
     (``pqa2_tpu_torch.golden``), and the integer_fast features within 1e-3
     of the integer run's. Then the in-memory path: the same pair decoded
     once, through ``VMAFAnalyzer.analyze_frames`` with ``vmaf_v0.6.1``
     and PSNR+SSIM, must give the integer run's features, VMAF, PSNR and
     SSIM in every bit;
  4. CUDA-event times of each kernel against its plain version at 1080p,
     each kernel's bound (the least time the card could take for the same
     work), and each slice's frames per second: its first run and three
     warm runs. With --profile, torch.profiler over one more warm run of
     each slice and over three scale-0 or level-0 calls of each VIF and
     ADM kernel (kernel 1f too).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX and
nothing of the JAX package.
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
    "vif_int_scale_fast": ("pqa2_tpu_torch/csrc/vif_int.cu",
                           "pqa2_tpu/ops/pallas_vif_int.py:1021 (exact=False)"),
    "log2_table_audit": ("pqa2_tpu_torch/csrc/vif_int.cu",
                         "pqa2_tpu/ops/pallas_vif_int.py:152"),
    "adm_int_level": ("pqa2_tpu_torch/csrc/adm_int.cu",
                      "pqa2_tpu/ops/pallas_adm_int.py:381"),
    "ssim_sse_plane": ("pqa2_tpu_torch/csrc/ssim.cu",
                       "pqa2_tpu/ops/pallas_ssim.py:225"),
    "vif_scale": ("pqa2_tpu_torch/csrc/vif.cu",
                  "pqa2_tpu/ops/pallas_vif.py:404"),
    "adm_level": ("pqa2_tpu_torch/csrc/adm.cu",
                  "pqa2_tpu/ops/pallas_adm.py:265"),
    "motion_sad": ("pqa2_tpu_torch/csrc/motion.cu",
                   "pqa2_tpu/ops/pallas_motion.py:137"),
}
INTEGER_KERNELS = ("vif_int_scale", "log2_table_audit", "adm_int_level")
FLOAT_KERNELS = ("vif_scale", "adm_level", "motion_sad")
FAST_KERNELS = ("vif_int_scale_fast",)

# Tolerances against the numpy oracles (pqa2_tpu_torch.golden): the features
# are f32 while the oracles combine in float64.
VIF_ATOL = 2e-6      # integer family: the budget of tests/test_integer.py:80
ADM_ATOL = 2e-6      # integer family: f32 cbrt/rounding chain
MOTION_RTOL = 1e-6   # integer family: f32 rounding of an exact integer SAD
SSIM_ATOL = 1e-6     # kernel vs plain: float64 sums in another order
FLOAT_VIF_ATOL = 2e-4     # float family vs float64: the JAX package's oracle
FLOAT_ADM_ATOL = 2e-4     # budgets (tests/test_ops.py:64, :98, :116)
FLOAT_MOTION_ATOL = 2e-3
FLOAT_SUM_RTOL = 1e-5     # float kernel vs plain: sums of bit-equal per-pixel
FLOAT_FEAT_ATOL = 1e-5    # values, float64 in the kernel, f32 in torch
FAST_FEAT_ATOL = 2e-6     # kernel 1f vs plain: the JAX package's kernel-vs-twin
                          # budget for the integer family (tests/test_pallas_int.py:20)
FAST_VS_EXACT_ATOL = 1e-3  # integer_fast vs integer features (tests/test_integer.py:233)

# The card's peaks for the bound (NVIDIA H100 SXM data sheet): HBM3 bytes/s,
# and f32 operations/s
# outside the tensor cores, used for every scalar ALU operation (integer,
# f32 and f64 alike; the card's int32 and f64 rates are lower, so the bound
# stays a lower bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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


def edge_frames(torch, h, w, depth, device):
    """(ref, dist), 4 frames of codes in [0, 2^depth - 1] (uint8 at 8 bits,
    else int64): all-peak against all-0 and the reverse, a 0/peak
    checkerboard of single pixels and one of 8x8 blocks against their
    inverses."""
    peak = (1 << depth) - 1
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    c1 = ((yy + xx) % 2) * peak
    c8 = ((yy // 8 + xx // 8) % 2) * peak
    full = torch.full((h, w), peak, device=device, dtype=torch.int64)
    zero = torch.zeros_like(full)
    ref = torch.stack([full, zero, c1, c8])
    dist = torch.stack([zero, full, peak - c1, peak - c8])
    if depth == 8:
        ref, dist = ref.to(torch.uint8), dist.to(torch.uint8)
    return ref.contiguous(), dist.contiguous()


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


def check_bits(torch, name, a, b) -> None:
    """Raise unless two f32 outputs are equal in every bit."""
    if a is None and b is None:
        return
    if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{name}: shapes/dtypes differ")
    if not torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)):
        diff = (a.double() - b.double()).abs().max().item()
        raise AssertionError(f"{name}: not bit-equal (max |diff| {diff:.3e})")


def check_rel(torch, name, a, b, rtol) -> float:
    """Max relative difference of two f32 sums; raises past rtol."""
    a, b = a.double(), b.double()
    rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
    if not rel <= rtol:
        raise AssertionError(f"{name}: relative difference {rel:.3e} > {rtol}")
    return rel


def phase_kernels(torch, device, results):
    """Phase 2: each kernel's wrapper on CUDA tensors against its plain
    version on the same tensors."""
    from pqa2_tpu_torch.golden.fixedpoint import ADM_BAND_Q
    from pqa2_tpu_torch.ops import cuda_adm_int, cuda_ssim, cuda_vif_int
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain, level_input
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain
    from pqa2_tpu_torch.ops.vif_int import fast_ratio, to_native_grid, vif_int_scale_plain

    mism = cuda_vif_int.log2_table_audit(device)
    log(f"[kernels] log2 audit: {mism} mismatches of 32768 mantissas (x2 shifts)")
    results["log2_table_audit"]["max_abs_err"] = float(mism)

    err = {"vif_int_scale": 0.0, "adm_int_level": 0.0, "vif_int_scale_fast": 0.0}
    fast_rel = [0.0]

    def vif_all_scales(r, d, mref, in_q, label, fast=False):
        """Kernel 1 at all four scales; with ``fast`` kernel 1f on the same
        inputs after it."""
        r0, d0, in_q0 = r, d, in_q
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
            f"{' and SAD' if mref is not None else ''} equal at all 4 scales")
        if fast:
            for gain in (float("inf"), 1.0):
                vif_fast_all_scales(r0, d0, mref, in_q0, label, gain)

    def vif_fast_all_scales(r, d, mref, in_q, label, gain):
        """Kernel 1f: the same planes and SAD as its plain version, the
        {num, den} sums within 1e-5 relative, the features within 2e-6, a
        second launch the same bits."""
        worst = 0.0
        for scale in range(4):
            kw = dict(scale=scale, in_q=in_q, gain_limit=gain, decimate=scale < 3,
                      motion_ref=mref if scale == 0 else None, exact=False)
            got = cuda_vif_int.vif_int_scale(r, d, **kw)
            again = cuda_vif_int.vif_int_scale(r, d, **kw)
            want = vif_int_scale_plain(r, d, **kw)
            tag = f"vif fast {label} gain {gain} scale {scale}"
            for nm, a, b in zip(("next_ref", "next_dist", "sad"), got[1:], want[1:]):
                check_equal(torch, f"{tag} {nm}", a, b)
            check_bits(torch, f"{tag} sums (second launch)", got[0], again[0])
            for nm, a, b in zip(("next_ref", "next_dist", "sad"), got[1:], again[1:]):
                check_equal(torch, f"{tag} {nm} (second launch)", a, b)
            fast_rel[0] = max(fast_rel[0], check_rel(torch, f"{tag} sums", got[0], want[0],
                                                     FLOAT_SUM_RTOL))
            fe = (fast_ratio(got[0]) - fast_ratio(want[0])).abs().max().item()
            if not fe <= FAST_FEAT_ATOL:
                raise AssertionError(f"{tag}: feature difference {fe:.3e}")
            worst = max(worst, fe)
            torch.cuda.synchronize()
            del want, again
            r, d, in_q = got[1], got[2], 8
        err["vif_int_scale_fast"] = max(err["vif_int_scale_fast"], worst)
        log(f"[kernels] vif_int_scale_fast {label} gain {gain}: decimated planes"
            f"{' and SAD' if mref is not None else ''} equal, sums within "
            f"{FLOAT_SUM_RTOL:g} rel (max {fast_rel[0]:.3e} so far), features within "
            f"{FAST_FEAT_ATOL:g} (max {worst:.3e}), second launch bit-equal, all 4 scales")

    def adm_all_levels(ref, dist, label, depth=8, kinds=("uint8", "int32"),
                       gains=(100.0, 1.0)):
        """Kernel 3 at all four levels from luma (uint8 at 8 bits, else
        int32 codes): on the level-0 input the main path hands over (8-bit
        luma as it is) and on int32 Q4 codes."""
        for kind in kinds:
            src_r = ref if kind == "uint8" else ref.to(torch.int32)
            src_d = dist if kind == "uint8" else dist.to(torch.int32)
            r0, drop0 = level_input(src_r, depth)
            d0, _ = level_input(src_d, depth)
            for gain in gains:
                r, d, drop = r0, d0, drop0
                for lvl in range(4):
                    if lvl:
                        drop = ADM_BAND_Q[lvl - 1] - ADM_BAND_Q[lvl]
                    kw = dict(level=lvl, extra_row_shift=drop, gain_limit=gain)
                    got = cuda_adm_int.adm_int_level(r, d, **kw)
                    want = adm_level_plain(r, d, **kw)
                    for nm, a, b in zip(("cube sums", "ref approx", "dist approx"), got, want):
                        err["adm_int_level"] = max(err["adm_int_level"], check_equal(
                            torch, f"adm {label} {kind} gain {gain} level {lvl} {nm}", a, b))
                    torch.cuda.synchronize()
                    del want
                    r, d = got[1], got[2]
        log(f"[kernels] adm_int_level {label} ({'/'.join(kinds)}, gain "
            f"{'/'.join(f'{g:g}' for g in gains)}): pooled cube sums and approximation "
            f"planes equal at all 4 levels")

    # 1080p chunk: 32 core frames with a halo frame on each side, as the
    # main path hands it over (uint8 luma, the core frames a view of the
    # chunk), and as int32 codes.
    ref = smooth_frames(torch, 34, 1080, 1920, 1, device)
    dist = distort(torch, ref, 2)
    for kind, (cr, cd) in (("uint8", (ref, dist)),
                           ("int32", (to_native_grid(ref, 8)[0], to_native_grid(dist, 8)[0]))):
        vif_all_scales(cr[1:33], cd[1:33], cr, 0, f"1080p 32+2 frames {kind}", fast=True)
    adm_all_levels(ref[1:33], dist[1:33], "1080p 32 core frames of the chunk")
    for label, (h, w) in (("3840x2160", (2160, 3840)), ("4096x4096", (4096, 4096))):
        r1 = smooth_frames(torch, 1, h, w, 3, device)
        d1 = distort(torch, r1, 4)
        vif_all_scales(r1, d1, None, 0, label, fast=label == "3840x2160")
        adm_all_levels(r1, d1, label)
        del r1, d1
    # The edges of kernel 1's arithmetic: uint32 filters at 8 bits, the
    # widening path at 10 and 16 bits, at the largest codes; and of kernel
    # 3's: an int32 DWT up to 12 bits, level 0's row pass widened at 16.
    for label, (h, w) in (("1080p", (1080, 1920)), ("3840x2160", (2160, 3840))):
        for depth, kind in ((8, "uint8"), (8, "int32"), (10, "int32"), (16, "int32")):
            r1, d1 = edge_frames(torch, h, w, depth, device)
            if kind == "int32":
                r1, d1 = r1.to(torch.int32), d1.to(torch.int32)
            vif_all_scales(r1, d1, r1, max(depth - 8, 0), f"edges {label} {depth}-bit {kind}",
                           fast=True)
            del r1, d1
        for depth in (8, 10, 12, 16):
            r1, d1 = edge_frames(torch, h, w, depth, device)
            adm_all_levels(r1, d1, f"edges {label} {depth}-bit", depth,
                           kinds=("uint8", "int32") if depth == 8 else ("int32",))
            del r1, d1
    mism = cuda_adm_int.quotient_audit(device)
    log(f"[kernels] adm_int_level quotient audit: {mism} mismatches over every "
        f"(|t| << 15) / |o| with |t| < |o| <= {cuda_adm_int.QUOTIENT_OA_MAX} and the "
        f"directed numerators q*|o|, q*|o| - 1, q*|o| + |o| - 1 of every q < 2^15")
    for k, v in err.items():
        results[k]["max_abs_err"] = v
    log(f"[kernels] vif_int_scale_fast: largest relative difference of the {{num, den}} "
        f"sums from the plain version on the card {fast_rel[0]:.3e}"
        + (" (equal in every bit)" if fast_rel[0] == 0.0 else ""))

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
    del chroma, chroma_d
    phase_float_kernels(torch, device, results, ref, dist)
    return ref, dist


def phase_float_kernels(torch, device, results, ref, dist):
    """Phase 2, float family: kernels 5-7 against their plain versions on
    the 1080p chunk and a 3840x2160 pair (kernel 6 also on a 4096x4096
    one)."""
    from pqa2_tpu_torch.ops import cuda_adm, cuda_motion, cuda_vif
    from pqa2_tpu_torch.ops.adm import adm_from_level_sums, adm_level_plain_float
    from pqa2_tpu_torch.ops.motion import motion_sad_plain
    from pqa2_tpu_torch.ops.vif import vif_ratio, vif_scale_plain

    err = {k: 0.0 for k in FLOAT_KERNELS}

    def vif_all_scales(r, d, m, label, gain, variant="classic"):
        for scale in range(4):
            kw = dict(scale=scale, gain_limit=gain, variant=variant, emit_next=scale < 3)
            got = cuda_vif.vif_scale(r, d, motion_ref=m if scale == 0 else None, **kw)
            again = cuda_vif.vif_scale(r, d, motion_ref=m if scale == 0 else None, **kw)
            want = vif_scale_plain(r, d, **kw)
            tag = f"vif {label} gain {gain} scale {scale}"
            for nm, a, b in (("next_ref", got[2], want[2]), ("next_dist", got[3], want[3])):
                check_bits(torch, f"{tag} {nm}", a, b)
            for nm, a, b in zip(("num", "den", "next_ref", "next_dist", "sad"), got, again):
                check_bits(torch, f"{tag} {nm} (second launch)", a, b)
            check_rel(torch, f"{tag} num", got[0], want[0], FLOAT_SUM_RTOL)
            check_rel(torch, f"{tag} den", got[1], want[1], FLOAT_SUM_RTOL)
            fe = (vif_ratio(got[0], got[1]) - vif_ratio(want[0], want[1])).abs().max().item()
            if not fe <= FLOAT_FEAT_ATOL:
                raise AssertionError(f"{tag}: feature difference {fe:.3e}")
            err["vif_scale"] = max(err["vif_scale"], fe)
            if got[4] is not None:
                sp = motion_sad_plain(m)
                check_rel(torch, f"{tag} sad", got[4][1:], sp[1:], FLOAT_SUM_RTOL)
                if got[4][0].item() != 0.0:
                    raise AssertionError(f"{tag}: sad of frame 0 is {got[4][0].item()}")
                err["motion_sad"] = max(err["motion_sad"],
                                        (got[4] - sp).abs().max().item())
            torch.cuda.synchronize()
            del want, again
            r, d = got[2], got[3]
        log(f"[kernels] vif_scale {label} {variant} gain {gain}: decimated planes "
            f"bit-equal, num/den within {FLOAT_SUM_RTOL:g} rel, features within "
            f"{FLOAT_FEAT_ATOL:g}{', motion SAD within 1e-05 rel' if m is not None else ''}, "
            f"second launch bit-equal, all 4 scales")

    def adm_all_levels(r, d, label, gain):
        h, w = r.shape[-2:]
        sums_k, sums_p = [], []
        for lvl in range(4):
            got = cuda_adm.adm_level(r, d, level=lvl, gain_limit=gain)
            again = cuda_adm.adm_level(r, d, level=lvl, gain_limit=gain)
            want = adm_level_plain_float(r, d, level=lvl, gain_limit=gain)
            tag = f"adm {label} gain {gain} level {lvl}"
            for nm, a, b in (("ref approx", got[1], want[1]), ("dist approx", got[2], want[2])):
                check_bits(torch, f"{tag} {nm}", a, b)
            for nm, a, b in zip(("sums", "ref approx", "dist approx"), got, again):
                check_bits(torch, f"{tag} {nm} (second launch)", a, b)
            check_rel(torch, f"{tag} sums", got[0], want[0], FLOAT_SUM_RTOL)
            sums_k.append(got[0])
            sums_p.append(want[0])
            torch.cuda.synchronize()
            del want, again
            r, d = got[1], got[2]
        fe = (adm_from_level_sums(sums_k, h, w)
              - adm_from_level_sums(sums_p, h, w)).abs().max().item()
        if not fe <= FLOAT_FEAT_ATOL:
            raise AssertionError(f"adm {label} gain {gain}: adm2 difference {fe:.3e}")
        err["adm_level"] = max(err["adm_level"], fe)
        log(f"[kernels] adm_level {label} gain {gain}: approximation bands bit-equal, "
            f"sums within {FLOAT_SUM_RTOL:g} rel, |adm2 diff| {fe:.3e}, second launch "
            f"bit-equal, all 4 levels")

    rf, df, mf = ref[1:33].float(), dist[1:33].float(), ref.float()
    for gain in (float("inf"), 1.0):
        vif_all_scales(rf, df, mf, "1080p 32+2 frames", gain)
    # The same edge frames as kernel 1's, as f32 on the 8-bit scale, both
    # statistics.
    for label, (h, w) in (("1080p", (1080, 1920)), ("3840x2160", (2160, 3840))):
        for depth in (8, 10, 16):
            r1, d1 = edge_frames(torch, h, w, depth, device)
            r1, d1 = r1.float() / (1 << (depth - 8)), d1.float() / (1 << (depth - 8))
            for variant in ("classic", "default"):
                for gain in (float("inf"), 1.0):
                    vif_all_scales(r1, d1, None, f"edges {label} {depth}-bit", gain, variant)
            del r1, d1
    for gain in (100.0, 1.0):
        adm_all_levels(rf, df, "1080p 32 frames", gain)
    # Kernel 3's edge frames, as f32 on the 8-bit scale.
    for label, (h, w) in (("1080p", (1080, 1920)), ("3840x2160", (2160, 3840))):
        for depth in (8, 10, 12, 16):
            r1, d1 = edge_frames(torch, h, w, depth, device)
            r1, d1 = r1.float() / (1 << (depth - 8)), d1.float() / (1 << (depth - 8))
            for gain in (100.0, 1.0):
                adm_all_levels(r1, d1, f"edges {label} {depth}-bit", gain)
            del r1, d1
    check_bits(torch, "motion_sad (second launch)", cuda_motion.motion_sad(mf),
               cuda_motion.motion_sad(mf))
    del rf, df, mf
    r1 = smooth_frames(torch, 2, 2160, 3840, 5, device)
    d1 = distort(torch, r1, 6).float()
    r1 = r1.float()
    vif_all_scales(r1[1:], d1[1:], r1, "3840x2160", float("inf"))
    vif_all_scales(r1[1:], d1[1:], None, "3840x2160", 1.0)
    for gain in (100.0, 1.0):
        adm_all_levels(r1[1:], d1[1:], "3840x2160", gain)
    r1 = smooth_frames(torch, 1, 4096, 4096, 7, device)
    d1 = distort(torch, r1, 8).float()
    r1 = r1.float()
    for gain in (100.0, 1.0):
        adm_all_levels(r1, d1, "4096x4096", gain)
    del r1, d1
    for k, v in err.items():
        results[k]["max_abs_err"] = v


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


def bound(nbytes: float, nops: float):
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the scalar rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name, n, h, w, m=0):
    """(bytes moved, operations) of one timed call, from its shapes: each
    input read once, each output written once; operations counted per pixel
    as the algorithm needs them (a multiply and an add per filter tap)."""
    p = n * h * w
    b2 = n * ((h + 1) // 2) * ((w + 1) // 2)
    blur5 = 2 * (2 * 5)                 # 5-tap column + row pass, per pixel
    # Next scale's 9-tap blur of 2 planes at the kept pixels: the column
    # pass at the even rows of every column, then the row pass at the even
    # columns.
    dec9 = 2 * b2 * (2 * 2 * 9 + 2 * 9)
    if name == "vif_int_scale":         # scale 0 (17 taps) + decimation (9) + motion
        return ((2 * p + m * h * w) * 4 + 2 * b2 * 4 + n * 7 * 8 + (m - 1) * 8,
                p * (20 * 17 + 3 + 40) + dec9 + m * h * w * blur5
                + (m - 1) * h * w * 3)
    if name == "vif_int_scale_fast":    # the same passes; the f32-log statistic:
        # 3 conversions and 3 scalings, g (compare, max, divide), sv^2
        # (multiply, subtract, max), the gain clamp, num (2 multiplies, 2
        # adds, a divide, log2), den (divide, add, log2), 2 widenings and
        # 2 adds into the sums: 26 per pixel; out (N, 2) f32.
        return ((2 * p + m * h * w) * 4 + 2 * b2 * 4 + n * 2 * 4 + (m - 1) * 8,
                p * (20 * 17 + 3 + 26) + dec9 + m * h * w * blur5
                + (m - 1) * h * w * 3)
    if name == "log2_table_audit":      # 32768 mantissas x 2 lookups
        return 32768 * 4 + 65536 * 4, 65536 * 12
    if name in ("adm_int_level", "adm_level"):  # level 0: DWT of 2 planes + pooling
        return 2 * p * 4 + 2 * b2 * 4 + n * 6 * 8, 2 * b2 * 96 + b2 * 110
    if name == "ssim_sse_plane":
        return 2 * p * 4 + n * 12, p * 13
    if name == "vif_scale":             # scale 0 (17 taps) + next scale's 9 taps
        return 2 * p * 4 + 2 * b2 * 4 + n * 8, p * (20 * 17 + 28) + dec9
    if name == "motion_sad":            # every frame blurred once, n-1 differences
        return p * 4 + n * 4, p * blur5 + (n - 1) * h * w * 3
    raise KeyError(name)


def phase_times(torch, device, results, ref, dist, card, profile_dir=None):
    """Phase 4a: each kernel against its plain version at 1080p, CUDA events,
    and its bound."""
    from pqa2_tpu_torch.ops import (
        cuda_adm,
        cuda_adm_int,
        cuda_motion,
        cuda_ssim,
        cuda_vif,
        cuda_vif_int,
    )
    from pqa2_tpu_torch.ops.adm import adm_level_plain_float
    from pqa2_tpu_torch.ops.adm_int import adm_level_plain, level_input
    from pqa2_tpu_torch.ops.motion import motion_sad_plain
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain
    from pqa2_tpu_torch.ops.vif import vif_scale_plain
    from pqa2_tpu_torch.ops.vif_int import to_native_grid, vif_int_scale_plain

    n, h, w = 32, ref.shape[1], ref.shape[2]
    # The main path's scale-0 call: the chunk's uint8 luma, the core frames
    # a view of it (the int32 codes are timed beside it).
    r, d, m = ref[1:33], dist[1:33], ref
    kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True, motion_ref=m)
    mi = to_native_grid(ref, 8)[0]
    ri, di = mi[1:33], to_native_grid(dist[1:33], 8)[0]
    kwi = dict(kw, motion_ref=mi)
    # Integer ADM's row figure: int32 Q4 codes, as the parent took them;
    # the main path's uint8 call is timed beside it.
    ra, _ = level_input(ref[1:33].to(torch.int32), 8)
    da, _ = level_input(dist[1:33].to(torch.int32), 8)
    akw = dict(level=0, extra_row_shift=0, gain_limit=100.0)
    rl, dl, ml = ref[1:33].float(), dist[1:33].float(), ref.float()
    fkw = dict(scale=0, gain_limit=float("inf"), variant="classic", emit_next=True)
    cases = {
        "vif_int_scale": (lambda: cuda_vif_int.vif_int_scale(r, d, **kw),
                          lambda: vif_int_scale_plain(r, d, **kw),
                          "scale 0, 32 core frames + motion over 34, 1080p, uint8",
                          work("vif_int_scale", n, h, w, m=34)),
        "vif_int_scale_fast": (lambda: cuda_vif_int.vif_int_scale(r, d, exact=False, **kw),
                               lambda: vif_int_scale_plain(r, d, exact=False, **kw),
                               "fast form, scale 0, 32 core frames + motion over 34, "
                               "1080p, uint8", work("vif_int_scale_fast", n, h, w, m=34)),
        "log2_table_audit": (lambda: cuda_vif_int.log2_table_audit(device),
                             lambda: cuda_vif_int._audit_plain(device),
                             "32768 mantissas x 2", work("log2_table_audit", 0, 0, 0)),
        "adm_int_level": (lambda: cuda_adm_int.adm_int_level(ra, da, **akw),
                          lambda: adm_level_plain(ra, da, **akw),
                          "level 0, 32 frames, 1080p, int32 Q4 codes",
                          work("adm_int_level", n, h, w)),
        "ssim_sse_plane": (lambda: cuda_ssim.ssim_sse_plane(rl, dl, 8),
                           lambda: ssim_sse_plane_plain(rl, dl, 8),
                           "32 frames, 1080p luma", work("ssim_sse_plane", n, h, w)),
        "vif_scale": (lambda: cuda_vif.vif_scale(rl, dl, **fkw),
                      lambda: vif_scale_plain(rl, dl, **fkw),
                      "scale 0 classic + next scale's planes, 32 frames, 1080p",
                      work("vif_scale", n, h, w)),
        "adm_level": (lambda: cuda_adm.adm_level(rl, dl, level=0, gain_limit=100.0),
                      lambda: adm_level_plain_float(rl, dl, level=0, gain_limit=100.0),
                      "level 0, 32 frames, 1080p", work("adm_level", n, h, w)),
        "motion_sad": (lambda: cuda_motion.motion_sad(ml),
                       lambda: motion_sad_plain(ml),
                       "34 frames (32 + both halos), 1080p", work("motion_sad", 34, h, w)),
    }
    for name, (kern, plain, what, (nbytes, nops)) in cases.items():
        k_ms = time_call(torch, kern, 10)
        p_ms = time_call(torch, plain, 3)
        b_ms, by = bound(nbytes, nops)
        results[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        log(f"[times] {name} ({what}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops) "
            f"[{card}]")
    i_ms = time_call(torch, lambda: cuda_vif_int.vif_int_scale(ri, di, **kwi), 10)
    log(f"[times] vif_int_scale (the same call on int32 codes): kernel {i_ms:.3f} ms [{card}]")
    u_ms = time_call(torch, lambda: cuda_adm_int.adm_int_level(r, d, **akw), 10)
    log(f"[times] adm_int_level (the same call on the chunk's uint8 luma, as the main "
        f"path hands it over): kernel {u_ms:.3f} ms [{card}]")
    if profile_dir:
        for name in ("vif_int_scale", "vif_int_scale_fast", "vif_scale", "adm_int_level",
                     "adm_level"):
            fn = cases[name][0]
            profile_run(torch, lambda: [fn() for _ in range(3)], profile_dir, card,
                        f"{name}_3_calls")


def write_pair(n, h, w, ref_path, dist_path, torch, device):
    """Synthetic 8-bit 4:2:0 y4m pair (pqa2_tpu_torch.io.y4m.write_y4m)."""
    from pqa2_tpu_torch.io.y4m import write_y4m

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


def kernel_counters():
    """Each kernel's launch counter: (wrapper, attribute). Kernel 1f is the
    integer VIF wrapper's fast form, counted apart."""
    from pqa2_tpu_torch.ops import (
        cuda_adm,
        cuda_adm_int,
        cuda_motion,
        cuda_ssim,
        cuda_vif,
        cuda_vif_int,
    )

    return {"vif_int_scale": (cuda_vif_int.vif_int_scale, "launches"),
            "vif_int_scale_fast": (cuda_vif_int.vif_int_scale, "fast_launches"),
            "log2_table_audit": (cuda_vif_int.log2_table_audit, "launches"),
            "adm_int_level": (cuda_adm_int.adm_int_level, "launches"),
            "ssim_sse_plane": (cuda_ssim.ssim_sse_plane, "launches"),
            "vif_scale": (cuda_vif.vif_scale, "launches"),
            "adm_level": (cuda_adm.adm_level, "launches"),
            "motion_sad": (cuda_motion.motion_sad, "launches")}


def counted(torch, run):
    """``run()`` with every launch count set to 0 just before it and read
    just after -> (its result, seconds, launch counts)."""
    counters = kernel_counters()
    for obj, attr in counters.values():
        setattr(obj, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return res, elapsed, {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}


def check_results(res, label, model, n):
    """The results dict and the artifacts of one run."""
    import numpy as np

    if res is None:
        raise AssertionError(f"{label} failed")
    keys = {"vmaf_score", "psnr_score", "ssim_score", "json_path", "psnr_log",
            "ssim_log", "reference_video", "distorted_video", "reference_path",
            "distorted_path", "raw_results", "model", "width", "height",
            "frame_count", "duration"}
    if set(res) != keys:
        raise AssertionError(f"results keys differ: {sorted(set(res) ^ keys)}")
    if res["frame_count"] != n or (res["width"], res["height"]) != (1920, 1080):
        raise AssertionError(f"bad geometry/frames in results: {res['frame_count']}")
    if res["model"] != model:
        raise AssertionError(f"results name model {res['model']}, not {model}")
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
    log(f"[slice] {label}: vmaf {res['vmaf_score']:.4f} (per frame "
        f"{vmaf.min():.3f}..{vmaf.max():.3f}), psnr {res['psnr_score']:.4f} dB, "
        f"ssim {res['ssim_score']:.6f}; artifacts checked")


def run_slice(torch, analyzer, ref_path, dist_path, model, n, label):
    """One main-path run through ``analyze_videos``, counted; checks its
    artifacts. Returns (results dict, seconds, launch counts)."""
    res, elapsed, counts = counted(
        torch, lambda: analyzer.analyze_videos(ref_path, dist_path, model=model))
    check_results(res, label, model, n)
    log(f"[slice] {label}: launches on the main path: {counts}")
    return res, elapsed, counts


def warm_runs(torch, analyzer, ref_path, dist_path, model, first, n, card, profile_dir,
              label, runs=3):
    """Phase 4b: warm runs of the same call for the frame rate (and, with
    --profile, one more under torch.profiler)."""
    fps = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = analyzer.analyze_videos(ref_path, dist_path, model=model)
        torch.cuda.synchronize()
        fps.append(n / (time.perf_counter() - t0))
        if res2 is None or abs(res2["vmaf_score"] - first[0]["vmaf_score"]) > 0:
            raise AssertionError(f"{label}: a warm run differs from the first")
    if profile_dir:
        profile_run(torch, lambda: analyzer.analyze_videos(ref_path, dist_path, model=model),
                    profile_dir, card, f"slice_{label}_warm_run")
    log(f"[times] slice 1080p {label}+PSNR+SSIM, {n} frames: first run "
        f"{first[1]:.3f} s ({n / first[1]:.2f} fps), warm runs "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f" fps (median {sorted(fps)[len(fps) // 2]:.2f}) [{card}]")


def expect_counts(counts, label, want):
    """Raise unless each named kernel was launched ``want[name]`` times
    (None: at least once)."""
    for k, v in want.items():
        if (counts[k] <= 0) if v is None else (counts[k] != v):
            raise AssertionError(f"{label}: {k} launched {counts[k]} times, expected "
                                 f"{'at least once' if v is None else v}: {counts}")


def phase_slice(torch, device, results, card, profile_dir=None):
    """Phase 3 (+ 4b): the three main paths and the in-memory path end to
    end, with the oracle and cross-path checks."""
    import numpy as np

    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.golden.adm import adm_features
    from pqa2_tpu_torch.golden.adm_int import adm_features_int
    from pqa2_tpu_torch.golden.motion import motion_features
    from pqa2_tpu_torch.golden.motion_int import motion_features_int
    from pqa2_tpu_torch.golden.vif import vif_features
    from pqa2_tpu_torch.golden.vif_int import vif_features_int
    from pqa2_tpu_torch.io.video import VideoReader

    os.makedirs(WORK_DIR, exist_ok=True)
    ref_path = os.path.join(WORK_DIR, "ref_1080p.y4m")
    dist_path = os.path.join(WORK_DIR, "dist_1080p.y4m")
    n = 72
    ry, dy = write_pair(n, 1080, 1920, ref_path, dist_path, torch, device)
    log(f"[slice] wrote {n}-frame 1920x1080 4:2:0 y4m pair")

    def analyzer(name, precision=None):
        a = VMAFAnalyzer(device="cuda")
        a.set_output_directory(os.path.join(WORK_DIR, "out"))
        a.set_test_name(name)
        a.feature_precision = precision
        return a

    # The integer family: vmaf_v0.6.1 runs kernels 1-4.
    model = "vmaf_v0.6.1"
    exact = analyzer("smoke")
    first = run_slice(torch, exact, ref_path, dist_path, model, n, model)
    counts = first[2]
    expect_counts(counts, model, {k: None for k in (*INTEGER_KERNELS, "ssim_sse_plane")})
    expect_counts(counts, model, {k: 0 for k in (*FLOAT_KERNELS, *FAST_KERNELS)})
    for k in (*INTEGER_KERNELS, "ssim_sse_plane"):
        results[k]["launches"] = counts[k]
    int_scores = exact.last_scores

    # Frames 0 and 32 (a chunk boundary) against the numpy oracles, on the
    # unrounded features of the run (the JSON rounds to 6 decimals).
    feats = int_scores.features
    for i in (0, 32):
        vo = np.array(vif_features_int(ry[i], dy[i]))
        ao = adm_features_int(ry[i], dy[i])[0]
        vp = np.array([feats[f"vif_scale{s}"][i] for s in range(4)])
        if np.max(np.abs(vp - vo)) > VIF_ATOL:
            raise AssertionError(f"frame {i} vif {vp} vs oracle {vo}")
        if abs(feats["adm2"][i] - ao) > ADM_ATOL:
            raise AssertionError(f"frame {i} adm2 {feats['adm2'][i]} vs oracle {ao}")
        log(f"[oracle] {model} frame {i}: max |vif - oracle| "
            f"{np.max(np.abs(vp - vo)):.3e}, |adm2 - oracle| {abs(feats['adm2'][i] - ao):.3e}")
    mo, m2o = motion_features_int(ry[31:34])
    for nm, want in (("motion", mo[1]), ("motion2", m2o[1])):
        got = feats[nm][32]
        if abs(got - want) > MOTION_RTOL * abs(want):
            raise AssertionError(f"frame 32 {nm} {got} vs oracle {want}")
    log(f"[oracle] {model} frame 32: motion {feats['motion'][32]:.6f} "
        f"(oracle {mo[1]:.6f}), motion2 {feats['motion2'][32]:.6f} (oracle {m2o[1]:.6f})")
    warm_runs(torch, exact, ref_path, dist_path, model, first, n, card, profile_dir, model)

    # The float family: vmaf_float_v0.6.1 runs kernels 4-7 and none of 1-3.
    model = "vmaf_float_v0.6.1"
    flt = analyzer("smoke")
    first = run_slice(torch, flt, ref_path, dist_path, model, n, model)
    counts = first[2]
    expect_counts(counts, model, {k: None for k in (*FLOAT_KERNELS, "ssim_sse_plane")})
    expect_counts(counts, model, {k: 0 for k in (*INTEGER_KERNELS, *FAST_KERNELS)})
    for k in FLOAT_KERNELS:
        results[k]["launches"] = counts[k]
    feats = flt.last_scores.features
    for i in (0, 32):
        vo = np.array(vif_features(ry[i], dy[i], variant="classic"))
        ao = adm_features(ry[i], dy[i])[0]
        vp = np.array([feats[f"vif_scale{s}"][i] for s in range(4)])
        if np.max(np.abs(vp - vo)) > FLOAT_VIF_ATOL:
            raise AssertionError(f"{model} frame {i} vif {vp} vs oracle {vo}")
        if abs(feats["adm2"][i] - ao) > FLOAT_ADM_ATOL:
            raise AssertionError(f"{model} frame {i} adm2 {feats['adm2'][i]} vs oracle {ao}")
        log(f"[oracle] {model} frame {i}: max |vif - oracle| {np.max(np.abs(vp - vo)):.3e}, "
            f"|adm2 - oracle| {abs(feats['adm2'][i] - ao):.3e}")
    mo, m2o = motion_features(ry[31:34].astype(np.float64))
    for nm, want in (("motion", mo[1]), ("motion2", m2o[1])):
        got = feats[nm][32]
        if abs(got - want) > FLOAT_MOTION_ATOL:
            raise AssertionError(f"{model} frame 32 {nm} {got} vs oracle {want}")
    log(f"[oracle] {model} frame 32: motion {feats['motion'][32]:.6f} (oracle "
        f"{mo[1]:.6f}), motion2 {feats['motion2'][32]:.6f} (oracle {m2o[1]:.6f})")
    warm_runs(torch, flt, ref_path, dist_path, model, first, n, card, profile_dir, model)

    # integer_fast: vmaf_v0.6.1 with VIF's smooth-log statistic runs kernel
    # 1f in place of kernel 1, and no log2 table audit.
    model, label = "vmaf_v0.6.1", "vmaf_v0.6.1 integer_fast"
    fast = analyzer("smoke_fast", "integer_fast")
    first = run_slice(torch, fast, ref_path, dist_path, model, n, label)
    counts = first[2]
    expect_counts(counts, label, {"vif_int_scale_fast": 12, "vif_int_scale": 0,
                                  "log2_table_audit": 0, "adm_int_level": 12,
                                  "ssim_sse_plane": None})
    expect_counts(counts, label, {k: 0 for k in FLOAT_KERNELS})
    results["vif_int_scale_fast"]["launches"] = counts["vif_int_scale_fast"]
    fs = fast.last_scores
    dfeat = max(float(np.max(np.abs(fs.features[k].astype(np.float64)
                                    - int_scores.features[k]))) for k in fs.features)
    dvmaf = np.abs(fs.vmaf.astype(np.float64) - int_scores.vmaf)
    if not dfeat <= FAST_VS_EXACT_ATOL:
        raise AssertionError(f"{label}: features {dfeat:.3e} from the integer run's")
    for k in ("adm2", "motion", "motion2"):
        if not np.array_equal(fs.features[k], int_scores.features[k]):
            raise AssertionError(f"{label}: {k} differs from the integer run's")
    log(f"[slice] {label} against the integer run: max |feature delta| {dfeat:.3e} "
        f"(vif only; adm2 and motion equal), per-frame max |VMAF delta| "
        f"{dvmaf.max():.3e} (mean {dvmaf.mean():.3e})")
    warm_runs(torch, fast, ref_path, dist_path, model, first, n, card, profile_dir,
              "vmaf_v0.6.1_integer_fast")

    # The in-memory path: the pair decoded once, then analyze_frames. It
    # must give the integer run's per-frame values in every bit.
    planes = []
    for path in (ref_path, dist_path):
        r = VideoReader(path)
        try:
            planes.append(list(r))
        finally:
            r.close()
    label = "vmaf_v0.6.1 analyze_frames"
    mem = analyzer("smoke_frames")
    res, elapsed, counts = counted(torch, lambda: mem.analyze_frames(
        planes[0], planes[1], model="vmaf_v0.6.1", reference_name=ref_path,
        distorted_name=dist_path))
    check_results(res, label, "vmaf_v0.6.1", n)
    log(f"[slice] {label}: launches on the in-memory path: {counts}")
    expect_counts(counts, label, {"vif_int_scale": 12, "log2_table_audit": 1,
                                  "adm_int_level": 12, "ssim_sse_plane": 9})
    expect_counts(counts, label, {k: 0 for k in (*FLOAT_KERNELS, *FAST_KERNELS)})
    got = mem.last_scores
    pairs = [(f"feature {k}", got.features[k], int_scores.features[k]) for k in got.features]
    pairs += [("vmaf", got.vmaf, int_scores.vmaf)]
    pairs += [(k, got.psnr[k], int_scores.psnr[k]) for k in int_scores.psnr]
    pairs += [(k, got.ssim[k], int_scores.ssim[k]) for k in int_scores.ssim]
    for nm, a, b in pairs:
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"{label}: {nm} differs from analyze_videos'")
    log(f"[slice] {label}: {len(pairs)} per-frame arrays (features, VMAF, PSNR, SSIM) "
        f"equal to analyze_videos' in every bit; {elapsed:.3f} s for {n} decoded frames "
        f"[{card}]")


def profile_run(torch, run, out_dir, card, label):
    """torch.profiler over one call of ``run`` (a warm slice run, or one
    kernel call): device busy time against wall time, and the kernel table,
    written to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us[e.name] = busy_us.get(e.name, 0.0) + e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
    total = sum(busy_us.values()) / 1e3
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=40)
    host = averages.table(sort_by="self_cpu_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(f"{card}\n{label}: wall {wall * 1e3:.3f} ms, device busy {total:.3f} ms\n\n")
        for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1]):
            f.write(f"{us / 1e3:10.3f} ms {count[name]:5d}x  {name}\n")
        f.write("\n" + table + "\n\nHost self time by operation:\n" + host)
    log(f"[profile] {label} under torch.profiler: wall {wall * 1e3:.3f} ms, "
        f"device busy {total:.3f} ms ({100.0 * (1 - total / (wall * 1e3)):.1f} % idle) "
        f"[{card}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count[name]:4d}x  {name[:90]}")
    for e in sorted(averages, key=lambda e: -e.self_cpu_time_total)[:6]:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3:9.3f} ms self, "
            f"{e.count} calls  {e.key[:70]}")


SASS_KERNELS = ("vif_int_scale_kernel", "vif_scale_f32_kernel", "adm_int_level_kernel",
                "adm_level_f32_kernel")


def sass_report(build, out_dir):
    """cuobjdump -sass of the kernel library into ``out_dir``; prints each
    VIF scale and ADM level kernel's instruction count, its most frequent
    opcodes and the subroutines it calls (a 64-bit division would be one)."""
    import collections
    import re

    os.makedirs(out_dir, exist_ok=True)
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.BUILD_DIR / build.LIB_NAME)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    with open(os.path.join(out_dir, "libpqa2_kernels.sass"), "w") as f:
        f.write(sass)
    ops = collections.defaultdict(collections.Counter)
    code = collections.defaultdict(list)  # function -> [(address, opcode, operands)]
    fn = None
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn:
            m = insn.search(line)
            if m:
                ops[fn][m.group(2)] += 1
                code[fn].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    for fn, cnt in sorted(ops.items()):
        if not any(k in fn for k in SASS_KERNELS):
            continue
        top = ", ".join(f"{k} {v}" for k, v in cnt.most_common(14))
        log(f"[sass] {fn[:90]}: {sum(cnt.values())} instructions; {top}")
        # Each subroutine called, by the opcodes of its body (up to its RET):
        # a 64-bit integer division converts its 64-bit divisor (I2F.*64*).
        targets = collections.Counter(int(a, 16) for _, op, a in code[fn]
                                      if op.startswith("CALL") and a.startswith("0x"))
        divs = 0
        for addr, n in sorted(targets.items()):
            body = []
            for a, op, _ in code[fn]:
                if a >= addr:
                    body.append(op)
                    if op.startswith("RET"):
                        break
            div64 = any(op.startswith("I2F") and "64" in op for op in body)
            divs += div64
            log(f"[sass]   calls {hex(addr)} x{n}"
                f"{' (64-bit integer division)' if div64 else ''}: {len(body)} instructions, "
                + ", ".join(f"{k} {v}" for k, v in collections.Counter(body).most_common(6)))
        log(f"[sass]   subroutines: {len(targets)}; 64-bit integer division routines: {divs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one warm run of each slice; tables go to DIR")
    ap.add_argument("--sass", metavar="DIR", default=None,
                    help="also write the library's SASS to DIR and print the opcode "
                         "counts of the VIF scale and ADM level kernels")
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {line.strip()}")

    if args.sass:
        sass_report(_build, args.sass)

    results = {k: {"name": k, "route": "cuda", "source": src, "replaces": rep,
                   "launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
                   "bound_ms": None, "bound_by": None, "library_ms": None}
               for k, (src, rep) in KERNELS.items()}
    phase_slice(torch, device, results, card, args.profile)
    torch.cuda.empty_cache()
    ref, dist = phase_kernels(torch, device, results)
    phase_times(torch, device, results, ref, dist, card, args.profile)
    log(card)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
