#!/usr/bin/env python3
"""Smoke run of pqa2_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                  # needs one sm_90 card
    python3 chip_smoke.py --profile DIR    # plus torch.profiler passes
    python3 chip_smoke.py --sass DIR       # plus the VIF, ADM and motion kernels' SASS opcodes

Phases, run in the order 1, 3, 2, 4 so that the slices run in a process
that has done nothing else yet, as a user's does (each prints its lines;
any failure raises and the exit code is 1):

  1. the card (nvidia-smi name and power limit), torch's CUDA version, and
     the nvcc build of ``pqa2_tpu_torch/csrc`` (one nvcc per source, all
     started together; its time when it built), then the g++ build of the
     native frame pump (``csrc/framepump.cpp``), which every later phase's
     y4m reads go through;
  2. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes: a 34-frame 1080p luma chunk (32 core frames and
     both halos; integer VIF on the uint8 luma as the main path hands it
     over and on int32 codes) and 960x540 chroma, plus one 3840x2160 and
     one 4096x4096 pair for VIF and ADM. Integer outputs must be equal;
     SSIM within 1e-6; the log2 audit's uncached launch 0 mismatches, and
     exactly 1 against one deliberately wrong expected value. The float
     kernels (VIF with the classic statistic, gain inf and 1.0; ADM, gain
     100 and 1.0; the motion SAD) on the 1080p chunk and a 3840x2160 pair
     (ADM also on a 4096x4096 one): decimated and approximation planes
     equal in every bit, per-frame sums within 1e-5 relative, features
     within 1e-5, and a second launch on the same input gives the same
     bits. The motion SAD also alone on the 1080p chunk, on 1, 2 and
     RUN + 1 frames (a run of frames split across blocks), on 3840x2160
     and on an odd width: frame 0 exactly 0, the rest within 1e-5
     relative, a second launch the same bits. Both VIF kernels also on
     edge frames at 1080p and 3840x2160 (all-peak against all-0 and the reverse, 0/peak
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
     just after; the first integer run must audit the log2 lookup once,
     as the first integer clip of a process does; the float run must launch
     kernels 5-7 and none of kernels 1-3, the integer_fast run kernel 1f
     and neither kernel 1 nor the log2 audit), frames 0 and 32 against the
     port's numpy oracles
     (``pqa2_tpu_torch.golden``), and the integer_fast features within 1e-3
     of the integer run's. Then the in-memory path: the same pair decoded
     once, through ``VMAFAnalyzer.analyze_frames`` with ``vmaf_v0.6.1``
     and PSNR+SSIM, must give the integer run's features, VMAF, PSNR and
     SSIM in every bit, with no log2 audit (the process has passed one).
     Then the decode-once align-and-score workflow
     (``run_combined_workflow(device="cuda")``) on a 1920x1080 pair: a
     150-frame reference and a 350-frame capture (dark lead-in, white
     bookends around two distorted loops of the reference, a dark tail).
     Its alignment dict must equal ``align_bookend_clips(device="cpu")``'s
     on the same decoded luma, its aligned window must pair each captured
     frame with the reference frame it was made from, its per-frame values
     must equal ``analyze_frames``' on that window in every bit, with the
     launches of the in-memory path; the two-pass path
     (``max_in_memory_bytes=0``) must give the same alignment and the same
     bits; the card's statistics pass must give the CPU's histograms and
     means, stds and thumbnails within 1e-5; and on a capture rolled by
     (2, 6) (its loop the reference with noise only), motion compensation
     must estimate (-2, -6) on every frame on the card and the CPU alike.
     Its wall seconds (a first run and two warm runs), the statistics
     pass's ms per 64-frame chunk, the phase correlation's ms per 32 frames
     and the shifts it estimates on the blurred loops rolled by (2, 6) are
     printed.
     Then the desktop window (the gui phase): tests/test_torch_gui.py's
     driver in a child interpreter under the PyQt5 stub
     (tests/support/qt_stub.py) builds ``MainWindow`` through
     ``pqa2_tpu_torch.main.main(["--device", "cuda"])``, analyses the
     workflow pair's reference in the Setup tab, hands the capture over,
     runs the Analysis tab with ``vmaf_v0.6.1`` over the whole clip and
     checks the Results tab's display, exports and history: its alignment
     and every per-frame value must equal the workflow phase's in every
     bit, and its launches must be the workflow's plus the one log2 audit
     of a fresh process; ``python -m pqa2_tpu_torch.main`` without PyQt5
     must exit 2 with the CLI pointer and log ``cuda_devices: True``.
     Then the trace (``tpu.profile_dir``): ``analyze_videos`` on the slice
     pair with the setting writes one torch.profiler trace holding the
     ``vmaf_score`` range and the integer VIF, integer ADM and SSIM
     kernels, its scores the slice run's in every bit, and the same call
     without the setting writes none; both runs' seconds are printed.
     Then the scoring service (``ScoringService(device="cuda")`` with its
     warmup and an HTTP server on a free port): three jobs over HTTP on the
     slice pair (the default, ``vmaf_float_v0.6.1`` at
     ``precision: "float"`` and ``precision: "integer_fast"``) must finish
     with JSON logs equal in every value to the slice runs' and with the
     slice runs' launches (counted per job on the worker thread; the
     integer job audits nothing), while GET /healthz, /models and /jobs
     answer 200, a malformed spec 400, an unknown job 404 and a queued
     fourth job is cancelled with 200; each job's seconds are printed
     beside a direct ``analyze_videos`` of the same pair; then the
     ``serve --warmup`` subcommand in a fresh process (its worker loads
     the library and audits the log2 table) scores one job, equal to the
     slice run, and exits 0 on SIGINT. Then the batch suite
     (``run_batch_suite(device="cuda")``) on three rungs of the slice
     reference: the slice's distorted clip (its VMAF must equal the slice
     run's in every bit), a stronger distortion and the reference itself,
     with a report and a CSV per rung and three integer jobs' launches.
     Then the capture chain: ``CaptureManager`` with
     ``FilePlaybackBackend(noise_sigma=2.0)`` plays a 60-frame 960x540
     reference between white bookends (its frame count and duration
     policy printed) and ``run_combined_workflow(device="cuda")`` must
     align the capture as ``BookendAligner(device="cpu")`` does and score
     it to finite values; the colorspace conversions on the card must give
     the CPU's bits.
     Then multi-device scoring (the parallel phase), on meshes whose
     entries share cuda:0: ``score_clip_sharded`` on 4 and 5 entries (the
     5-entry ranges 15/15/14/14/14) for each of the three families must give
     the slice runs' per-frame features and VMAF in every bit, each run's
     launches the feature kernels' per chunk times its chunks and nothing
     else; ``make_sharded_scorer`` on a 2x2 mesh with PSNR/SSIM must give
     the integer slice's psnr_y and ssim_y in every bit; a 10-bit
     1920x1080 pair of 24 frames (the slice's codes x 4 with +-1 noise)
     through ``score_clip_sharded`` must equal single-device ``score_clip``
     in every bit; the batch phase's three rungs through
     ``run_batch_suite(mesh=)`` on 4 entries must have no error row, give
     each rung's per-frame JSON values without a mesh, and decode the
     reference once (3 decodes, 3 luma cache hits); ``python -m
     pqa2_tpu_torch.cli dryrun --devices 4`` in a child must exit 0 with its
     equality line; ``multihost.initialize()`` from ``MASTER_ADDR``/
     ``MASTER_PORT`` joins an NCCL group of one (an all_reduce,
     ``gather_summaries``, ``shard_clip_list``, ``destroy_process_group``);
     ``pipeline.streaming._open_reader`` must give the native frame pump's
     reader, whose frames equal ``VideoReader``'s byte for byte on both
     slice files, and ``write_trim`` through the native writer must write
     the Python writer's bytes. Each sharded run's seconds are printed
     beside the single-device run's, and the phase's total.
     Then the 4K and high-bit-depth configurations (the depth phase), each
     through ``analyze_videos`` from y4m files with PSNR+SSIM: a 36-frame
     8-bit 3840x2160 pair (chunks 32+4) with ``vmaf_4k_v0.6.1``,
     ``vmaf_4k_v0.6.1neg`` (kernels 1 and 3 at gain limit 1.0) and
     ``vmaf_float_4k_v0.6.1``, the same pair at 10 bits (C420p10: the 8-bit
     codes x 4 plus code noise in [0, 3]) with ``vmaf_4k_v0.6.1``, and an
     8-bit reference against a 10-bit distorted 1920x1080 clip of 34 frames
     with ``vmaf_v0.6.1``. Each run must launch each kernel as often as its
     chunks need (no log2 audit), write its JSON and txt logs (VMAF in
     (0, 100], the PSNR summary pooled at the native peak), give a warm run
     the same bits and give ``analyze_frames`` on the decoded frames (the
     mixed pair's reference promoted to 10-bit codes) its per-frame
     features, VMAF, PSNR and SSIM in every bit. Frames 0, 31, 32 and 35 of
     each 4K run are recomputed with the plain versions on the card
     (integer features equal in every bit, float ones within 1e-5); frame
     32 of the 10-bit run is held to the numpy oracles (VIF, ADM, motion,
     SSIM within 2e-6 at depth 10, PSNR at peak 1023) and kernel 4 at 10
     bits to its plain version. Each run's first and warm seconds and fps,
     its peak device memory and the process's peak RSS are printed (with
     --profile, its HtoD copies and bytes); the files are deleted after;
  4. CUDA-event times of each kernel against its plain version at 1080p
     and at 3840x2160 (32 core frames; kernel 1 also on 10-bit int32
     codes, with its launches per 36-frame 4K run), each kernel's bound
     (the least time the card could take for the same work), and each
     slice's frames per second: its first run and three warm runs. With
     --profile, torch.profiler over one more warm run of
     each slice, of the workflow and of one service job (device busy time,
     idle share, and the count and bytes of host-to-device copies) and over
     three scale-0 or level-0 calls of each VIF and ADM kernel (kernel 1f
     too).

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

    # The audit's uncached launch (the main path caches a passed audit).
    mism = cuda_vif_int._log2_audit_launch(device)
    if mism != 0:
        raise AssertionError(f"log2 audit: {mism} mismatches")
    want = cuda_vif_int._log2_expected(device).clone()
    want[32768 + 12345] += 1
    forced = cuda_vif_int._log2_audit_launch(device, want)
    if forced != 1:
        raise AssertionError(f"log2 audit counted {forced} mismatches against one wrong "
                             f"expected value, not 1")
    log(f"[kernels] log2 audit: {mism} mismatches of 32768 mantissas (x2 shifts), "
        f"compared on the card; {forced} against one wrong expected value")
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
    def motion_check(m, label):
        """Kernel 7 alone: frame 0 exactly 0, the rest within 1e-5 relative
        of the plain version, a second launch the same bits."""
        got = cuda_motion.motion_sad(m)
        sp = motion_sad_plain(m)
        check_bits(torch, f"motion_sad {label} (second launch)", got, cuda_motion.motion_sad(m))
        if got[0].item() != 0.0:
            raise AssertionError(f"motion_sad {label}: frame 0 is {got[0].item()}")
        rel = check_rel(torch, f"motion_sad {label}", got[1:], sp[1:], FLOAT_SUM_RTOL) \
            if len(got) > 1 else 0.0
        err["motion_sad"] = max(err["motion_sad"], (got - sp).abs().max().item())
        log(f"[kernels] motion_sad {label}: frame 0 exactly 0, max rel {rel:.3e}, "
            f"second launch bit-equal")

    run = cuda_motion.RUN
    motion_check(mf, "1080p 34 frames")
    for k in (1, 2, run + 1):
        motion_check(mf[:k], f"1080p {k} frame{'s' if k > 1 else ''}")
    motion_check(mf[:5, :, :1918].contiguous(), "1080x1918 5 frames (4-byte copies)")
    del rf, df, mf
    m4 = smooth_frames(torch, run + 1, 2160, 3840, 9, device).float()
    motion_check(m4, f"3840x2160 {run + 1} frames")
    del m4
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
    if name == "log2_table_audit":      # 32768 mantissas x 2 lookups and compares:
        # the table and the expected values read once, one int written
        return 32768 * 4 + 65536 * 4 + 4, 65536 * 14
    if name in ("adm_int_level", "adm_level"):  # level 0: DWT of 2 planes + pooling
        return 2 * p * 4 + 2 * b2 * 4 + n * 6 * 8, 2 * b2 * 96 + b2 * 110
    if name == "ssim_sse_plane":
        return 2 * p * 4 + n * 12, p * 13
    if name == "vif_scale":             # scale 0 (17 taps) + next scale's 9 taps
        return 2 * p * 4 + 2 * b2 * 4 + n * 8, p * (20 * 17 + 28) + dec9
    if name == "motion_sad":            # every frame blurred once, n-1 differences
        return p * 4 + n * 4, p * blur5 + (n - 1) * h * w * 3
    raise KeyError(name)


def kernel_cases(torch, device, ref, dist, codes_depth=8):
    """Each kernel's timed call on one chunk: ``ref``/``dist`` are n + 2
    frames of uint8 luma (32 core frames and both halos), the core frames a
    view of it as the main path hands them over. Returns name -> (kernel
    call, plain call, what, (bytes, operations)), plus two calls timed
    beside the rows: "vif_int_scale codes" (kernel 1 on int32 codes at
    ``codes_depth`` bits: the 8-bit field x 2^(depth-8) plus code noise)
    and "adm_int_level uint8" (kernel 3 on the chunk's uint8 luma)."""
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
    from pqa2_tpu_torch.ops.vif_int import vif_int_scale_plain

    m, (h, w) = ref.shape[0], ref.shape[1:]
    n = m - 2
    r, d = ref[1:n + 1], dist[1:n + 1]
    kw = dict(scale=0, in_q=0, gain_limit=float("inf"), decimate=True, motion_ref=ref)
    s = 1 << (codes_depth - 8)
    g = torch.Generator(device=device).manual_seed(33)

    def codes(x):
        return x.to(torch.int32) * s + torch.randint(0, s, x.shape, generator=g, device=device,
                                                     dtype=torch.int32)

    mi = codes(ref)
    ri, di = mi[1:n + 1], codes(d)
    kwi = dict(kw, in_q=codes_depth - 8, motion_ref=mi)
    # Integer ADM's row figure: int32 Q4 codes, as the parent took them;
    # the main path's uint8 call is timed beside it.
    ra, _ = level_input(r.to(torch.int32), 8)
    da, _ = level_input(d.to(torch.int32), 8)
    akw = dict(level=0, extra_row_shift=0, gain_limit=100.0)
    rl, dl, ml = r.float(), d.float(), ref.float()
    fkw = dict(scale=0, gain_limit=float("inf"), variant="classic", emit_next=True)
    vif = f"scale 0, {n} core frames + motion over {m}"
    return {
        "vif_int_scale": (lambda: cuda_vif_int.vif_int_scale(r, d, **kw),
                          lambda: vif_int_scale_plain(r, d, **kw),
                          f"{vif}, uint8", work("vif_int_scale", n, h, w, m=m)),
        "vif_int_scale_fast": (lambda: cuda_vif_int.vif_int_scale(r, d, exact=False, **kw),
                               lambda: vif_int_scale_plain(r, d, exact=False, **kw),
                               f"fast form, {vif}, uint8",
                               work("vif_int_scale_fast", n, h, w, m=m)),
        "log2_table_audit": (lambda: cuda_vif_int._log2_audit_launch(device),
                             lambda: cuda_vif_int._audit_mismatches_plain(device),
                             "32768 mantissas x 2, the uncached launch, one int copied back",
                             work("log2_table_audit", 0, 0, 0)),
        "adm_int_level": (lambda: cuda_adm_int.adm_int_level(ra, da, **akw),
                          lambda: adm_level_plain(ra, da, **akw),
                          f"level 0, {n} frames, int32 Q4 codes",
                          work("adm_int_level", n, h, w)),
        "ssim_sse_plane": (lambda: cuda_ssim.ssim_sse_plane(rl, dl, 8),
                           lambda: ssim_sse_plane_plain(rl, dl, 8),
                           f"{n} frames, luma", work("ssim_sse_plane", n, h, w)),
        "vif_scale": (lambda: cuda_vif.vif_scale(rl, dl, **fkw),
                      lambda: vif_scale_plain(rl, dl, **fkw),
                      f"scale 0 classic + next scale's planes, {n} frames",
                      work("vif_scale", n, h, w)),
        "adm_level": (lambda: cuda_adm.adm_level(rl, dl, level=0, gain_limit=100.0),
                      lambda: adm_level_plain_float(rl, dl, level=0, gain_limit=100.0),
                      f"level 0, {n} frames", work("adm_level", n, h, w)),
        "motion_sad": (lambda: cuda_motion.motion_sad(ml),
                       lambda: motion_sad_plain(ml),
                       f"{m} frames ({n} + both halos)", work("motion_sad", m, h, w)),
        "vif_int_scale codes": (lambda: cuda_vif_int.vif_int_scale(ri, di, **kwi),
                                lambda: vif_int_scale_plain(ri, di, **kwi),
                                f"{vif}, {codes_depth}-bit int32 codes",
                                work("vif_int_scale", n, h, w, m=m)),
        "adm_int_level uint8": (lambda: cuda_adm_int.adm_int_level(r, d, **akw),
                                lambda: adm_level_plain(r, d, **akw),
                                f"level 0, {n} frames, the chunk's uint8 luma as the main "
                                f"path hands it over", work("adm_int_level", n, h, w)),
    }


def phase_times(torch, device, results, ref, dist, card, profile_dir=None):
    """Phase 4a: each kernel against its plain version at 1080p, CUDA events,
    and its bound."""
    cases = kernel_cases(torch, device, ref, dist)
    for name in KERNELS:
        kern, plain, what, (nbytes, nops) = cases[name]
        k_ms = time_call(torch, kern, 10)
        p_ms = time_call(torch, plain, 3)
        b_ms, by = bound(nbytes, nops)
        results[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        log(f"[times] {name} ({what}, 1080p): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops) "
            f"[{card}]")
    for name in ("vif_int_scale codes", "adm_int_level uint8"):
        kern, _, what, _ = cases[name]
        log(f"[times] {name.split()[0]} (the same call, {what}): kernel "
            f"{time_call(torch, kern, 10):.3f} ms [{card}]")
    if profile_dir:
        for name in ("vif_int_scale", "vif_int_scale_fast", "vif_scale", "adm_int_level",
                     "adm_level"):
            fn = cases[name][0]
            profile_run(torch, lambda: [fn() for _ in range(3)], profile_dir, card,
                        f"{name}_3_calls")


def phase_times_4k(torch, device, card, launches, n=32, h=2160, w=3840):
    """Phase 4a at the 4K runs' chunk shape: each kernel at 3840x2160 (scale
    0 or level 0, 32 core frames, 8-bit luma; kernel 1 also on 10-bit int32
    codes) against its plain version, CUDA events, the bound from ``work``
    for the same shape, and its launches over one 36-frame 4K run of the
    depth phase (``launches``: family -> counts). One JSON line holds the
    table."""
    ref = smooth_frames(torch, n + 2, h, w, 31, device)
    dist = distort(torch, ref, 32)
    cases = kernel_cases(torch, device, ref, dist, codes_depth=10)
    del cases["log2_table_audit"], cases["adm_int_level uint8"]  # no frame shape; 1080p's
    family = {"vif_int_scale": "integer", "vif_int_scale codes": "integer",
              "adm_int_level": "integer", "ssim_sse_plane": "integer", "vif_scale": "float",
              "adm_level": "float", "motion_sad": "float"}
    table = []
    for name, (kern, plain, what, (nbytes, nops)) in cases.items():
        k_ms = time_call(torch, kern, 10)
        try:
            p_ms = time_call(torch, plain, 1)
        except torch.cuda.OutOfMemoryError:
            p_ms = None
        torch.cuda.empty_cache()
        b_ms, by = bound(nbytes, nops)
        runs = launches.get(family.get(name), {}).get(name.split()[0], 0)
        table.append({"name": name, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": by, "launches_per_4k_run": runs})
        log(f"[times] {name} at {w}x{h} ({what}): kernel {k_ms:.3f} ms, plain "
            + (f"{p_ms:.3f} ms" if p_ms is not None else "not measured (out of memory)")
            + f", bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops), "
            f"{runs} launches per 36-frame 4K run [{card}]")
    log(f"[times] kernels at {w}x{h} [{card}]: {json.dumps(table)}")


def write_pair(n, h, w, ref_path, dist_path, torch, device, depth=8, dist_depth=None):
    """Synthetic 4:2:0 y4m pair (pqa2_tpu_torch.io.y4m.write_y4m) -> (ref
    luma, dist luma) as the files hold them (uint8, or uint16 codes). Past
    8 bits a file's codes are the 8-bit field x 2^(depth-8) plus code noise
    in [0, 2^(depth-8)), written as C420p{depth}; ``dist_depth`` gives the
    distorted file a depth of its own."""
    import numpy as np

    from pqa2_tpu_torch.io.y4m import write_y4m

    ref = smooth_frames(torch, n, h, w, 11, device)
    dist = distort(torch, ref, 12, radius=3, noise=16)
    noise = torch.Generator(device=device).manual_seed(13)

    def planes(y, bits):
        c = torch.nn.functional.avg_pool2d(y.float()[:, None], 2)[:, 0].round().to(torch.uint8)
        if bits == 8:
            return y.cpu().numpy(), c.cpu().numpy()
        s = 1 << (bits - 8)

        def deep(x):
            x = x.to(torch.int32) * s + torch.randint(0, s, x.shape, generator=noise,
                                                      device=device, dtype=torch.int32)
            return x.cpu().numpy().astype(np.uint16)

        return deep(y), deep(c)

    def write(path, y, c, bits):
        top = np.uint16(255 << (bits - 8)) if bits > 8 else np.uint8(255)
        write_y4m(path, [{"y": y[i], "u": c[i], "v": top - c[i]} for i in range(n)],
                  **({"colorspace": f"C420p{bits}"} if bits > 8 else {}))

    ry, rc = planes(ref, depth)
    dy, dc = planes(dist, depth if dist_depth is None else dist_depth)
    write(ref_path, ry, rc, depth)
    write(dist_path, dy, dc, depth if dist_depth is None else dist_depth)
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
    --profile, one more under torch.profiler). Returns their seconds."""
    fps, secs = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = analyzer.analyze_videos(ref_path, dist_path, model=model)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        fps.append(n / secs[-1])
        if res2 is None or abs(res2["vmaf_score"] - first[0]["vmaf_score"]) > 0:
            raise AssertionError(f"{label}: a warm run differs from the first")
    if profile_dir:
        profile_run(torch, lambda: analyzer.analyze_videos(ref_path, dist_path, model=model),
                    profile_dir, card, f"slice_{label}_warm_run")
    log(f"[times] slice 1080p {label}+PSNR+SSIM, {n} frames: first run "
        f"{first[1]:.3f} s ({n / first[1]:.2f} fps), warm runs "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f" fps (median {sorted(fps)[len(fps) // 2]:.2f}) [{card}]")
    return secs


def expect_counts(counts, label, want):
    """Raise unless each named kernel was launched ``want[name]`` times
    (None: at least once)."""
    for k, v in want.items():
        if (counts[k] <= 0) if v is None else (counts[k] != v):
            raise AssertionError(f"{label}: {k} launched {counts[k]} times, expected "
                                 f"{'at least once' if v is None else v}: {counts}")


def slice_record(res, counts):
    """What the later phases hold a slice run's family to: its JSON log
    (frames and pooled metrics), pooled VMAF and launch counts (read just
    after the run), and later its warm runs' seconds."""
    with open(res["json_path"]) as f:
        log_json = json.load(f)
    return {"frames": log_json["frames"], "pooled": log_json["pooled_metrics"],
            "vmaf_score": res["vmaf_score"], "counts": counts}


def phase_slice(torch, device, results, card, profile_dir=None):
    """Phase 3 (+ 4b): the three main paths and the in-memory path end to
    end, with the oracle and cross-path checks. Returns the pair's paths and
    each family's ``slice_record``."""
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
    slices = {"integer": slice_record(first[0], counts)}
    expect_counts(counts, model, {k: None for k in (*INTEGER_KERNELS, "ssim_sse_plane")})
    expect_counts(counts, model, {k: 0 for k in (*FLOAT_KERNELS, *FAST_KERNELS)})
    # The process's first integer clip audits the log2 lookup, once.
    expect_counts(counts, model, {"log2_table_audit": 1})
    for k in (*INTEGER_KERNELS, "ssim_sse_plane"):
        results[k]["launches"] = counts[k]
    int_scores = exact.last_scores
    slices["integer"]["scores"] = int_scores

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
    slices["integer"]["warm"] = warm_runs(torch, exact, ref_path, dist_path, model, first, n,
                                          card, profile_dir, model)

    # The float family: vmaf_float_v0.6.1 runs kernels 4-7 and none of 1-3.
    model = "vmaf_float_v0.6.1"
    flt = analyzer("smoke")
    first = run_slice(torch, flt, ref_path, dist_path, model, n, model)
    counts = first[2]
    slices["float"] = slice_record(first[0], counts)
    expect_counts(counts, model, {k: None for k in (*FLOAT_KERNELS, "ssim_sse_plane")})
    expect_counts(counts, model, {k: 0 for k in (*INTEGER_KERNELS, *FAST_KERNELS)})
    for k in FLOAT_KERNELS:
        results[k]["launches"] = counts[k]
    slices["float"]["scores"] = flt.last_scores
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
    slices["float"]["warm"] = warm_runs(torch, flt, ref_path, dist_path, model, first, n, card,
                                        profile_dir, model)

    # integer_fast: vmaf_v0.6.1 with VIF's smooth-log statistic runs kernel
    # 1f in place of kernel 1, and no log2 table audit.
    model, label = "vmaf_v0.6.1", "vmaf_v0.6.1 integer_fast"
    fast = analyzer("smoke_fast", "integer_fast")
    first = run_slice(torch, fast, ref_path, dist_path, model, n, label)
    counts = first[2]
    slices["integer_fast"] = slice_record(first[0], counts)
    expect_counts(counts, label, {"vif_int_scale_fast": 12, "vif_int_scale": 0,
                                  "log2_table_audit": 0, "adm_int_level": 12,
                                  "ssim_sse_plane": None})
    expect_counts(counts, label, {k: 0 for k in FLOAT_KERNELS})
    results["vif_int_scale_fast"]["launches"] = counts["vif_int_scale_fast"]
    fs = fast.last_scores
    slices["integer_fast"]["scores"] = fs
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
    slices["integer_fast"]["warm"] = warm_runs(torch, fast, ref_path, dist_path, model, first,
                                               n, card, profile_dir, "vmaf_v0.6.1_integer_fast")

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
    expect_counts(counts, label, {"vif_int_scale": 12, "log2_table_audit": 0,
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
    return ref_path, dist_path, slices


WORKFLOW_REF_FRAMES = 150  # 5 s at 30 fps
WORKFLOW_TOL = 1e-5       # card vs CPU statistics: means, stds, thumbnails


def workflow_content(torch, n, h, w, device):
    """(n, h, w) uint8 reference luma: a new smooth field every 3 frames,
    moving within it, so the thumbnails' cross-correlation resolves a shift
    of one frame."""
    return torch.cat([smooth_frames(torch, 3, h, w, 100 + g, device)
                      for g in range(-(-n // 3))])[:n]


def write_bookend_capture(torch, path, loops, h, w, shift=None):
    """Capture y4m: 10 dark lead-in frames, then for each loop in ``loops``
    a 10-frame white bookend (luma 235) and the loop's frames, a closing
    bookend and a 10-frame dark tail. With ``shift`` (dy, dx) the loops'
    luma is rolled by it and their chroma by half of it. Returns, for each
    captured frame, the index of the loop frame it was made from (-1 for
    the rest)."""
    import numpy as np

    from pqa2_tpu_torch.io.y4m import Y4MHeader, Y4MWriter

    ch, cw = h // 2, w // 2
    dark = {"y": np.full((h, w), 16, np.uint8), "u": np.full((ch, cw), 128, np.uint8),
            "v": np.full((ch, cw), 128, np.uint8)}
    white = dict(dark, y=np.full((h, w), 235, np.uint8))
    source = []
    with Y4MWriter(path, Y4MHeader(width=w, height=h, fps_num=30, fps_den=1,
                                   colorspace="C420mpeg2")) as wr:
        def put(frame, src):
            wr.write_frame(frame)
            source.append(src)

        for _ in range(10):
            put(dark, -1)
        for loop in loops:
            for _ in range(10):
                put(white, -1)
            c = torch.nn.functional.avg_pool2d(loop.float()[:, None], 2)[:, 0].round()
            c = c.to(torch.uint8)
            y = loop
            if shift is not None:
                y = torch.roll(y, shift, dims=(1, 2))
                c = torch.roll(c, (shift[0] // 2, shift[1] // 2), dims=(1, 2))
            y, c = y.cpu().numpy(), c.cpu().numpy()
            for i in range(len(y)):
                put({"y": y[i], "u": c[i], "v": 255 - c[i]}, i)
        for _ in range(10):
            put(white, -1)
        for _ in range(10):
            put(dark, -1)
    return np.array(source)


def decode(path):
    """Every frame of a video file as planar dicts (VideoReader)."""
    from pqa2_tpu_torch.io.video import VideoReader

    r = VideoReader(path)
    try:
        return list(r)
    finally:
        r.close()


def alignment_of(result, motion_compensated=False):
    """The workflow's alignment dict (aligned paths aside) for an
    ``AlignmentResult``, as run_combined_workflow builds it."""
    import dataclasses

    return {"alignment_method": result.alignment_method,
            "offset_frames": result.offset_frames,
            "offset_seconds": result.offset_seconds,
            "confidence": result.confidence,
            "bookend_info": {
                "first_bookend": dataclasses.asdict(result.bookends[0]),
                "last_bookend": dataclasses.asdict(result.bookends[-1]),
                "content_duration": result.content_duration,
                "motion_compensated": motion_compensated},
            "ref_range": list(result.ref_range), "cap_range": list(result.cap_range),
            "is_fallback": result.is_fallback}


def without_paths(alignment):
    return {k: v for k, v in alignment.items()
            if k not in ("aligned_reference", "aligned_captured")}


def per_frame(scores):
    """name -> per-frame array of a ClipScores: features, VMAF, PSNR, SSIM."""
    out = {f"feature {k}": v for k, v in scores.features.items()}
    out["vmaf"] = scores.vmaf
    out.update(scores.psnr)
    out.update(scores.ssim)
    return out


def check_same_bits(label, got, want):
    import numpy as np

    if got.keys() != want.keys():
        raise AssertionError(f"{label}: arrays {sorted(got)} != {sorted(want)}")
    for k in want:
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: {k} differs")
    return len(want)


def phase_workflow(torch, device, card, profile_dir=None, h=1080, w=1920,
                   n_ref=WORKFLOW_REF_FRAMES):
    """Phase 3, the decode-once workflow: run_combined_workflow on the card
    against the CPU's alignment, analyze_frames on the chosen window and the
    two-pass path; the statistics pass and the phase correlation against
    the CPU's; motion compensation on a rolled capture. Returns what the
    gui phase is held to: the pair's paths, the alignment (paths aside),
    the per-frame arrays, the launches and the warm runs' seconds."""
    import numpy as np

    from pqa2_tpu_torch.align.motioncomp import _phase_corr_surface, estimate_shifts
    from pqa2_tpu_torch.align.stats import _stats_thumb_chunk, stats_and_thumbs
    from pqa2_tpu_torch.align.temporal import align_bookend_clips
    from pqa2_tpu_torch.app.bookend_aligner import BookendAligner
    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.app.workflow import run_combined_workflow
    from pqa2_tpu_torch.io.y4m import write_y4m
    from pqa2_tpu_torch.pipeline.scoring import upload

    wdir = os.path.join(WORK_DIR, "workflow")
    os.makedirs(wdir, exist_ok=True)
    ref_path = os.path.join(wdir, "ref.y4m")
    cap_path = os.path.join(wdir, "cap.y4m")
    mc_path = os.path.join(wdir, "cap_rolled.y4m")
    ref = workflow_content(torch, n_ref, h, w, device)
    loop = distort(torch, ref, 21, radius=3, noise=16)
    c = torch.nn.functional.avg_pool2d(ref.float()[:, None], 2)[:, 0].round().to(torch.uint8)
    ry, rc = ref.cpu().numpy(), c.cpu().numpy()
    write_y4m(ref_path, [{"y": ry[i], "u": rc[i], "v": 255 - rc[i]} for i in range(n_ref)])
    source = write_bookend_capture(torch, cap_path, (loop, loop), h, w)
    # The rolled capture: a capture chain's constant misregistration, the
    # reference's content with noise only (tests/test_app.py's case).
    mc_source = write_bookend_capture(torch, mc_path, (distort(torch, ref, 22, 0, 8),), h, w,
                                      shift=(2, 6))
    del c
    log(f"[workflow] wrote a {n_ref}-frame {w}x{h} reference and a {len(source)}-frame "
        f"capture (two loops, each a 7x7 box blur plus noise in [-16, 16]); and a "
        f"{len(mc_source)}-frame one with one loop, noise in [-8, 8], rolled by (2, 6)")

    def options(name, motion_compensation):
        om = OptionsManager(settings_file=os.path.join(wdir, f"{name}.json"),
                            save_debounce_s=0)
        om.update_setting("bookend", "frame_offset", 0)
        om.update_setting("bookend", "motion_compensation", motion_compensation)
        return om

    om = options("settings", False)

    def workflow(cap, om=om, **kw):
        a = VMAFAnalyzer(device=device)
        a.set_output_directory(os.path.join(wdir, "out"))
        out = run_combined_workflow(ref_path, cap, options_manager=om,
                                    aligner=BookendAligner(om, device=device), analyzer=a,
                                    device=device, **kw)
        if out is None:
            raise AssertionError(f"run_combined_workflow({cap}, {kw}) failed")
        return out, a.last_scores

    (res, scores), secs, counts = counted(torch, lambda: workflow(cap_path))
    log(f"[workflow] decode once, {len(source)} + {n_ref} frames: launches {counts}")

    # 1. The alignment the CPU's plain statistics give on the same decoded luma.
    ref_planes, cap_planes = decode(ref_path), decode(cap_path)
    ref_luma = np.stack([f["y"] for f in ref_planes])
    cap_luma = np.stack([f["y"] for f in cap_planes])
    cpu = align_bookend_clips(ref_luma, cap_luma, fps=30.0,
                              config=BookendAligner(om, device="cpu")._config(), device="cpu")
    if without_paths(res["alignment"]) != alignment_of(cpu):
        raise AssertionError(f"workflow alignment {res['alignment']} != the CPU's "
                             f"{alignment_of(cpu)}")
    r0, r1 = res["alignment"]["ref_range"]
    c0, c1 = res["alignment"]["cap_range"]
    log(f"[workflow] alignment equal to align_bookend_clips(device='cpu') in every field: "
        f"ref {r0}..{r1}, capture {c0}..{c1}, confidence {cpu.confidence:.6f}, "
        f"bookends {[(b.start_frame, b.end_frame) for b in cpu.bookends]}")
    # 2. Each captured frame of the window against the frame it was made from.
    if not np.array_equal(source[c0:c1], np.arange(r0, r1)):
        raise AssertionError(f"the window pairs capture {c0}..{c1} (made from reference "
                             f"frames {source[c0]}..{source[c1 - 1]}) with reference "
                             f"{r0}..{r1}")
    log(f"[workflow] every captured frame of the window is paired with the reference "
        f"frame it was made from ({c1 - c0} frames)")
    # 3. The same bits as analyze_frames on that window, decoded once more.
    mem = VMAFAnalyzer(device=device)
    mem.set_output_directory(os.path.join(wdir, "out_frames"))
    if mem.analyze_frames(ref_planes[r0:r1], cap_planes[c0:c1], model="vmaf_v0.6.1") is None:
        raise AssertionError("analyze_frames on the aligned window failed")
    k = check_same_bits("workflow vs analyze_frames", per_frame(scores),
                        per_frame(mem.last_scores))
    n = c1 - c0
    vmaf = scores.vmaf
    log(f"[workflow] {k} per-frame arrays (features, VMAF, PSNR, SSIM) equal to "
        f"analyze_frames' on the window in every bit; vmaf {res['analysis']['vmaf_score']:.4f} "
        f"(per frame {vmaf.min():.3f}..{vmaf.max():.3f}), psnr "
        f"{res['analysis']['psnr_score']:.4f} dB, ssim {res['analysis']['ssim_score']:.6f}")
    if not (np.all(np.isfinite(vmaf)) and 5.0 < vmaf.min() and vmaf.max() < 99.0):
        raise AssertionError(f"workflow VMAF {vmaf.min()}..{vmaf.max()}")
    # 4. The launches of the in-memory path: 4 VIF scales and 4 ADM levels,
    # 3 SSIM planes per 32-frame chunk, no audit (the process passed one).
    chunks = -(-n // 32)
    expect_counts(counts, "workflow", {"vif_int_scale": 4 * chunks, "log2_table_audit": 0,
                                       "adm_int_level": 4 * chunks,
                                       "ssim_sse_plane": 3 * chunks})
    expect_counts(counts, "workflow", {k: 0 for k in (*FLOAT_KERNELS, *FAST_KERNELS)})
    del ref_planes, cap_planes
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        again, again_scores = workflow(cap_path)
        warm.append(time.perf_counter() - t0)
        if again["alignment"] != res["alignment"] or \
                not np.array_equal(again_scores.vmaf, scores.vmaf):
            raise AssertionError("a warm workflow run differs from the first")
    log(f"[times] workflow {w}x{h} ({len(source)}-frame capture, {n_ref}-frame reference, "
        f"{n} frames scored with PSNR+SSIM): first run {secs:.3f} s, warm runs "
        + ", ".join(f"{t:.3f}" for t in warm) + f" s [{card}]")
    record = {"ref": ref_path, "cap": cap_path, "alignment": without_paths(res["alignment"]),
              "per_frame": per_frame(scores), "counts": counts, "warm": warm}
    if profile_dir:
        profile_run(torch, lambda: workflow(cap_path), profile_dir, card, "workflow_warm_run")

    # 5. The two-pass path: streamed alignment, trims, the streaming analyzer.
    t0 = time.perf_counter()
    two, two_scores = workflow(cap_path, max_in_memory_bytes=0)
    two_secs = time.perf_counter() - t0
    if without_paths(two["alignment"]) != without_paths(res["alignment"]):
        raise AssertionError(f"two-pass alignment {two['alignment']} != {res['alignment']}")
    k = check_same_bits("two-pass vs decode once", per_frame(two_scores), per_frame(scores))
    log(f"[workflow] two-pass (max_in_memory_bytes=0): the same alignment and {k} per-frame "
        f"arrays equal in every bit; {two_secs:.3f} s [{card}]")

    # 6. The statistics pass on the card against the CPU's, on the capture.
    cap_dev = upload(cap_luma, device)
    stats, thumbs = stats_and_thumbs(cap_dev, device=device)
    cpu_stats, cpu_thumbs = stats_and_thumbs(cap_luma, device="cpu")
    if not np.array_equal(stats["hist"], cpu_stats["hist"]):
        raise AssertionError("card histograms != the CPU's")
    worst = {}
    for name, a, b in (("mean", stats["mean"], cpu_stats["mean"]),
                       ("std", stats["std"], cpu_stats["std"]), ("thumbnails", thumbs, cpu_thumbs)):
        rel = float(np.max(np.abs(a.astype(np.float64) - b) / np.maximum(np.abs(b), 1e-30)))
        if not rel <= WORKFLOW_TOL:
            raise AssertionError(f"card {name} differ from the CPU's by {rel:.3e} relative")
        worst[name] = f"{rel:.3e}" + (" (equal)" if np.array_equal(a, b) else "")
    log(f"[workflow] statistics pass on the card vs the CPU over {len(cap_luma)} frames: "
        f"histograms equal; largest relative difference {worst}")
    chunk = cap_dev[:64]
    stats_ms = time_call(torch, lambda: _stats_thumb_chunk(chunk), 10)
    pair = (cap_dev[c0:c0 + 32], upload(ref_luma[:32], device))
    corr_ms = time_call(torch, lambda: _phase_corr_surface(*pair).flatten(1).argmax(dim=1), 10)
    log(f"[times] statistics pass {stats_ms:.3f} ms per 64-frame chunk of {w}x{h} uint8; "
        f"phase correlation {corr_ms:.3f} ms per 32 frame pairs [{card}]")
    del cap_dev, chunk, pair, cap_luma

    # 7. Motion compensation on the rolled capture.
    mc, mc_scores = workflow(mc_path, om=options("settings_mc", True))
    info = mc["alignment"]
    m0, m1 = info["cap_range"]
    q0, q1 = info["ref_range"]
    if not info["bookend_info"]["motion_compensated"]:
        raise AssertionError("motion compensation was not reported")
    if not np.array_equal(mc_source[m0:m1], np.arange(q0, q1)):
        raise AssertionError(f"rolled capture: window {m0}..{m1} is not paired with "
                             f"reference {q0}..{q1}")
    mc_luma = np.stack([f["y"] for f in decode(mc_path)[m0:m1]])
    ref_win = ref_luma[q0:q1]
    card_shifts = estimate_shifts(upload(ref_win, device), upload(mc_luma, device),
                                  device=device)
    cpu_shifts = estimate_shifts(ref_win, mc_luma, device="cpu")
    if not np.array_equal(card_shifts, cpu_shifts):
        raise AssertionError("card shifts != the CPU's")
    if not np.all(card_shifts == np.array([-2, -6])):
        raise AssertionError(f"shifts {np.unique(card_shifts, axis=0)}, expected (-2, -6)")
    log(f"[workflow] motion compensation: estimate_shifts (-2, -6) on all {m1 - m0} frames "
        f"on the card and the CPU alike; the workflow reports motion_compensated: true, "
        f"vmaf {mc['analysis']['vmaf_score']:.4f} (per frame {mc_scores.vmaf.min():.3f}.."
        f"{mc_scores.vmaf.max():.3f})")
    # Recorded, not checked: the same estimate on the blurred loops, rolled.
    est = estimate_shifts(ref[q0:q1], torch.roll(loop[q0:q1], (2, 6), dims=(1, 2)),
                          device=device)
    other = np.any(est != np.array([-2, -6]), axis=1)
    values, counts = np.unique(est, axis=0, return_counts=True)
    log(f"[workflow] estimate_shifts on the 7x7-blurred loop rolled by (2, 6): "
        f"{int(other.sum())} of {len(est)} frames give another shift than (-2, -6) "
        f"(frames {np.flatnonzero(other).tolist()[:20]}); shifts and counts "
        f"{[(tuple(v), int(k)) for v, k in zip(values.tolist(), counts)]}")
    del ref, loop
    return record


GUI_DRIVER = os.path.join(HERE, "tests", "test_torch_gui.py")


def phase_gui(torch, card, workflow):
    """The desktop window on the card: tests/test_torch_gui.py's driver in a
    child interpreter under the PyQt5 stub (tests/support/qt_stub.py), so
    this process imports no PyQt5. It builds the window through
    ``pqa2_tpu_torch.main.main(["--device", "cuda"])``, analyses the
    workflow phase's reference in the Setup tab, hands its capture over and
    runs the Analysis tab with vmaf_v0.6.1 over the whole clip. Its
    alignment and every per-frame value must equal the workflow phase's
    ``run_combined_workflow(device="cuda")``, and its launches the
    workflow's plus the fresh process's one log2 audit. Then
    ``python -m pqa2_tpu_torch.main`` without the stub: exit 2 and the CLI
    pointer where PyQt5 is missing, and the card in its state checks."""
    import importlib.util

    import numpy as np

    gdir = os.path.join(WORK_DIR, "gui")
    os.makedirs(gdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=HERE, APPDATA=os.path.join(gdir, "appdata"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, GUI_DRIVER, "--device", "cuda", "--ref",
                          workflow["ref"], "--cap", workflow["cap"]], cwd=gdir, env=env,
                         capture_output=True, text=True, timeout=600)
    child_secs = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the window driver failed (rc={out.returncode}):\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-6000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if got["alignment"] != json.loads(json.dumps(workflow["alignment"])):
        raise AssertionError(f"window alignment {got['alignment']} != the workflow's "
                             f"{workflow['alignment']}")
    arrays = {k: np.array(v["values"], np.float64).astype(v["dtype"])
              for k, v in got["per_frame"].items()}
    k = check_same_bits("window vs run_combined_workflow", arrays, workflow["per_frame"])
    want = dict(workflow["counts"])
    want["log2_table_audit"] += 1  # the child is a fresh process: its first integer clip
    expect_counts(got["launches"], "window", want)
    log(f"[gui] MainWindow(device='cuda') through main(['--device', 'cuda']) under the PyQt5 "
        f"stub: alignment equal to the workflow phase's (ref {got['alignment']['ref_range']}, "
        f"capture {got['alignment']['cap_range']}); {k} per-frame arrays (features, VMAF, "
        f"PSNR, SSIM) over {got['frames']} frames equal to run_combined_workflow's in every "
        f"bit; Results tab shows {got['displayed']!r}; CSV, HTML, metadata and history "
        f"checked, PDF {'written' if got['pdf'] else 'skipped (no matplotlib)'}")
    log(f"[gui] launches in the Analysis run: {got['launches']} (the workflow phase's plus "
        f"the fresh process's log2 audit)")
    log(f"[times] gui: Setup tab reference analysis {got['setup_seconds']:.3f} s; Analysis "
        f"tab run (thread start to join) {got['analysis_seconds']:.3f} s, its workflow "
        f"{got['workflow_wall_seconds']:.3f} s, against the workflow phase's warm runs "
        + ", ".join(f"{t:.3f}" for t in workflow["warm"])
        + f" s; the child process {child_secs:.3f} s in all [{card}]")

    if importlib.util.find_spec("PyQt5") is not None:
        log("[gui] PyQt5 is installed here: the no-Qt entry point check does not apply")
        return
    mdir = os.path.join(WORK_DIR, "gui_main")
    os.makedirs(mdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=HERE, APPDATA=os.path.join(mdir, "appdata"))
    out = subprocess.run([sys.executable, "-m", "pqa2_tpu_torch.main"], cwd=mdir, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 2 or "python -m pqa2_tpu_torch.cli --help" not in out.stderr:
        raise AssertionError(f"python -m pqa2_tpu_torch.main without PyQt5: rc "
                             f"{out.returncode}, stderr {out.stderr[-2000:]}")
    with open(os.path.join(mdir, "appdata", "logs", "vmaf_app.log")) as f:
        checks = [line for line in f.read().splitlines() if "application state checks:" in line]
    if not checks or "'cuda_devices': True" not in checks[-1]:
        raise AssertionError(f"the state checks do not see the card: {checks}")
    log(f"[gui] python -m pqa2_tpu_torch.main without PyQt5: exit 2 with the CLI pointer; "
        f"logged {checks[-1].split(' - ')[-1]}")


def phase_trace(torch, card, ref_path, dist_path, slices):
    """F7: ``tpu.profile_dir`` makes ``analyze_videos`` write one
    torch.profiler trace of its scoring on the card (the ``vmaf_score``
    range and the integer VIF, integer ADM and SSIM kernels), with the
    slice run's scores in every bit; without it, no trace. Run outside any
    --profile pass (torch.profiler does not nest)."""
    import glob

    from pqa2_tpu_torch.app.options_manager import OptionsManager
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    tdir = os.path.join(WORK_DIR, "trace")
    again = os.path.join(WORK_DIR, "trace_again")
    for d in (tdir, again):
        for old in glob.glob(os.path.join(d, "*")):
            os.remove(old)
    secs = {}
    # The second traced run (into its own directory) parts the profiler's
    # one-time start in the process from its cost per run.
    for name, profile_dir in (("traced", tdir), ("untraced", ""), ("traced again", again)):
        tag = name.replace(" ", "_")
        om = OptionsManager(os.path.join(WORK_DIR, f"settings_{tag}.json"), save_debounce_s=0)
        om.update_setting("tpu", "profile_dir", profile_dir)
        a = VMAFAnalyzer(om, device="cuda")
        a.set_output_directory(os.path.join(WORK_DIR, "out"))
        a.set_test_name(f"trace_{tag}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = a.analyze_videos(ref_path, dist_path, model="vmaf_v0.6.1")
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if res is None:
            raise AssertionError(f"the {name} analyze_videos failed")
        k = check_same_bits(f"{name} run vs the slice run", per_frame(a.last_scores),
                            per_frame(slices["integer"]["scores"]))
        traces = glob.glob(os.path.join(tdir, "*"))
        written = glob.glob(os.path.join(WORK_DIR, "**", "*.pt.trace.json"), recursive=True)
        if len(traces) != 1 or not traces[0].endswith(".pt.trace.json") or \
                len(written) != 1 + (name == "traced again"):
            raise AssertionError(f"after the {name} run: {traces} in the trace directory, "
                                 f"{written} in all")
    with open(traces[0]) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    ranges = [e for e in events if e.get("name") == "vmaf_score"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {want: sum(want in n for n in kernels)
             for want in ("vif_int_scale_kernel", "adm_int_level_kernel", "ssim_sse_kernel")}
    if not ranges or not all(found.values()):
        raise AssertionError(f"trace {traces[0]}: {len(ranges)} vmaf_score ranges, "
                             f"kernel events {found}")
    log(f"[trace] tpu.profile_dir: one trace {os.path.basename(traces[0])} "
        f"({os.path.getsize(traces[0])} bytes) with the vmaf_score range and kernel events "
        f"{found} of {len(kernels)}; {k} per-frame arrays of the traced and the untraced run "
        f"equal to the slice run's in every bit; without the setting no trace was written")
    log(f"[times] trace: analyze_videos vmaf_v0.6.1 on the slice pair, traced "
        f"{secs['traced']:.3f} s (the process's first profiler), untraced "
        f"{secs['untraced']:.3f} s, traced again {secs['traced again']:.3f} s [{card}]")


def http_json(conn, method, path, body=None):
    """One request on an ``http.client`` connection -> (status, JSON body)."""
    conn.request(method, path, body=json.dumps(body) if body is not None else None)
    r = conn.getresponse()
    return r.status, json.loads(r.read() or b"{}")


def wait_job(conn, job_id, timeout=600.0):
    """Poll ``GET /jobs/<id>`` until the job has finished -> its dict."""
    deadline = time.time() + timeout
    while True:
        code, job = http_json(conn, "GET", f"/jobs/{job_id}")
        if code != 200:
            raise AssertionError(f"GET /jobs/{job_id}: {code} {job}")
        if job["status"] not in ("queued", "running"):
            return job
        if time.time() > deadline:
            raise AssertionError(f"job {job_id} still {job['status']} after {timeout} s")
        time.sleep(0.05)


def check_job_log(label, job, want):
    """A finished job's JSON log against a slice run's: every per-frame
    value and pooled metric equal."""
    if job["status"] != "done":
        raise AssertionError(f"{label}: job {job['job_id']} {job['status']}: {job.get('error')}")
    with open(job["result"]["json_path"]) as f:
        got = json.load(f)
    if got["frames"] != want["frames"] or got["pooled_metrics"] != want["pooled"]:
        raise AssertionError(f"{label}: the job's JSON log differs from the slice run's")
    return len(got["frames"])


def stdout_lines(proc):
    """A queue that one thread fills with ``proc``'s stdout lines."""
    import queue
    import threading

    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in iter(proc.stdout.readline, "")],
                     daemon=True).start()
    return lines


def read_line(lines, proc, pattern, timeout):
    """The next line from ``lines`` (``stdout_lines(proc)``) that matches
    ``pattern`` (a regular expression) within ``timeout`` seconds -> its
    match."""
    import queue
    import re

    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            line = lines.get(timeout=max(deadline - time.time(), 0.01))
        except queue.Empty:
            break
        log(f"[serve cli] {line.rstrip()}")
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no line matching {pattern!r} within {timeout} s "
                         f"(exit code {proc.poll()})")


def phase_serve(torch, device, card, ref_path, dist_path, slices, profile_dir=None):
    """Phase 3, the scoring service on the card: ScoringService with a
    warmup and an HTTP server, three jobs on the slice pair (the integer,
    float and integer_fast families), each job's JSON log equal to the slice
    run's and its launches the slice run's; the HTTP routes and a cancelled
    job; then the ``serve --warmup`` subcommand in a fresh process."""
    import http.client
    import signal
    import threading

    from pqa2_tpu_torch.app.service import ScoringService
    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer

    sdir = os.path.join(WORK_DIR, "serve")
    service = ScoringService(out_dir=os.path.join(sdir, "out"), device=device)
    per_job = {}
    run_job = service._run_job

    def counted_job(job):
        # The jobs run one at a time on the worker thread: every count is
        # set to 0 just before a job runs and read just after it.
        counters = kernel_counters()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        try:
            run_job(job)
        finally:
            torch.cuda.synchronize()
            per_job[job.id] = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    service._run_job = counted_job
    service.start()
    httpd = None
    try:
        t0 = time.perf_counter()
        warm = service.warmup()
        warm_s = time.perf_counter() - t0
        if warm.status != "done":
            raise AssertionError(f"warmup {warm.status}: {warm.error}")
        log(f"[serve] warmup (a 4-frame 384x216 integer job; the library was loaded and the "
            f"log2 audit passed earlier in this process): {warm_s:.3f} s, launches "
            f"{per_job[warm.id]} [{card}]")
        httpd = service.make_server(port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=600)
        pair = {"reference": ref_path, "distorted": dist_path}
        specs = {"integer": dict(pair),
                 "float": dict(pair, model="vmaf_float_v0.6.1", precision="float"),
                 "integer_fast": dict(pair, precision="integer_fast")}
        ids = {}
        for family, spec in specs.items():
            code, out = http_json(conn, "POST", "/score", spec)
            if code != 202:
                raise AssertionError(f"POST /score {spec}: {code} {out}")
            ids[family] = out["job_id"]
        code, out = http_json(conn, "POST", "/score", dict(pair, test_name="cancelled"))
        code, cancel = http_json(conn, "POST", f"/jobs/{out['job_id']}/cancel")
        if code != 200 or cancel != {"job_id": out["job_id"], "status": "cancelled"}:
            raise AssertionError(f"cancel of a queued job: {code} {cancel}")
        for method, path, body, want in (("GET", "/healthz", None, 200),
                                         ("GET", "/models", None, 200),
                                         ("POST", "/score", {"reference": ref_path}, 400),
                                         ("GET", "/jobs/job-404", None, 404)):
            code, out = http_json(conn, method, path, body)
            if code != want:
                raise AssertionError(f"{method} {path}: {code} {out}, expected {want}")
            if path == "/models" and "vmaf_v0.6.1" not in out["models"]:
                raise AssertionError(f"/models: {out}")
        log("[serve] GET /healthz and /models 200, a malformed spec 400, an unknown job 404, "
            "a fourth job cancelled while the first three were queued or running: 200")
        jobs = {family: wait_job(conn, job_id) for family, job_id in ids.items()}
        code, listing = http_json(conn, "GET", "/jobs")
        statuses = [j["status"] for j in listing["jobs"]]
        if code != 200 or statuses != ["cancelled", "done", "done", "done", "done"]:
            raise AssertionError(f"GET /jobs: {code} {statuses}")
        for family, job in jobs.items():
            n = check_job_log(f"serve {family}", job, slices[family])
            want = dict(slices[family]["counts"], log2_table_audit=0)
            if per_job[job["job_id"]] != want:
                raise AssertionError(f"serve {family}: launches {per_job[job['job_id']]}, "
                                     f"the slice run's {want}")
        conn.close()

        direct = {}
        for family, spec in specs.items():
            a = VMAFAnalyzer(device=device)
            a.set_output_directory(os.path.join(sdir, "direct"))
            a.feature_precision = spec.get("precision")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if a.analyze_videos(ref_path, dist_path, model=spec.get("model")) is None:
                raise AssertionError(f"direct analyze_videos {family} failed")
            direct[family] = time.perf_counter() - t0
        for family, job in jobs.items():
            run_s = job["finished_at"] - job["started_at"]
            log(f"[times] serve {family} job, {n} frames 1080p: submit to finish "
                f"{job['finished_at'] - job['submitted_at']:.3f} s, run {run_s:.3f} s; direct "
                f"analyze_videos {direct[family]:.3f} s (slice phase warm runs "
                + ", ".join(f"{t:.3f}" for t in slices[family]["warm"])
                + f" s); overhead {run_s - direct[family]:+.3f} s [{card}]")
        log(f"[serve] three jobs done; each JSON log equal to the slice run's in every value; "
            f"launches: {[per_job[j['job_id']] for j in jobs.values()]}")
        if profile_dir:
            def one_job():
                job = service.submit(dict(pair, test_name="profiled"))
                while job.status in ("queued", "running"):
                    time.sleep(0.005)
                if job.status != "done":
                    raise AssertionError(f"profiled job {job.status}: {job.error}")

            profile_run(torch, one_job, profile_dir, card, "serve_job_warm")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        service.stop()

    # The serve subcommand in a fresh process: its worker thread loads the
    # library and runs the log2 audit during --warmup, then one job.
    env = dict(os.environ, PYTHONPATH=HERE)
    err_path = os.path.join(sdir, "serve_cli.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pqa2_tpu_torch", "serve", "--port", "0", "--warmup",
             "--out", os.path.join(sdir, "cli"), "--device", device.type],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            lines = stdout_lines(proc)
            m = read_line(lines, proc, r"\[serve\] warmup (\w+) in ([0-9.]+) s", 300)
            if m.group(1) != "done":
                raise AssertionError(f"serve --warmup: warmup {m.group(1)}")
            port = int(read_line(lines, proc, r"listening on http://127\.0\.0\.1:(\d+)",
                                 60).group(1))
            listen_s = time.perf_counter() - t0
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            code, health = http_json(conn, "GET", "/healthz")
            if code != 200 or health["jobs_done"] != 1:
                raise AssertionError(f"serve --warmup /healthz: {code} {health}")
            code, out = http_json(conn, "POST", "/score", specs["integer"])
            job = wait_job(conn, out["job_id"])
            check_job_log("serve subcommand", job, slices["integer"])
            conn.close()
            proc.send_signal(signal.SIGINT)  # the server closes, the worker stops
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"serve subcommand exited {rc}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    log(f"[times] serve subcommand in a fresh process: warmup {float(m.group(2)):.3f} s "
        f"(in the worker thread: the library load, the log2 audit and a 4-frame job), listening "
        f"{listen_s:.3f} s after start; then one integer job: run "
        f"{job['finished_at'] - job['started_at']:.3f} s, its JSON log equal to the "
        f"slice run's; SIGINT, exit 0 [{card}]")


def phase_batch(torch, device, card, ref_path, dist_path, slices, n=72, h=1080, w=1920):
    """Phase 3, the batch ladder suite on the card: three rungs on the
    slice reference (the slice's distorted clip, a stronger distortion,
    the reference itself) through run_batch_suite(device="cuda")."""
    from pqa2_tpu_torch.io.y4m import write_y4m
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite

    bdir = os.path.join(WORK_DIR, "batch")
    os.makedirs(bdir, exist_ok=True)
    strong_path = os.path.join(bdir, "dist_strong_1080p.y4m")
    ref = smooth_frames(torch, n, h, w, 11, device)
    strong = distort(torch, ref, 13, radius=3, noise=40)
    c = torch.nn.functional.avg_pool2d(strong.float()[:, None], 2)[:, 0].round().to(torch.uint8)
    y, c = strong.cpu().numpy(), c.cpu().numpy()
    write_y4m(strong_path, [{"y": y[i], "u": c[i], "v": 255 - c[i]} for i in range(n)])
    del ref, strong, c, y
    spec = {"entries": [
        {"reference": ref_path, "distorted": dist_path, "name": "rung_slice"},
        {"reference": ref_path, "distorted": strong_path, "name": "rung_strong"},
        {"reference": ref_path, "distorted": ref_path, "name": "rung_reference"}]}
    out_dir = os.path.join(bdir, "suite")
    summary, secs, counts = counted(torch, lambda: run_batch_suite(spec, out_dir,
                                                                   device=device))
    with open(os.path.join(out_dir, "batch_summary.json")) as f:
        on_disk = json.load(f)
    rows = summary["clips"]
    if on_disk["n_clips"] != 3 or [r.get("name") for r in rows] != [
            e["name"] for e in spec["entries"]] or any("error" in r for r in rows):
        raise AssertionError(f"batch summary: {summary}")
    for r in rows:
        for path in (r["html_report"], os.path.join(out_dir, r["name"],
                                                    f"{r['name']}_frames.csv")):
            if not os.path.getsize(path):
                raise AssertionError(f"batch: {path} is empty")
    if rows[0]["vmaf"] != slices["integer"]["vmaf_score"]:
        raise AssertionError(f"batch rung_slice VMAF {rows[0]['vmaf']!r} != the slice "
                             f"run's {slices['integer']['vmaf_score']!r}")
    want = {k: 3 * v for k, v in dict(slices["integer"]["counts"], log2_table_audit=0).items()}
    if counts != want:
        raise AssertionError(f"batch launches {counts}, expected three integer jobs' {want}")
    log("[batch] three rungs: " + "; ".join(
        f"{r['name']} vmaf {r['vmaf']:.4f}, psnr {r['psnr']:.4f}, ssim {r['ssim']:.6f}, "
        f"{r['seconds']:.3f} s" for r in rows)
        + f"; rung_slice's VMAF equal to the slice run's in every bit; HTML and CSV per rung; "
        f"launches {counts} (three integer jobs')")
    log(f"[times] batch suite, 3 rungs of {n} frames 1080p: aggregate_fps "
        f"{summary['aggregate_fps']}, wall {summary['wall_seconds']} s ({secs:.3f} s with the "
        f"summary written) [{card}]")
    return spec, summary


def phase_capture(torch, device, card, h=540, w=960, n_ref=60):
    """Phase 3, the simulated capture chain: CaptureManager with the
    file-playback backend plays a 60-frame 960x540 reference between white
    bookends with noise; run_combined_workflow on the card aligns the
    capture as the CPU's BookendAligner does and scores it."""
    import numpy as np

    from pqa2_tpu_torch.app import (
        BookendAligner,
        CaptureManager,
        CaptureState,
        OptionsManager,
        VMAFAnalyzer,
        run_combined_workflow,
    )
    from pqa2_tpu_torch.app.capture import FilePlaybackBackend
    from pqa2_tpu_torch.io.video import probe_video
    from pqa2_tpu_torch.io.y4m import write_y4m
    from pqa2_tpu_torch.ops import colorspace

    cdir = os.path.join(WORK_DIR, "capture")
    os.makedirs(cdir, exist_ok=True)
    ref_path = os.path.join(cdir, "ref_540p.y4m")
    ref = workflow_content(torch, n_ref, h, w, device)
    c = torch.nn.functional.avg_pool2d(ref.float()[:, None], 2)[:, 0].round().to(torch.uint8)
    ry, rc = ref.cpu().numpy(), c.cpu().numpy()
    write_y4m(ref_path, [{"y": ry[i], "u": rc[i], "v": 255 - rc[i]} for i in range(n_ref)])

    # The colorspace conversions on the card give the CPU's bits.
    rgb = torch.stack([ref[0], c.repeat_interleave(2, 1).repeat_interleave(2, 2)[0],
                       255 - ref[1]], dim=-1)
    c422 = c[:2].repeat_interleave(2, dim=1)  # (2, h, w / 2)
    packed = colorspace.planar_to_uyvy422(ref[:2], c422, 255 - c422)
    for name, got, want in (
            ("rgb_to_yuv", colorspace.rgb_to_yuv(rgb), colorspace.rgb_to_yuv(rgb.cpu())),
            ("yuv_to_rgb", colorspace.yuv_to_rgb(rgb), colorspace.yuv_to_rgb(rgb.cpu())),
            ("uyvy422_to_planar", colorspace.uyvy422_to_planar(packed)["y"],
             colorspace.uyvy422_to_planar(packed.cpu())["y"]),
            ("chroma_444_to_420", colorspace.chroma_444_to_420(ref),
             colorspace.chroma_444_to_420(ref.cpu()))):
        if got.device != device or not torch.equal(got.cpu(), want):
            raise AssertionError(f"colorspace {name} on the card != the CPU's")
    del ref, c, rgb, c422, packed
    log(f"[capture] colorspace on the card: rgb_to_yuv, yuv_to_rgb, uyvy422_to_planar and "
        f"chroma_444_to_420 equal to the CPU's in every bit at {w}x{h}")

    om = OptionsManager(settings_file=os.path.join(cdir, "settings.json"), save_debounce_s=0)
    om.update_setting("bookend", "frame_offset", 0)
    cm = CaptureManager(options_manager=om, backend=FilePlaybackBackend(noise_sigma=2.0))
    cm.set_output_directory(cdir)
    cm.set_test_name("capture")
    info = probe_video(ref_path)
    cm.set_reference_video(info)
    policy = cm._calculate_capture_duration()
    done, states = [], []
    cm.capture_finished.connect(lambda ok, p: done.append((ok, p)))
    cm.state_changed.connect(lambda s: states.append(s.name))
    t0 = time.perf_counter()
    if not cm.start_bookend_capture("FilePlayback") or not cm.wait(timeout=600):
        raise AssertionError("the capture did not start or did not finish")
    capture_s = time.perf_counter() - t0
    if not done or not done[0][0] or cm.state != CaptureState.COMPLETED:
        raise AssertionError(f"capture failed: {done} {cm.state}")
    cap_path = done[0][1]
    n_cap = probe_video(cap_path)["frame_count"]
    log(f"[capture] duration policy: a {info['duration']:.3f} s reference, loops x "
        f"(reference + 2 x 0.2 s bookend) x 1.2, ceil -> {policy:.0f} s; {n_cap} frames "
        f"captured at {w}x{h} (white bookends, noise sigma 2.0) in {capture_s:.3f} s; "
        f"states {states}")

    analyzer = VMAFAnalyzer(device=device)
    analyzer.set_output_directory(os.path.join(cdir, "out"))
    out, secs, counts = counted(torch, lambda: run_combined_workflow(
        ref_path, cap_path, options_manager=om, aligner=BookendAligner(om, device=device),
        analyzer=analyzer, device=device))
    if out is None:
        raise AssertionError("run_combined_workflow on the capture failed")
    plain = BookendAligner(om, device="cpu").align_bookend_videos(ref_path, cap_path)
    if plain is None or without_paths(out["alignment"]) != without_paths(plain):
        raise AssertionError(f"capture alignment {out['alignment']} != the CPU "
                             f"BookendAligner's {plain}")
    vmaf = analyzer.last_scores.vmaf
    if not (np.all(np.isfinite(vmaf)) and out["analysis"]["frame_count"] > 0):
        raise AssertionError(f"capture scores: {vmaf}")
    expect_counts(counts, "capture workflow", {k: None for k in (
        "vif_int_scale", "adm_int_level", "ssim_sse_plane")})
    a = out["alignment"]
    log(f"[capture] run_combined_workflow(device='cuda'): alignment equal to "
        f"BookendAligner(device='cpu')'s (offset {a['offset_frames']} frames, reference "
        f"{a['ref_range']}, capture {a['cap_range']}, confidence {a['confidence']:.6f}); "
        f"{out['analysis']['frame_count']} frames scored, vmaf "
        f"{out['analysis']['vmaf_score']:.4f} (per frame {vmaf.min():.3f}..{vmaf.max():.3f}); "
        f"{secs:.3f} s; launches {counts} [{card}]")


# Per family: (model, precision, the kernels that score its features).
PARALLEL_FAMILIES = {
    "integer": ("vmaf_v0.6.1", None, ("vif_int_scale", "adm_int_level")),
    "float": ("vmaf_float_v0.6.1", None, FLOAT_KERNELS),
    "integer_fast": ("vmaf_v0.6.1", "integer_fast", ("vif_int_scale_fast", "adm_int_level")),
}


def decode_luma(path):
    """(N, H, W) luma of a y4m file, in its source dtype."""
    import numpy as np

    from pqa2_tpu_torch.io.video import VideoReader

    with VideoReader(path) as r:
        return np.stack([f["y"] for f in r])


def check_scores_equal(label, got, want_vmaf, want_features):
    """``got`` (a sharded scorer's dict) against single-device per-frame
    arrays, in every bit."""
    import numpy as np

    pairs = [("vmaf", got["vmaf"], want_vmaf)]
    pairs += [(k, got[k], v) for k, v in want_features.items()]
    for nm, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: {nm} differs from the single-device run")
    return len(pairs)


def expect_shard_counts(label, counts, per_chunk, chunks, kernels):
    """The feature kernels of a sharded run launch ``per_chunk[k]`` times
    per chunk; no other kernel runs (the log2 audit passed earlier)."""
    want = {k: (per_chunk[k] * chunks if k in kernels else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def phase_parallel(torch, card, ref_path, dist_path, slices, ladder):
    """Phase 3, multi-device scoring on one card (mesh entries that share
    cuda:0, as JAX's virtual host mesh shares the host): the sharded
    scorers against single-device scoring in every bit, a 10-bit pair at
    full width, the sharded ladder, the dryrun subcommand, the multi-process
    helpers over NCCL and the native frame pump."""
    import numpy as np

    from pqa2_tpu_torch.align import streamed
    from pqa2_tpu_torch.io.native import NativeY4MReader
    from pqa2_tpu_torch.io.video import VideoReader
    from pqa2_tpu_torch.parallel import (
        frame_sharding,
        make_mesh,
        make_sharded_scorer,
        multihost,
        score_clip_sharded,
    )
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite
    from pqa2_tpu_torch.pipeline.scoring import score_clip
    from pqa2_tpu_torch.pipeline.streaming import _open_reader

    t_phase = time.perf_counter()
    ry, dy = decode_luma(ref_path), decode_luma(dist_path)
    n = ry.shape[0]
    slice_chunks = -(-n // 32)
    mesh4 = make_mesh(devices=["cuda:0"] * 4)
    mesh5 = make_mesh(devices=["cuda:0"] * 5)
    sizes5 = [stop - start for _, start, stop in frame_sharding(mesh5).ranges(n)]
    if sizes5 != [15, 15, 14, 14, 14]:
        raise AssertionError(f"5-entry ranges {sizes5}")

    # 1. Sharded scoring, three families, 4 and 5 entries.
    for family, (model, precision, kernels) in PARALLEL_FAMILIES.items():
        want = slices[family]["scores"]
        per_chunk = {k: v // slice_chunks for k, v in slices[family]["counts"].items()}
        single, single_s, single_counts = counted(torch, lambda: score_clip(
            ry, dy, model=model, precision=precision, device="cuda"))
        m = check_scores_equal(f"{family} single-device score_clip", {
            "vmaf": single.vmaf, **single.features}, want.vmaf, want.features)
        for mesh in (mesh4, mesh5):
            k = len(mesh.entries)
            out, secs, counts = counted(torch, lambda: score_clip_sharded(
                ry, dy, mesh, model=model, precision=precision))
            check_scores_equal(f"{family} score_clip_sharded {k} entries", out, want.vmaf,
                               want.features)
            if out["n_frames"] != n:
                raise AssertionError(f"{family}: n_frames {out['n_frames']}")
            expect_shard_counts(f"{family} {k} entries", counts, per_chunk, k, kernels)
            log(f"[parallel] score_clip_sharded {family} ({model}) on {k} entries of cuda:0: "
                f"{m} per-frame arrays (VMAF + features) equal to the slice run's in every "
                f"bit; launches {counts}; {secs:.3f} s against single-device score_clip "
                f"{single_s:.3f} s [{card}]")

    # 2. The 2-D scorer with PSNR/SSIM: the slice's luma values.
    want = slices["integer"]["scores"]
    mesh22 = make_mesh(n_data=2, n_space=2, devices=["cuda:0"] * 4)
    out, secs, counts = counted(torch, lambda: make_sharded_scorer(
        mesh22, "vmaf_v0.6.1", with_psnr_ssim=True)(ry, dy))
    m = check_scores_equal("2-D scorer", out, want.vmaf,
                           {**want.features, "psnr_y": want.psnr["psnr_y"],
                            "ssim_y": want.ssim["ssim_y"]})
    per_chunk = {k: v // slice_chunks for k, v in slices["integer"]["counts"].items()}
    per_chunk["ssim_sse_plane"] = 1
    expect_shard_counts("2-D scorer", counts, per_chunk, 4,
                        ("vif_int_scale", "adm_int_level", "ssim_sse_plane"))
    log(f"[parallel] make_sharded_scorer on a 2x2 mesh of cuda:0 with PSNR/SSIM: {m} "
        f"per-frame arrays (VMAF, features, psnr_y, ssim_y) equal to the slice run's in "
        f"every bit; launches {counts}; {secs:.3f} s [{card}]")

    # 3. A 10-bit pair at full width: the slice's frames x 4 with +-1 codes.
    rng = np.random.default_rng(10)
    r10 = np.clip(ry[:24].astype(np.int32) * 4 + rng.integers(-1, 2, ry[:24].shape), 0, 1023)
    d10 = np.clip(dy[:24].astype(np.int32) * 4 + rng.integers(-1, 2, dy[:24].shape), 0, 1023)
    r10, d10 = (r10 / 4.0).astype(np.float32), (d10 / 4.0).astype(np.float32)
    single, single_s, _ = counted(torch, lambda: score_clip(r10, d10, bit_depth=10,
                                                            device="cuda"))
    out, secs, counts = counted(torch, lambda: score_clip_sharded(r10, d10, mesh4,
                                                                 bit_depth=10))
    m = check_scores_equal("10-bit 1080p", out, single.vmaf, single.features)
    if not (np.all(np.isfinite(single.vmaf)) and 0.0 <= single.vmaf.min()
            and single.vmaf.max() <= 100.0):
        raise AssertionError(f"10-bit VMAF {single.vmaf.min()}..{single.vmaf.max()}")
    log(f"[parallel] 10-bit 1920x1080, 24 frames, integer family: score_clip_sharded on 4 "
        f"entries equal to single-device score_clip in every bit ({m} arrays; VMAF "
        f"{single.vmaf.min():.3f}..{single.vmaf.max():.3f}); launches {counts}; {secs:.3f} s "
        f"against {single_s:.3f} s [{card}]")
    del r10, d10

    # 4. The sharded ladder: the batch phase's three rungs on 4 entries.
    spec, plain = ladder
    plain_json = {r["name"]: r["json_path"] for r in plain["clips"]}
    out_dir = os.path.join(WORK_DIR, "batch", "suite_sharded")
    lines = []
    summary, secs, counts = counted(torch, lambda: run_batch_suite(
        spec, out_dir, mesh=mesh4, log=lines.append))
    rows = summary["clips"]
    if any("error" in r for r in rows) or len(rows) != 3 or summary["mesh_devices"] != 4:
        raise AssertionError(f"sharded ladder: {summary}")
    for r in rows:
        with open(r["json_path"]) as f:
            got = json.load(f)["frames"]
        with open(plain_json[r["name"]]) as f:
            plain = json.load(f)["frames"]
        if len(got) != len(plain) or any(
                g["metrics"][k] != p["metrics"][k] for g, p in zip(got, plain)
                for k in g["metrics"]):
            raise AssertionError(f"sharded ladder {r['name']}: per-frame values differ from "
                                 f"the rung scored without a mesh")
    decodes = sum(1 for ln in lines if ln.startswith("  decode: "))
    hits = sum(1 for ln in lines if ln.startswith("  luma cache hit: "))
    if decodes != 3 or hits != 3:
        raise AssertionError(f"sharded ladder: {decodes} decodes, {hits} cache hits: {lines}")
    per_chunk = {k: v // slice_chunks for k, v in slices["integer"]["counts"].items()}
    expect_shard_counts("sharded ladder", counts, per_chunk, 3 * 4,
                        ("vif_int_scale", "adm_int_level"))
    log(f"[parallel] sharded ladder on 4 entries: no error rows; every rung's per-frame "
        f"JSON values (VMAF and features) equal to its rung without a mesh; {decodes} "
        f"decodes, {hits} luma cache hits (the reference decoded once); launches {counts}")
    log(f"[times] sharded ladder, 3 rungs of {n} frames 1080p on 4 entries of cuda:0: "
        f"aggregate_fps {summary['aggregate_fps']}, aggregate_fps_per_device "
        f"{summary['aggregate_fps_per_device']} (per mesh entry), wall "
        f"{summary['wall_seconds']} s [{card}]")

    # 5. The dryrun subcommand in a fresh process.
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pqa2_tpu_torch.cli", "dryrun", "--devices",
                           "4"], cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=600)
    ok = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip ok")]
    if proc.returncode != 0 or not ok or "in every bit" not in ok[0]:
        raise AssertionError(f"dryrun exited {proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-3000:]}")
    log(f"[parallel] cli dryrun --devices 4: exit 0 in {time.perf_counter() - t0:.2f} s: "
        f"{ok[0]}")

    # 6. The multi-process helpers over NCCL at world size 1, and the pump.
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                            "RANK")}
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                      RANK="0")
    try:
        if not multihost.initialize():
            raise AssertionError("multihost.initialize() did not join a group")
        import torch.distributed as dist

        backend = dist.get_backend()
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        summaries = [{"clip": "a", "vmaf": 90.0}, {"clip": "b", "vmaf": 80.0}]
        if (multihost.gather_summaries(summaries) != summaries
                or multihost.shard_clip_list(["a", "b", "c"]) != ["a", "b", "c"]
                or t.tolist() != [1.0] * 4 or backend != "nccl"):
            raise AssertionError("multihost helpers at world size 1")
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"[parallel] multihost: initialize() from MASTER_ADDR/MASTER_PORT joined a {backend} "
        f"group of 1, all_reduce, gather_summaries and shard_clip_list, "
        f"destroy_process_group")

    for path in (ref_path, dist_path):
        r = _open_reader(path)
        try:
            if not isinstance(r, NativeY4MReader):
                raise AssertionError(f"_open_reader gave {type(r).__name__}")
            with VideoReader(path) as v:
                count = 0
                for a, b in zip(r, v):
                    if any(a[p].tobytes() != b[p].tobytes() for p in "yuv"):
                        raise AssertionError(f"{path}: frame {count} differs")
                    count += 1
                if count != n or v.read_frame() is not None:
                    raise AssertionError(f"{path}: {count} frames")
        finally:
            r.close()
    trim_native = os.path.join(WORK_DIR, "trim_native.y4m")
    trim_python = os.path.join(WORK_DIR, "trim_python.y4m")
    written = streamed.write_trim(dist_path, trim_native, 5, 41)
    open_native = streamed._open_native
    streamed._open_native = lambda *a: None
    try:
        streamed.write_trim(dist_path, trim_python, 5, 41)
    finally:
        streamed._open_native = open_native
    with open(trim_native, "rb") as f1, open(trim_python, "rb") as f2:
        if written != 36 or f1.read() != f2.read():
            raise AssertionError("write_trim: the native writer's file differs")
    log(f"[parallel] native pump: _open_reader gave NativeY4MReader, its {n} frames equal "
        f"to VideoReader's byte for byte on both slice files; write_trim through the "
        f"native writer ({written} frames) byte-equal to the Python writer's")
    log("[times] slice warm analyze_videos through the native pump: " + "; ".join(
        f"{fam} " + ", ".join(f"{t:.3f}" for t in slices[fam]["warm"]) + " s"
        for fam in PARALLEL_FAMILIES) + f" [{card}]")
    log(f"[times] parallel phase: {time.perf_counter() - t_phase:.2f} s [{card}]")


DEPTH_FRAMES = 36        # chunks 32 + 4: a motion halo across the boundary, a short tail
DEPTH_MIXED_FRAMES = 34  # chunks 32 + 2
DEPTH_4K = (2160, 3840)
DEPTH_MIXED = (1080, 1920)
DEPTH_PLAIN_FRAMES = (0, 31, 32, 35)  # both clip ends and both sides of the boundary
DEPTH_SSIM_ATOL = 2e-6   # SSIM past 8 bits vs the oracle (tests/test_highbitdepth.py:103)
PSNR_ATOL = 1e-6         # dB; the port's SSE is exact, the oracle's float64
# Launches per chunk of each family (VIF and ADM: 4 scales / levels; kernel
# 5 launches kernel 7 once per chunk; SSIM: Y, U, V).
INT_PER_CHUNK = {"vif_int_scale": 4, "adm_int_level": 4, "ssim_sse_plane": 3}
FLOAT_PER_CHUNK = {"vif_scale": 4, "adm_level": 4, "motion_sad": 1, "ssim_sse_plane": 3}


def plain_features(torch, ref, dist, *, has_prev, has_next, bit_depth, params):
    """``pipeline/features.py:extract_features_batched`` with each kernel's
    plain PyTorch version in its place, on the same tensors -> host
    per-frame arrays of the core frames."""
    from pqa2_tpu_torch.ops.adm import adm_from_level_sums, adm_level_plain_float
    from pqa2_tpu_torch.ops.adm_int import (
        adm_cascade,
        adm_from_digit_sums,
        adm_level_plain,
        digits_from_sums,
    )
    from pqa2_tpu_torch.ops.motion import features_from_sad_prev, motion_sad_plain
    from pqa2_tpu_torch.ops.motion_int import motion_from_sad
    from pqa2_tpu_torch.ops.vif import vif_ratio, vif_scale_plain
    from pqa2_tpu_torch.ops.vif_int import scale0_codes, vif_cascade, vif_int_scale_plain

    n, h, w = ref.shape
    core = slice(1 if has_prev else 0, n - 1 if has_next else n)
    if params["precision"] == "integer":
        codes, _ = scale0_codes(ref, bit_depth)
        vif, sad = vif_cascade(codes[core], dist[core], gain_limit=params["vif_gain"],
                               bit_depth=bit_depth, scale_fn=vif_int_scale_plain,
                               motion_ref=codes)
        motion, motion2 = features_from_sad_prev(motion_from_sad(sad, h, w), n,
                                                 has_prev=has_prev, has_next=has_next)
        sums = adm_cascade(ref[core], dist[core], gain_limit=params["adm_gain"],
                           bit_depth=bit_depth, level_fn=adm_level_plain)
        adm2 = torch.as_tensor(adm_from_digit_sums(digits_from_sums(sums), h, w))
    else:
        r, d, vif = ref[core].float(), dist[core].float(), []
        for scale in range(4):
            num, den, r, d = vif_scale_plain(r, d, scale=scale, gain_limit=params["vif_gain"],
                                             variant=params["vif_variant"],
                                             emit_next=scale < 3)
            vif.append(vif_ratio(num, den))
        vif = torch.stack(vif, dim=-1)
        motion, motion2 = features_from_sad_prev(motion_sad_plain(ref.float())[1:], n,
                                                 has_prev=has_prev, has_next=has_next)
        r, d, sums = ref[core].float(), dist[core].float(), []
        for lvl in range(4):
            s, r, d = adm_level_plain_float(r, d, level=lvl, gain_limit=params["adm_gain"])
            sums.append(s)
        adm2 = adm_from_level_sums(sums, h, w)
    out = {"adm2": adm2, "motion": motion, "motion2": motion2}
    out.update({f"vif_scale{s}": vif[:, s] for s in range(4)})
    return {k: v.cpu().numpy() for k, v in out.items()}


def check_plain_frames(torch, device, label, scores, ry, dy, depth, model, family):
    """Frames DEPTH_PLAIN_FRAMES of a run recomputed by ``plain_features``
    on the card, each with its neighbours as its chunk holds them (frame 31
    with chunk 0's halo frame 32, frame 32 with chunk 1's halo frame 31):
    integer features equal in every bit, float features within the
    kernel-vs-plain budgets (PERF.md section 2)."""
    import numpy as np

    from pqa2_tpu_torch.models.registry import get_model
    from pqa2_tpu_torch.pipeline.features import model_feature_params
    from pqa2_tpu_torch.pipeline.scoring import upload

    params = model_feature_params(get_model(model), None, device=device)
    n, div = ry.shape[0], float(1 << (depth - 8))
    worst = 0.0
    for t in DEPTH_PLAIN_FRAMES:
        lo, hi = max(t - 1, 0), min(t + 2, n)
        r = upload(ry[lo:hi], device, div)
        d = upload(dy[lo:hi], device, div)
        got = plain_features(torch, r, d, has_prev=t > 0, has_next=t < n - 1,
                             bit_depth=depth, params=params)
        for k, v in got.items():
            want = scores.features[k][t]
            if family == "integer":
                if v.shape != (1,) or v.dtype != want.dtype or v[0] != want:
                    raise AssertionError(f"{label} frame {t} {k}: plain {v} != kernels' {want}")
                continue
            diff = abs(float(v[0]) - float(want))
            lim = FLOAT_SUM_RTOL * abs(float(want)) if k.startswith("motion") else FLOAT_FEAT_ATOL
            if not diff <= lim:
                raise AssertionError(f"{label} frame {t} {k}: plain {v[0]} vs kernels' {want} "
                                     f"({diff:.3e} > {lim:.3e})")
            worst = max(worst, diff)
        del r, d
    log(f"[depth] {label}: frames {', '.join(map(str, DEPTH_PLAIN_FRAMES))} recomputed with the "
        f"plain versions on the card: "
        + ("every integer feature equal in every bit" if family == "integer" else
           f"features within {FLOAT_FEAT_ATOL:g} (motion {FLOAT_SUM_RTOL:g} rel), max "
           f"|diff| {worst:.3e}"))


def check_depth_artifacts(res, scores, label, model, n, w, h, peak):
    """The results dict, the libvmaf-schema JSON and the PSNR/SSIM logs of
    one run: VMAF in (0, 100], the PSNR summary pooled at the native peak."""
    import re

    import numpy as np

    if res is None:
        raise AssertionError(f"{label} failed")
    if (res["frame_count"], res["width"], res["height"], res["model"]) != (n, w, h, model):
        raise AssertionError(f"{label}: results {res['frame_count']} frames "
                             f"{res['width']}x{res['height']} {res['model']}")
    with open(res["json_path"]) as f:
        frames = json.load(f)["frames"]
    vmaf = np.array([fr["metrics"]["vmaf"] for fr in frames])
    if len(frames) != n or not (np.all(vmaf > 0.0) and np.all(vmaf <= 100.0)):
        raise AssertionError(f"{label}: {len(frames)} JSON frames, VMAF "
                             f"{vmaf.min()}..{vmaf.max()} not in (0, 100]")
    for k in ("psnr_y", "psnr_u", "psnr_v", "float_ssim"):
        v = np.array([fr["metrics"][k] for fr in frames])
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{label}: non-finite {k} in the JSON log")
    with open(res["psnr_log"]) as f:
        lines = f.read().splitlines()
    m = re.match(r"PSNR average:([0-9.]+) ", lines[-1])
    want = 10.0 * np.log10(peak * peak / np.mean(scores.psnr["mse_avg"]))
    if (len(lines) != n + 1 or m is None or abs(float(m.group(1)) - want) > 1e-5
            or abs(float(m.group(1)) - float(np.mean(scores.psnr["psnr_avg"]))) > 3.0
            or scores.peak != peak):
        raise AssertionError(f"{label}: PSNR log summary {lines[-1]!r}, expected "
                             f"{want:.6f} at peak {peak:g}")
    with open(res["ssim_log"]) as f:
        lines = f.read().splitlines()
    if len(lines) != n + 1 or not lines[-1].startswith("SSIM average:"):
        raise AssertionError(f"{label}: SSIM log has {len(lines)} lines")
    return float(m.group(1))


def phase_depth(torch, device, card, profile_dir=None):
    """Phase 3, the 4K and high-bit-depth configurations through
    ``analyze_videos`` from y4m files: 8-bit 3840x2160 with
    ``vmaf_4k_v0.6.1``, ``vmaf_4k_v0.6.1neg`` and ``vmaf_float_4k_v0.6.1``,
    10-bit 3840x2160 with ``vmaf_4k_v0.6.1`` and an 8-bit reference against
    a 10-bit distorted 1920x1080 clip with ``vmaf_v0.6.1``, each with
    PSNR+SSIM: launches per chunk, the in-memory path on the decoded frames
    in every bit, frames recomputed with the plain versions, the 10-bit
    run's frame 32 against the oracles, the artifacts at the native peak,
    wall seconds and peak device memory. Returns the 8-bit 4K runs' launch
    counts by family."""
    import resource
    import shutil

    import numpy as np

    from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer
    from pqa2_tpu_torch.golden.adm_int import adm_features_int
    from pqa2_tpu_torch.golden.motion_int import motion_features_int
    from pqa2_tpu_torch.golden.psnr import psnr_frame
    from pqa2_tpu_torch.golden.ssim import ssim_plane
    from pqa2_tpu_torch.golden.vif_int import vif_features_int
    from pqa2_tpu_torch.ops.cuda_ssim import ssim_sse_plane
    from pqa2_tpu_torch.ops.ssim import ssim_sse_plane_plain

    t_phase = time.perf_counter()
    ddir = os.path.join(WORK_DIR, "depth")
    os.makedirs(ddir, exist_ok=True)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    pairs = {}
    for tag, n, (h, w), depth, dist_depth in (
            ("4k8", DEPTH_FRAMES, DEPTH_4K, 8, None),
            ("4k10", DEPTH_FRAMES, DEPTH_4K, 10, None),
            ("1080p8_10", DEPTH_MIXED_FRAMES, DEPTH_MIXED, 8, 10)):
        paths = (os.path.join(ddir, f"ref_{tag}.y4m"), os.path.join(ddir, f"dist_{tag}.y4m"))
        t0 = time.perf_counter()
        ry, dy = write_pair(n, h, w, *paths, torch, device, depth, dist_depth)
        pairs[tag] = (paths, ry, dy)
        log(f"[depth] wrote a {n}-frame {w}x{h} 4:2:0 pair, reference {depth}-bit, distorted "
            f"{dist_depth or depth}-bit ({sum(os.path.getsize(p) for p in paths) / 1e9:.3f} "
            f"GB) in {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()

    runs = (("8-bit 4K vmaf_4k_v0.6.1", "4k8", "vmaf_4k_v0.6.1", "integer"),
            ("8-bit 4K vmaf_4k_v0.6.1neg", "4k8", "vmaf_4k_v0.6.1neg", "integer"),
            ("8-bit 4K vmaf_float_4k_v0.6.1", "4k8", "vmaf_float_4k_v0.6.1", "float"),
            ("10-bit 4K vmaf_4k_v0.6.1", "4k10", "vmaf_4k_v0.6.1", "integer"),
            ("8/10-bit 1080p vmaf_v0.6.1", "1080p8_10", "vmaf_v0.6.1", "integer"))
    decoded, launches = {}, {}
    for label, tag, model, family in runs:
        (ref_path, dist_path), ry, dy = pairs[tag]
        n, h, w = ry.shape
        depth = 10 if ry.dtype == np.uint16 or dy.dtype == np.uint16 else 8
        peak = float((1 << depth) - 1)
        chunks = -(-n // 32)
        per = INT_PER_CHUNK if family == "integer" else FLOAT_PER_CHUNK
        want_counts = {k: per.get(k, 0) * chunks for k in KERNELS}
        a = VMAFAnalyzer(device=device)
        a.set_output_directory(os.path.join(ddir, "out"))
        a.set_test_name(f"depth_{tag}_{model}")

        # The first run: launches, artifacts, peak memory.
        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        res, first_s, counts = counted(torch, lambda: a.analyze_videos(ref_path, dist_path,
                                                                       model=model))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if counts != want_counts:
            raise AssertionError(f"{label}: launches {counts}, expected {want_counts} "
                                 f"({chunks} chunks)")
        if tag == "4k8":
            launches.setdefault(family, counts)
        scores = a.last_scores
        summary = check_depth_artifacts(res, scores, label, model, n, w, h, peak)
        # A warm run of the same call: the same bits.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.analyze_videos(ref_path, dist_path, model=model)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check_same_bits(f"{label} warm run", per_frame(a.last_scores), per_frame(scores))
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        log(f"[depth] {label}, {n} frames ({chunks} chunks) with PSNR+SSIM: VMAF "
            f"{res['vmaf_score']:.4f} (per frame {scores.vmaf.min():.3f}.."
            f"{scores.vmaf.max():.3f}), PSNR {res['psnr_score']:.4f} dB (log summary "
            f"{summary:.6f} at peak {peak:g}), SSIM {res['ssim_score']:.6f}; artifacts "
            f"checked; launches {counts}")
        log(f"[times] depth {label}, {n} frames: first run {first_s:.3f} s "
            f"({n / first_s:.2f} fps), warm run {warm_s:.3f} s ({n / warm_s:.2f} fps); "
            f"peak device memory {peak_gb:.3f} GB ({100.0 * peak_gb / total_gb:.1f} % of "
            f"{total_gb:.1f} GB; {base_gb:.3f} GB allocated before the run), process peak "
            f"RSS {rss_gb:.3f} GB so far [{card}]")
        if profile_dir:
            profile_run(torch, lambda: a.analyze_videos(ref_path, dist_path, model=model),
                        profile_dir, card, f"depth_{tag}_{model}_warm_run")

        # The in-memory path on the same decoded frames: the same bits. The
        # 8-bit reference of the mixed pair goes in promoted to 10-bit codes
        # (x 4, exact), as the file path promotes it.
        if tag not in decoded:
            decoded.clear()
            rp, dp = decode(ref_path), decode(dist_path)
            if ry.dtype != dy.dtype:
                rp = [{p: f[p].astype(np.uint16) << 2 for p in "yuv"} for f in rp]
            decoded[tag] = (rp, dp)
        rp, dp = decoded[tag]
        mem, mem_s, mem_counts = counted(torch, lambda: a.analyze_frames(
            rp, dp, model=model, reference_name=ref_path, distorted_name=dist_path,
            bit_depth=depth))
        if mem is None or mem_counts != want_counts:
            raise AssertionError(f"{label} analyze_frames: launches {mem_counts}")
        m = check_same_bits(f"{label} analyze_frames", per_frame(a.last_scores),
                            per_frame(scores))
        log(f"[depth] {label}: analyze_frames on the decoded frames gives {m} per-frame "
            f"arrays (features, VMAF, PSNR, SSIM) equal to analyze_videos' in every bit, "
            f"the same launches; {mem_s:.3f} s [{card}]")

        if tag != "1080p8_10":
            t0 = time.perf_counter()
            check_plain_frames(torch, device, label, scores, ry, dy, depth, model, family)
            log(f"[times] depth {label}: plain recomputation {time.perf_counter() - t0:.2f} s "
                f"[{card}]")

        if tag == "4k10":
            # Kernel 4 at 10 bits (its constants scaled to the depth's peak)
            # against its plain version on the card.
            r = torch.from_numpy(ry[30:34].astype(np.float32) / 4.0).to(device)
            d = torch.from_numpy(dy[30:34].astype(np.float32) / 4.0).to(device)
            s_k, e_k = ssim_sse_plane(r, d, bit_depth=10)
            s_p, e_p = ssim_sse_plane_plain(r, d, bit_depth=10)
            err = (s_k.double() - s_p.double()).abs().max().item()
            if err > SSIM_ATOL or not torch.equal(e_k, e_p):
                raise AssertionError(f"{label}: kernel 4 at 10 bits vs plain {err:.3e}")
            del r, d
            # Frame 32 (the first of chunk 1) against the numpy oracles.
            feats, t = scores.features, 32
            t0 = time.perf_counter()
            vo = np.array(vif_features_int(ry[t], dy[t], bit_depth=10))
            t_vif = time.perf_counter() - t0
            ao = adm_features_int(ry[t], dy[t], bit_depth=10)[0]
            t_adm = time.perf_counter() - t0 - t_vif
            mo, m2o = motion_features_int(ry[t - 1:t + 2], bit_depth=10)
            t_mot = time.perf_counter() - t0 - t_vif - t_adm
            so = {p: ssim_plane(rp[t][p], dp[t][p], 10) for p in "yuv"}
            po = psnr_frame(rp[t], dp[t], max_value=1023)
            t_all = time.perf_counter() - t0
            vp = np.array([feats[f"vif_scale{s}"][t] for s in range(4)])
            checks = [("vif", np.max(np.abs(vp - vo)), VIF_ATOL),
                      ("adm2", abs(feats["adm2"][t] - ao), ADM_ATOL),
                      ("motion", abs(feats["motion"][t] - mo[1]), MOTION_RTOL * abs(mo[1])),
                      ("motion2", abs(feats["motion2"][t] - m2o[1]),
                       MOTION_RTOL * abs(m2o[1]))]
            checks += [(f"ssim_{p}", abs(scores.ssim[f"ssim_{p}"][t] - so[p]), DEPTH_SSIM_ATOL)
                       for p in "yuv"]
            checks += [(f"psnr_{p}", abs(scores.psnr[f"psnr_{p}"][t] - po[f"psnr_{p}"]),
                        PSNR_ATOL) for p in ("y", "u", "v", "avg")]
            for nm, diff, lim in checks:
                if not diff <= lim:
                    raise AssertionError(f"{label} frame {t} {nm}: {diff:.3e} from the "
                                         f"oracle > {lim:.3e}")
            log(f"[oracle] {label} frame {t}: " + ", ".join(
                f"|{nm} - oracle| {diff:.3e}" for nm, diff, _ in checks)
                + f"; kernel 4 at 10 bits vs plain {err:.3e}, SSE equal")
            log(f"[times] depth oracles, one 3840x2160 10-bit frame on the host: vif_int "
                f"{t_vif:.2f} s, adm_int {t_adm:.2f} s, motion_int (3 frames) {t_mot:.2f} s, "
                f"ssim + psnr (Y, U, V) {t_all - t_vif - t_adm - t_mot:.2f} s [{card}]")
        del a
        torch.cuda.empty_cache()
    decoded.clear()
    shutil.rmtree(ddir, ignore_errors=True)
    log(f"[times] depth phase: {time.perf_counter() - t_phase:.2f} s [{card}]")
    return launches


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
    trace = os.path.join(WORK_DIR, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)
    os.remove(trace)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    htod = [e.get("args", {}).get("bytes", 0) for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=40)
    host = averages.table(sort_by="self_cpu_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(f"{card}\n{label}: wall {wall * 1e3:.3f} ms, device busy {total:.3f} ms, "
                f"{len(htod)} HtoD copies of {sum(htod)} bytes\n\n")
        for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1]):
            f.write(f"{us / 1e3:10.3f} ms {count[name]:5d}x  {name}\n")
        f.write("\n" + table + "\n\nHost self time by operation:\n" + host)
    log(f"[profile] {label} under torch.profiler: wall {wall * 1e3:.3f} ms, "
        f"device busy {total:.3f} ms ({100.0 * (1 - total / (wall * 1e3)):.1f} % idle), "
        f"{len(htod)} HtoD copies of {sum(htod) / 1e6:.3f} MB [{card}]")
    for name, us in sorted(busy_us.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count[name]:4d}x  {name[:90]}")
    for e in sorted(averages, key=lambda e: -e.self_cpu_time_total)[:6]:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3:9.3f} ms self, "
            f"{e.count} calls  {e.key[:70]}")


SASS_KERNELS = ("vif_int_scale_kernel", "vif_scale_f32_kernel", "adm_int_level_kernel",
                "adm_level_f32_kernel", "motion_sad_f32_kernel")


def sass_report(build, out_dir):
    """cuobjdump -sass of the kernel library into ``out_dir``; prints each
    VIF scale, ADM level and motion SAD kernel's instruction count, its most
    frequent opcodes and the subroutines it calls (a 64-bit division would
    be one)."""
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
                         "counts of the VIF scale, ADM level and motion SAD kernels")
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
    from pqa2_tpu_torch.io import native

    t0 = time.perf_counter()
    if not native.is_available():
        raise RuntimeError("the native frame pump (pqa2_tpu_torch/csrc/framepump.cpp) "
                           "did not build")
    log(f"[build] {native._LIB_PATH}: ready in {time.perf_counter() - t0:.2f} s (g++ when "
        f"it was not built yet)")
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
    ref_path, dist_path, slices = phase_slice(torch, device, results, card, args.profile)
    workflow = phase_workflow(torch, device, card, args.profile)
    phase_gui(torch, card, workflow)
    del workflow
    phase_trace(torch, card, ref_path, dist_path, slices)
    phase_serve(torch, device, card, ref_path, dist_path, slices, args.profile)
    ladder = phase_batch(torch, device, card, ref_path, dist_path, slices)
    phase_capture(torch, device, card)
    phase_parallel(torch, card, ref_path, dist_path, slices, ladder)
    torch.cuda.empty_cache()
    depth_launches = phase_depth(torch, device, card, args.profile)
    torch.cuda.empty_cache()
    ref, dist = phase_kernels(torch, device, results)
    phase_times(torch, device, results, ref, dist, card, args.profile)
    del ref, dist
    torch.cuda.empty_cache()
    phase_times_4k(torch, device, card, depth_launches)
    log(card)
    log(json.dumps({"kernels": list(results.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
