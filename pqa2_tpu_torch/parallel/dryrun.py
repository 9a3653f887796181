"""Multi-device dry run of the sharded scorers (the port's counterpart of
``dryrun_multichip`` in the repository's ``__graft_entry__.py``, which
imports JAX).

Three legs on an ``n_devices``-entry mesh, each held in every bit against
the single-device :func:`pipeline.scoring.score_clip` (and, for PSNR/SSIM,
:func:`pipeline.scoring.plane_metrics` over the whole batch) on the same
inputs and the same device:

  1. the 2-D (n_data x 2) :func:`make_sharded_scorer` with PSNR/SSIM;
  2. the same mesh with the integer family on a 10-bit source;
  3. the data-only :func:`make_shardmap_scorer`, at the model's default
     family and with an integer 10-bit run.

With fewer cards than entries the mesh repeats the visible cards (on the
CPU every entry is the CPU), as the JAX package's virtual host mesh does,
and the output line says so. The JAX package holds its dry run to 5e-4
VMAF, 1e-3 dB PSNR and 1e-5 SSIM; the port compares in every bit.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from pqa2_tpu_torch.parallel.mesh import make_mesh
from pqa2_tpu_torch.parallel.scoring import make_sharded_scorer, make_shardmap_scorer
from pqa2_tpu_torch.pipeline.scoring import plane_metrics, resolve_device, score_clip, upload


def _make_clip(n, h, w, seed=0):
    """A smooth (n, h, w) f32 luma clip on the 8-bit grid and a noisy copy."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(n, h, w))
    for _ in range(2):
        base = (
            base
            + np.roll(base, 1, -1) + np.roll(base, -1, -1)
            + np.roll(base, 1, -2) + np.roll(base, -1, -2)
        ) / 5.0
    ref = np.round(base).astype(np.float32)
    dist = np.clip(ref + rng.normal(0, 4, ref.shape), 0, 255).astype(np.float32)
    return ref, dist


def _check_same(label, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"dryrun {label}: sharded values differ from single-device "
                             f"(max |d| {np.max(np.abs(got - want)) if got.shape == want.shape else got.shape})")


def _check_scores(label, out, single, names):
    _check_same(f"{label} vmaf", out["vmaf"], single.vmaf)
    for k in names:
        _check_same(f"{label} {k}", out[k], single.features[k])


def _check_psnr_ssim(label, out, ref, dist, device, bit_depth):
    psnr, ssim = plane_metrics({"y": (upload(ref, device), upload(dist, device))},
                               bit_depth, True, True)
    _check_same(f"{label} psnr_y", out["psnr_y"], psnr["psnr_y"])
    _check_same(f"{label} ssim_y", out["ssim_y"], ssim["ssim_y"])


def dryrun_multichip(n_devices: int, device: Union[str, torch.device] = "cuda") -> str:
    """Run the three legs on an ``n_devices``-entry mesh over ``device``'s
    kind ("cuda": the visible cards, repeated when there are fewer; "cpu").
    Raises on any difference; returns the printed summary line."""
    device = resolve_device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
        where = (f"{n_devices} entries on {cards} card(s)"
                 + (", cards repeated" if cards < n_devices else ""))
    else:
        devices = [device] * n_devices
        where = f"{n_devices} entries on the CPU"
    first = devices[0]

    n_space = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_space
    mesh = make_mesh(n_data=n_data, n_space=n_space, devices=devices)
    n_frames = max(2 * n_data, 4)
    ref, dist = _make_clip(n_frames, 64 * n_space, 128, seed=1)

    # Leg 1: the 2-D mesh with PSNR/SSIM, the model's default family.
    out = make_sharded_scorer(mesh, "vmaf_v0.6.1", with_psnr_ssim=True)(ref, dist)
    single = score_clip(ref, dist, model="vmaf_v0.6.1", device=first)
    names = single.feature_names
    _check_scores("2-D", out, single, names)
    _check_psnr_ssim("2-D", out, ref, dist, first, 8)
    if not np.all((out["vmaf"] >= 0.0) & (out["vmaf"] <= 100.0)):
        raise AssertionError(f"dryrun 2-D: VMAF out of range {out['vmaf']}")

    # Leg 2: the same mesh, the integer family on a 10-bit source.
    ref10, dist10 = np.round(ref * 4.0) / 4.0, np.round(dist * 4.0) / 4.0
    out_i = make_sharded_scorer(mesh, "vmaf_v0.6.1", with_psnr_ssim=True,
                                precision="integer", bit_depth=10)(ref10, dist10)
    single_i = score_clip(ref10, dist10, model="vmaf_v0.6.1", precision="integer",
                          bit_depth=10, device=first)
    _check_scores("2-D integer 10-bit", out_i, single_i, names)
    _check_psnr_ssim("2-D integer 10-bit", out_i, ref10, dist10, first, 10)

    # Leg 3: the data-only scorer, then an integer 10-bit run through it.
    dmesh = make_mesh(n_data=n_devices, n_space=1, devices=devices)
    n2 = n_devices * max(2, -(-8 // n_devices))
    ref2, dist2 = _make_clip(n2, 64, 128, seed=2)
    out2 = make_shardmap_scorer(dmesh, "vmaf_v0.6.1")(ref2, dist2)
    _check_scores("data-only", out2, score_clip(ref2, dist2, device=first), names)
    r10, d10 = np.round(ref2 * 4.0) / 4.0, np.round(dist2 * 4.0) / 4.0
    out3 = make_shardmap_scorer(dmesh, "vmaf_v0.6.1", precision="integer",
                                bit_depth=10)(r10, d10)
    _check_scores("data-only integer 10-bit", out3,
                  score_clip(r10, d10, precision="integer", bit_depth=10, device=first),
                  names)

    line = (f"dryrun_multichip ok ({where}): mesh=({n_data}x{n_space}) frames={n_frames} "
            f"vmaf_mean={out['vmaf'].mean():.3f}; data-only mesh=({n_devices}x1) "
            f"frames={n2} vmaf_mean={out2['vmaf'].mean():.3f}; 2-D, 2-D integer 10-bit, "
            f"data-only and data-only integer 10-bit: VMAF, features, PSNR and SSIM "
            f"equal to single-device {first} in every bit")
    print(line, flush=True)
    return line
