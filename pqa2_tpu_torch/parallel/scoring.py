"""Frame-parallel scoring over a device mesh (port of
pqa2_tpu/parallel/scoring.py).

The JAX package has two sharded programs: a pjit program whose XLA
partitioner splits frames over "data" and frame rows over "space" on the
plain XLA ops (``make_sharded_scorer``), and a shard_map program that runs
the Pallas kernels per shard with the motion halo exchanged by two
``ppermute``s (``make_shardmap_scorer``). The port runs one code path for
both: the frames are laid out as contiguous ranges over the mesh's entries
(:func:`parallel.mesh.shard_frames`), each range goes through the port's
own :func:`pipeline.features.extract_features_batched` on its device, so
on the card it runs the CUDA kernels (1-4 for the integer family, 1f/3/4
for ``integer_fast``, 4-7 for the float family), and the features come
back to the host per chunk, as :func:`pipeline.scoring.score_clip`'s do,
where they are concatenated in frame order; the SVR then runs once over
all N frames on the mesh's first device. Per-frame features and VMAF are
therefore the single-device ``score_clip``'s in every bit.

The motion halo: a range's first chunk takes the previous range's last
frame, and its last chunk the next range's first frame, by a
device-to-device ``.to()`` copy (the counterpart of the two ``ppermute``s);
``has_prev``/``has_next`` are true exactly where the clip goes on, as
:func:`pipeline.scoring.iter_chunks` sets them. The JAX shard_map program
duplicates the edge frames instead and then restores ``motion2`` at the
clip end; with the true neighbour frames neither is needed, and the results
are the same.

One worker thread runs per distinct device of the mesh, and it enters
``torch.cuda.device`` itself; entries that share a device run in order on
that device's thread.

Not carried over: the row split of "space". XLA's partitioner split one
frame's rows so that a 4K frame's filters could spread over chips short of
HBM; an 80 GB card holds a 4K f32 pair (~66 MB) many times over, and
kernels 1, 3 and 4 pool per-frame sums over whole frames, so a row split
would need banded pooling inside each of them. A 2-D mesh therefore lays
whole frames over all ``n_data * n_space`` entries.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from pqa2_tpu_torch.models.loader import BootstrapModel, VMAFModel
from pqa2_tpu_torch.models.registry import get_model
from pqa2_tpu_torch.ops.cuda_vif_int import log2_table_audit
from pqa2_tpu_torch.parallel.mesh import SPACE_AXIS, Mesh, ShardedFrames, shard_frames
from pqa2_tpu_torch.pipeline.features import (
    extract_features_batched,
    fetch_features,
    model_feature_params,
)
from pqa2_tpu_torch.pipeline.scoring import (
    DEFAULT_CHUNK_SIZE,
    concat_parts,
    plane_metrics,
    score_features,
)

Model = Union[str, VMAFModel, BootstrapModel]


def _placed(frames, mesh: Mesh) -> ShardedFrames:
    if isinstance(frames, ShardedFrames):
        if frames.mesh is not mesh:
            raise ValueError("frames were sharded over another mesh")
        return frames
    return shard_frames(frames, mesh)


def _with_halo(shards, i: int, lo: int, hi: int) -> torch.Tensor:
    """Frames [lo, hi) of the clip on shard i's device: its own frames, and
    at most one frame of each neighbour shard, copied over."""
    s = shards[i]
    parts = []
    if lo < s.start:
        parts.append(shards[i - 1].frames[-1:].to(s.device))
    parts.append(s.frames[max(lo, s.start) - s.start:min(hi, s.stop) - s.start])
    if hi > s.stop:
        parts.append(shards[i + 1].frames[:1].to(s.device))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _per_device(shards, fn: Callable[[int], object]) -> List[object]:
    """``fn(i)`` for every shard i, on one worker thread per distinct
    device (inside ``torch.cuda.device`` there); shards that share a device
    run in order. Returns the results in shard order."""
    groups: Dict[torch.device, List[int]] = {}
    for i, s in enumerate(shards):
        groups.setdefault(s.device, []).append(i)
    results: List[object] = [None] * len(shards)

    def work(device, idxs):
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx, torch.no_grad():
            for i in idxs:
                results[i] = fn(i)

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(groups)) as ex:
        futures = [ex.submit(work, d, idxs) for d, idxs in groups.items()]
        for f in futures:
            f.result()
    return results


def _sharded_features(ref: ShardedFrames, dist: ShardedFrames, params: Dict,
                      bit_depth: int, with_psnr_ssim: bool = False,
                      chunk_size: int = DEFAULT_CHUNK_SIZE):
    """Per-frame features (and ``psnr_y``/``ssim_y``) of two batches laid
    over one mesh -> host numpy dict over all N frames, in frame order."""
    if [(s.start, s.stop) for s in ref.shards] != [(s.start, s.stop) for s in dist.shards]:
        raise ValueError(f"ref ({ref.n} frames) and dist ({dist.n} frames) are laid out "
                         f"differently over the mesh")
    n = ref.n
    if n == 0:
        raise ValueError("empty frame batch")
    if params.get("precision") == "integer":
        for d in ref.mesh.distinct():
            log2_table_audit(d)

    def shard(i):
        s = ref.shards[i]
        parts = []
        for start in range(s.start, s.stop, chunk_size):
            stop = min(start + chunk_size, s.stop)
            has_prev, has_next = start > 0, stop < n
            lo, hi = start - has_prev, stop + has_next
            rb = _with_halo(ref.shards, i, lo, hi)
            db = _with_halo(dist.shards, i, lo, hi)
            if rb.dtype != db.dtype:
                rb, db = rb.float(), db.float()
            part = fetch_features(extract_features_batched(
                rb, db, has_prev=has_prev, has_next=has_next, bit_depth=bit_depth, **params))
            if with_psnr_ssim:
                core = slice(start - lo, stop - lo)
                psnr, ssim = plane_metrics({"y": (rb[core].float(), db[core].float())},
                                           bit_depth, True, True)
                part["psnr_y"], part["ssim_y"] = psnr["psnr_y"], ssim["ssim_y"]
            parts.append(part)
        return parts

    return concat_parts([p for parts in _per_device(ref.shards, shard) for p in parts])


def sharded_extract(ref, dist, mesh: Mesh, bit_depth: int = 8,
                    **feature_params) -> Dict[str, np.ndarray]:
    """Per-frame features of an (N, H, W) pair laid over every entry of
    ``mesh`` (host arrays, tensors or :func:`shard_frames` results) ->
    host numpy (N,) arrays. ``feature_params`` are
    :func:`pipeline.features.extract_features_batched`'s keywords."""
    return _sharded_features(_placed(ref, mesh), _placed(dist, mesh), feature_params,
                             bit_depth)


def _make_step(mesh: Mesh, model: Model, precision: Optional[str], bit_depth: int,
               with_psnr_ssim: bool):
    mdl = get_model(model) if isinstance(model, str) else model
    params = model_feature_params(mdl, precision, device=mesh.entries[0])

    def step(ref, dist) -> Dict[str, np.ndarray]:
        feats = _sharded_features(_placed(ref, mesh), _placed(dist, mesh), params,
                                  bit_depth, with_psnr_ssim)
        vmaf, boot = score_features(feats, mdl, device=mesh.entries[0])
        out = {"vmaf": vmaf}
        if boot is not None:
            out["vmaf_bootstrap"] = boot
        out.update(feats)
        return out

    return step


def make_sharded_scorer(
    mesh: Mesh,
    model: Model = "vmaf_v0.6.1",
    with_psnr_ssim: bool = False,
    precision: Optional[str] = None,
    bit_depth: int = 8,
):
    """A scoring step over every entry of a ("data", "space") mesh.

    Returns fn(ref, dist) -> dict with 'vmaf' (N,) + per-feature arrays
    (+ 'vmaf_bootstrap' (M, N) for a bootstrap model, + psnr_y/ssim_y when
    ``with_psnr_ssim``), host numpy. Inputs are (N, H, W) batches: host
    arrays or tensors, or :func:`parallel.mesh.shard_frames` results.

    >8-bit sources: pass luma as f32 on the 8-bit scale with ``bit_depth``
    set; PSNR uses the native peak and SSIM ffmpeg's native-max constants
    (stream_score's rules, through :func:`pipeline.scoring.plane_metrics`
    and kernel 4)."""
    return _make_step(mesh, model, precision, bit_depth, with_psnr_ssim)


def make_shardmap_scorer(
    mesh: Mesh,
    model: Model = "vmaf_v0.6.1",
    precision: Optional[str] = None,
    bit_depth: int = 8,
):
    """Frame-parallel scorer over a data-only mesh (space=1): the same step
    as :func:`make_sharded_scorer` without PSNR/SSIM. Any N."""
    if mesh.shape[SPACE_AXIS] != 1:
        raise ValueError("make_shardmap_scorer needs a data-only mesh "
                         "(space=1); use make_sharded_scorer for 2-D")
    return _make_step(mesh, model, precision, bit_depth, False)


def score_clip_sharded(
    ref_luma,
    dist_luma,
    mesh: Mesh,
    model: Model = "vmaf_v0.6.1",
    precision: Optional[str] = None,
    scorer=None,
    bit_depth: int = 8,
):
    """Whole-clip scoring over the mesh's data axis for any N.

    >8-bit sources: pass luma as f32 on the 8-bit scale (codes /
    2^(depth-8)) with ``bit_depth`` set. The JAX package pads N up to a
    multiple of the data axis (shard_map needs even shards) and
    re-predicts the last real frame; ranges of unequal length need no pad.

    Pass ``scorer`` (a :func:`make_shardmap_scorer` result) to reuse its
    setup across clips, as the batch ladder does. Returns writable numpy
    arrays {"vmaf": (N,), <feature>: (N,), "n_frames": N}, plus
    "vmaf_bootstrap" (M, N) for a bootstrap model."""
    if scorer is None:
        scorer = make_shardmap_scorer(mesh, model, precision, bit_depth=bit_depth)
    res = {k: np.array(v) for k, v in scorer(ref_luma, dist_luma).items()}
    res["n_frames"] = int(res["vmaf"].shape[0])
    return res
