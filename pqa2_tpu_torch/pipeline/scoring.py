"""Clip-level scoring in memory: chunked features with the one-frame halo,
SVR fusion, PSNR/SSIM, pooling (port of ``pqa2_tpu/pipeline/scoring.py``).

``ClipScores`` (:33), ``pool_metric`` (:79), ``bootstrap_ci`` (:95) and
``iter_chunks`` (:130) are value-for-value the JAX module's. The entry
points :func:`score_clip`, :func:`score_planes`, :func:`extract_clip_features`
and :func:`score_features` (:108-393) take numpy arrays or tensors (luma
may already lie on the device, as the decode-once workflow hands it over)
and run on ``device``: ``cuda`` runs the kernels, ``cpu`` their plain
versions. Each chunk is uploaded in its source dtype (8-bit luma stays
uint8), as :mod:`pipeline.streaming` does, which shares :func:`upload`,
:func:`score_features` and :func:`plane_metrics` with this module.

The JAX package pads the last chunk to a fixed frame count (XLA compiles
one program per shape) and restores ``motion2`` at the clip end after it
(:184-187). PyTorch needs no fixed shape, so the last chunk runs as it is,
``ops/motion.py:features_from_sad_prev`` gives the clip-end ``motion2``
directly, and a clip scored in chunks equals the whole clip
(tests/test_torch_inmemory.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pqa2_tpu_torch._device import require_cuda
from pqa2_tpu_torch.models.loader import BootstrapModel, VMAFModel
from pqa2_tpu_torch.models.registry import get_model
from pqa2_tpu_torch.models.svr import BootstrapPredictor, predictor_for_model
from pqa2_tpu_torch.ops.cuda_ssim import ssim_sse_plane
from pqa2_tpu_torch.ops.psnr import psnr_from_mse_np, psnr_planes_batched
from pqa2_tpu_torch.ops.ssim import ssim_db_np
from pqa2_tpu_torch.pipeline.features import (
    extract_features_batched,
    fetch_features,
    model_feature_params,
)
from pqa2_tpu_torch.utils.profiling import span, to_host

DEFAULT_CHUNK_SIZE = 32

POOL_METHODS = ("mean", "min", "max", "harmonic_mean")


@dataclasses.dataclass
class ClipScores:
    """Per-frame metrics + model metadata for one scored clip."""

    model_name: str
    feature_names: tuple
    features: Dict[str, np.ndarray]  # per-frame feature arrays (N,)
    vmaf: np.ndarray  # (N,) per-frame VMAF scores
    bootstrap: Optional[np.ndarray] = None  # (M, N) per-sub-model scores
    psnr: Optional[Dict[str, np.ndarray]] = None
    ssim: Optional[Dict[str, np.ndarray]] = None
    # Native PSNR peak (255 for 8-bit, 1023 for 10-bit, ...): the scale the
    # stored mse_* values live on.
    peak: float = 255.0
    # Whether the model was trained on the integer_* feature extractors
    # (drives the metric key prefix in the libvmaf-schema JSON).
    uses_integer_features: bool = True
    # Distance between scored frames in source-frame indices (n_subsample).
    frame_step: int = 1

    @property
    def n_frames(self) -> int:
        return int(self.vmaf.shape[0])

    def pooled(self, method: str = "mean") -> Dict[str, float]:
        """Pooled value per metric (vmaf + features), one method."""
        out = {"vmaf": pool_metric(self.vmaf, method)}
        for k, v in self.features.items():
            out[k] = pool_metric(v, method)
        return out

    def pooled_all(self) -> Dict[str, Dict[str, float]]:
        """libvmaf-style pooled_metrics: {metric: {min/max/mean/harmonic_mean}}."""
        metrics = {"vmaf": self.vmaf, **self.features}
        if self.bootstrap is not None:
            lo, hi, stddev = bootstrap_ci(self.bootstrap)
            metrics["vmaf_bagging"] = self.bootstrap.mean(axis=0)
            metrics["vmaf_stddev"] = stddev
            metrics["vmaf_ci_p95_lo"] = lo
            metrics["vmaf_ci_p95_hi"] = hi
        return {
            name: {m: pool_metric(vals, m) for m in POOL_METHODS}
            for name, vals in metrics.items()
        }


def pool_metric(values: np.ndarray, method: str = "mean") -> float:
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return 0.0
    if method == "mean":
        return float(values.mean())
    if method == "min":
        return float(values.min())
    if method == "max":
        return float(values.max())
    if method == "harmonic_mean":
        # libvmaf's harmonic mean shifts by 1 to tolerate zeros.
        return float(values.size / np.sum(1.0 / (1.0 + values)) - 1.0)
    raise ValueError(f"unknown pool method {method!r}")


def bootstrap_ci(scores: np.ndarray, alpha: float = 0.95):
    """(M, N) bootstrap sub-model scores -> (ci_lo, ci_hi, stddev) per frame:
    mean +/- 1.96 * stddev of models 1..M-1 (model 0 is the primary)."""
    boot = scores[1:] if scores.shape[0] > 1 else scores
    mean = boot.mean(axis=0)
    std = boot.std(axis=0, ddof=1) if boot.shape[0] > 1 else np.zeros_like(mean)
    z = 1.959963984540054
    return mean - z * std, mean + z * std, std


def iter_chunks(n: int, chunk_size: int):
    """Yield (start, stop, has_prev, has_next) chunk bounds over n frames."""
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        yield start, stop, start > 0, stop < n


Model = Union[str, VMAFModel, BootstrapModel]


def _resolve_model(model: Model):
    if isinstance(model, str):
        return get_model(model)
    return model


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be a card the
    kernels are built for (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        device = require_cuda(device)
    return device


def upload(frames, device: torch.device, div: float = 1.0) -> torch.Tensor:
    """(N, H, W) frames on ``device`` in their source dtype: a list of 2-D
    numpy planes, a numpy array or a tensor (moved only when it lies
    elsewhere): 8-bit luma goes up as bytes. uint16 travels as int32
    (torch has no general uint16 ops); with ``div`` = 2^(depth-8) > 1 the
    codes come onto the 8-bit scale on the device. Spans
    ``scoring.upload.stack`` (host numpy work) and ``scoring.upload.copy``
    (``htod_bytes``: the bytes copied, 0 for a tensor already there)."""
    if isinstance(frames, torch.Tensor):
        with span("scoring.upload.copy",
                  htod_bytes=0 if frames.device == torch.device(device) else frames.nbytes):
            t = frames.to(device)
    else:
        with span("scoring.upload.stack"):
            a = np.stack(frames) if isinstance(frames, (list, tuple)) else np.asarray(frames)
            if a.dtype == np.uint16:
                a = a.astype(np.int32)
            a = np.ascontiguousarray(a)
        with span("scoring.upload.copy", htod_bytes=a.nbytes):
            t = torch.from_numpy(a).to(device)
    if div != 1.0:
        t = t.float() / div
    return t.contiguous()


def score_features(features: Dict[str, np.ndarray], model: Model = "vmaf_v0.6.1", *,
                   device: Union[str, torch.device] = "cuda"):
    """Feature dict -> (vmaf (N,), bootstrap (M, N) or None), host numpy:
    the model's SVR on ``device`` (span ``scoring.svr``)."""
    with span("scoring.svr"):
        device = resolve_device(device)
        mdl = _resolve_model(model)
        x = torch.as_tensor(np.stack([features[k] for k in mdl.feature_names], axis=-1),
                            dtype=torch.float32, device=device)
        predictor = predictor_for_model(mdl, device=device)
        with torch.no_grad():
            if isinstance(predictor, BootstrapPredictor):
                vmaf, boot = predictor(x)
                return to_host(vmaf), to_host(boot)
            return to_host(predictor(x)), None


def plane_metrics(planes: Dict[str, Tuple[torch.Tensor, torch.Tensor]], bit_depth: int,
                  with_psnr: bool, with_ssim: bool):
    """Per-frame PSNR and SSIM of one chunk -> (psnr dict or None, ssim dict
    or None), host numpy (N,) arrays under the ``ClipScores`` keys.

    ``planes``: {"y", "u", "v"} -> (ref, dist) (N, H, W) f32 on the 8-bit
    scale. With both metrics one kernel pass per plane gives SSIM and the
    SSE; the 8-bit-scale SSE rescales exactly to native codes (PSNR at the
    native peak). Span ``scoring.plane_metrics``."""
    with span("scoring.plane_metrics"):
        return _plane_metrics(planes, bit_depth, with_psnr, with_ssim)


def _plane_metrics(planes, bit_depth: int, with_psnr: bool, with_ssim: bool):
    max_div = float(1 << (bit_depth - 8))
    peak = float((1 << bit_depth) - 1)
    psnr = ssim = None
    if with_psnr and with_ssim:
        ssim, psnr = {}, {}
        tot, tot_w, tot_sse = 0.0, 0, 0.0
        for p, (r, d) in planes.items():
            vv, sse8 = ssim_sse_plane(r.contiguous(), d.contiguous(), bit_depth=bit_depth)
            vv = to_host(vv)
            ssim[f"ssim_{p}"] = vv
            w = r.shape[-2] * r.shape[-1]
            tot = tot + vv * w
            tot_w += w
            sse = to_host(sse8) * (max_div * max_div)
            psnr[f"mse_{p}"] = sse / w
            psnr[f"psnr_{p}"] = psnr_from_mse_np(sse / w, max_value=peak)
            tot_sse = tot_sse + sse
        psnr["mse_avg"] = tot_sse / tot_w
        psnr["psnr_avg"] = psnr_from_mse_np(psnr["mse_avg"], max_value=peak)
    elif with_psnr:
        psnr = psnr_planes_batched(*(planes[p][0] for p in "yuv"),
                                   *(planes[p][1] for p in "yuv"))
        for p in ("y", "u", "v", "avg"):
            psnr[f"mse_{p}"] = psnr[f"mse_{p}"] * (max_div * max_div)
            psnr[f"psnr_{p}"] = psnr_from_mse_np(psnr[f"mse_{p}"], max_value=peak)
    elif with_ssim:
        ssim = {}
        tot, tot_w = 0.0, 0
        for p, (r, d) in planes.items():
            vv = to_host(ssim_sse_plane(r.contiguous(), d.contiguous(),
                                        bit_depth=bit_depth)[0])
            ssim[f"ssim_{p}"] = vv
            w = r.shape[-2] * r.shape[-1]
            tot = tot + vv * w
            tot_w += w
    if ssim is not None:
        ssim["ssim_all"] = tot / tot_w
        ssim["ssim_db"] = ssim_db_np(ssim["ssim_all"])
    return psnr, ssim


def concat_parts(parts: List[Dict[str, np.ndarray]]) -> Optional[Dict[str, np.ndarray]]:
    """Per-chunk dicts of per-frame arrays -> one dict over the clip (None
    when there are no parts)."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]} if parts else None


def clip_scores(mdl, features: Dict[str, np.ndarray], *, device: torch.device,
                **fields) -> ClipScores:
    """The clip's ``ClipScores``: the model's VMAF of ``features``
    (:func:`score_features`) and its metadata, plus ``fields``."""
    vmaf, boot = score_features(features, mdl, device=device)
    return ClipScores(
        model_name=mdl.name if hasattr(mdl, "name") else str(mdl),
        feature_names=tuple(mdl.feature_names),
        features=features,
        vmaf=vmaf,
        bootstrap=boot,
        uses_integer_features=getattr(mdl, "uses_integer_features", True),
        **fields,
    )


def _score_chunks(ref_y, dist_y, *, device: torch.device, chunk_size: int,
                  feature_params: Dict, bit_depth: int, ref_div: float = 1.0,
                  dist_div: float = 1.0, ref_planes=None, dist_planes=None,
                  with_psnr: bool = False, with_ssim: bool = False,
                  frame_cb: Optional[Callable[[int], None]] = None):
    """The in-memory chunk loop: features of every chunk (luma ``ref_y``/
    ``dist_y`` indexed by frame, uploaded with :func:`upload` and its
    ``div``, one frame of halo on each side where the clip goes on) and,
    with ``ref_planes``, PSNR/SSIM over Y/U/V of its core frames (luma
    reused from the features' upload). Returns (features, psnr or None,
    ssim or None), host numpy."""
    n = len(ref_y)
    feats, psnr, ssim = [], [], []
    for start, stop, has_prev, has_next in iter_chunks(n, chunk_size):
        lo = start - (1 if has_prev else 0)
        hi = stop + (1 if has_next else 0)
        rb = upload(ref_y[lo:hi], device, ref_div)
        db = upload(dist_y[lo:hi], device, dist_div)
        if rb.dtype != db.dtype:
            # Codes of one side and the 8-bit scale of the other: both as
            # f32 on the 8-bit scale (pipeline/streaming.py does the same).
            rb, db = rb.float(), db.float()
        out = extract_features_batched(rb, db, has_prev=has_prev, has_next=has_next,
                                       bit_depth=bit_depth, **feature_params)
        feats.append(fetch_features(out))
        if ref_planes is not None and (with_psnr or with_ssim):
            core = slice(start - lo, stop - lo)
            cdiv = float(1 << (bit_depth - 8))
            planes = {"y": (rb[core].float(), db[core].float())}
            for p in "uv":
                planes[p] = (upload([f[p] for f in ref_planes[start:stop]], device, cdiv).float(),
                             upload([f[p] for f in dist_planes[start:stop]], device, cdiv).float())
            ps, ss = plane_metrics(planes, bit_depth, with_psnr, with_ssim)
            for acc, part in ((psnr, ps), (ssim, ss)):
                if part is not None:
                    acc.append(part)
        if frame_cb is not None:
            frame_cb(stop - start)
    return concat_parts(feats), concat_parts(psnr), concat_parts(ssim)


def extract_clip_features(
    ref_luma,
    dist_luma,
    *,
    model: Optional[Model] = None,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    feature_params: Optional[Dict] = None,
    frame_cb: Optional[Callable[[int], None]] = None,
    precision: Optional[str] = None,
    bit_depth: int = 8,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Whole-clip features, chunk by chunk with the one-frame halo.

    ref_luma/dist_luma: (N, H, W) numpy arrays or tensors, codes or f32 on
    the 8-bit scale (``bit_depth`` lets the integer family recover the
    native codes). ``precision`` overrides the model's feature family
    (:func:`pipeline.features.resolve_precision`)."""
    device = resolve_device(device)
    if feature_params is None:
        feature_params = (model_feature_params(_resolve_model(model), precision,
                                               device=device) if model else {})
    feats, _, _ = _score_chunks(ref_luma, dist_luma, device=device, chunk_size=chunk_size,
                                feature_params=feature_params, bit_depth=bit_depth,
                                frame_cb=frame_cb)
    return feats


def score_clip(
    ref_luma,
    dist_luma,
    model: Model = "vmaf_v0.6.1",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    subsample: int = 1,
    frame_cb: Optional[Callable[[int], None]] = None,
    precision: Optional[str] = None,
    bit_depth: int = 8,
    *,
    device: Union[str, torch.device] = "cuda",
) -> ClipScores:
    """Luma batches -> per-frame VMAF, the in-memory scoring entry point.

    subsample=k scores every k-th frame with libvmaf's semantics: the
    features, motion included, run between the sampled frames only.
    frame_cb(n) is called after each chunk with its frame count."""
    device = resolve_device(device)
    mdl = _resolve_model(model)
    if subsample > 1:
        ref_luma = ref_luma[::subsample]
        dist_luma = dist_luma[::subsample]
    feats = extract_clip_features(ref_luma, dist_luma, model=mdl, chunk_size=chunk_size,
                                  frame_cb=frame_cb, precision=precision,
                                  bit_depth=bit_depth, device=device)
    return clip_scores(mdl, feats, device=device, frame_step=subsample)


def score_planes(
    ref_planes: Sequence[Dict[str, np.ndarray]],
    dist_planes: Sequence[Dict[str, np.ndarray]],
    model: Model = "vmaf_v0.6.1",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    with_psnr: bool = True,
    with_ssim: bool = True,
    frame_cb: Optional[Callable[[int], None]] = None,
    bit_depth: int = 8,
    subsample: int = 1,
    precision: Optional[str] = None,
    ref_y=None,
    dist_y=None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> ClipScores:
    """Full scoring of planar YUV frame lists (``io.VideoReader`` output):
    VMAF on luma, PSNR/SSIM over all three planes.

    ``bit_depth``: the source depth; >8-bit planes are scored on the 8-bit
    scale (SSIM with ffmpeg's native-max constants mapped onto it, PSNR at
    the native peak). subsample=k keeps every k-th frame. ``ref_y``/
    ``dist_y``: optionally the (N, H, W) luma already on the 8-bit scale,
    numpy or tensors on the device (not copied back to the host). The
    chunks are those of :func:`pipeline.streaming.stream_score`, so both
    give the same per-frame values for the same frames."""
    device = resolve_device(device)
    mdl = _resolve_model(model)
    subsample = max(1, int(subsample or 1))
    if subsample > 1:
        ref_planes = ref_planes[::subsample]
        dist_planes = dist_planes[::subsample]
        ref_y = ref_y[::subsample] if ref_y is not None else None
        dist_y = dist_y[::subsample] if dist_y is not None else None
    div = float(1 << (bit_depth - 8))
    ref_div = dist_div = 1.0
    if ref_y is None:
        ref_y, ref_div = [f["y"] for f in ref_planes], div
    if dist_y is None:
        dist_y, dist_div = [f["y"] for f in dist_planes], div
    feats, psnr, ssim = _score_chunks(
        ref_y, dist_y, device=device, chunk_size=chunk_size,
        feature_params=model_feature_params(mdl, precision, device=device),
        bit_depth=bit_depth, ref_div=ref_div, dist_div=dist_div, ref_planes=ref_planes,
        dist_planes=dist_planes, with_psnr=with_psnr, with_ssim=with_ssim,
        frame_cb=frame_cb)
    return clip_scores(mdl, feats, device=device, psnr=psnr, ssim=ssim,
                       peak=float((1 << bit_depth) - 1), frame_step=subsample)
