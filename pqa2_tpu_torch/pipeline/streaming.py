"""Streaming clip scoring (port of pqa2_tpu/pipeline/streaming.py:stream_score).

A producer thread decodes paired ref/dist chunks into a bounded queue
while the device scores the previous chunk; y4m files are read through the
native frame pump (io/native.py, a C++ reader thread prefetching into a
ring) where it builds, other files through ``VideoReader``. One frame is
carried across each chunk boundary on both sides (the motion halo). PSNR
and SSIM run on all three planes beside the VMAF features; with both
enabled, one kernel pass per plane gives SSIM and the SSE.

Every tensor lives on the ``device`` argument; there is no other device
choice and no retry loop (the JAX package retries on transient TPU
"UNAVAILABLE" faults, which have no counterpart here).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pqa2_tpu_torch.io.video import VideoReader
from pqa2_tpu_torch.models.loader import BootstrapModel, VMAFModel
from pqa2_tpu_torch.models.registry import get_model
from pqa2_tpu_torch.pipeline.features import (
    extract_features_batched,
    fetch_features,
    model_feature_params,
)
from pqa2_tpu_torch.pipeline.scoring import (
    DEFAULT_CHUNK_SIZE,
    ClipScores,
    clip_scores,
    concat_parts,
    plane_metrics,
    resolve_device,
    upload,
)

logger = logging.getLogger(__name__)


def _open_reader(path: str):
    """The native threaded pump for y4m where it builds; else VideoReader
    (with a warning: the pump did not build)."""
    if str(path).lower().endswith(".y4m"):
        from pqa2_tpu_torch.io.native import NativeY4MReader, is_available

        if is_available():
            return NativeY4MReader(path)
        logger.warning("native frame pump unavailable; reading %s with VideoReader", path)
    return VideoReader(path)


def _reader_depth(reader) -> int:
    if hasattr(reader, "bit_depth"):
        return int(reader.bit_depth)
    if hasattr(reader, "info"):
        return int(reader.info.bit_depth)
    return 8


def _check_geometry(ref_r, dist_r, ref_path, dist_path) -> None:
    def geom(r):
        info = getattr(r, "info", r)
        return (info.width, info.height)

    rg, dg = geom(ref_r), geom(dist_r)
    if rg != dg:
        raise ValueError(
            f"resolution mismatch: reference {ref_path!r} is {rg[0]}x{rg[1]} "
            f"but distorted {dist_path!r} is {dg[0]}x{dg[1]}; align/scale the "
            f"inputs to a common geometry before scoring")


def _chunk_producer(ref_path, dist_path, chunk_size, out_q, max_frames, stop,
                    meta, subsample) -> None:
    """Read paired chunks; each queue item is (ref_frames, dist_frames, eof)
    or the exception that stopped the reader (pqa2_tpu streaming.py:68)."""
    readers = []
    try:
        ref_r = _open_reader(ref_path)
        readers.append(ref_r)
        dist_r = _open_reader(dist_path)
        readers.append(dist_r)
        meta["ref_depth"] = _reader_depth(ref_r)
        meta["dist_depth"] = _reader_depth(dist_r)
        _check_geometry(ref_r, dist_r, ref_path, dist_path)
        n_read = 0
        ref_buf: List[Dict] = []
        dist_buf: List[Dict] = []
        while not stop.is_set():
            rf = ref_r.read_frame()
            df = dist_r.read_frame()
            eof = rf is None or df is None
            if not eof:
                if n_read % subsample == 0:
                    ref_buf.append(rf)
                    dist_buf.append(df)
                n_read += 1
                if max_frames is not None and n_read >= max_frames:
                    eof = True
            if eof or len(ref_buf) == chunk_size:
                out_q.put((ref_buf, dist_buf, eof))
                ref_buf, dist_buf = [], []
                if eof:
                    return
    except Exception as e:
        logger.exception("producer failed")
        out_q.put(e)
    finally:
        for r in readers:
            r.close()


def stream_score(
    ref_path: str,
    dist_path: str,
    model: Union[str, VMAFModel, BootstrapModel] = "vmaf_v0.6.1",
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    max_frames: Optional[int] = None,
    with_psnr: bool = True,
    with_ssim: bool = True,
    frame_cb: Optional[Callable[[int], None]] = None,
    subsample: int = 1,
    precision: Optional[str] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> ClipScores:
    """Score two video files chunk by chunk on ``device``.

    subsample=k scores every k-th source frame (libvmaf n_subsample);
    precision overrides the model-driven extractor choice."""
    device = resolve_device(device)
    subsample = max(1, int(subsample))
    mdl = get_model(model) if isinstance(model, str) else model
    params = model_feature_params(mdl, precision, device=device)

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    meta: Dict = {}
    producer = threading.Thread(
        target=_chunk_producer,
        args=(ref_path, dist_path, chunk_size, q, max_frames, stop, meta, subsample),
        daemon=True)
    producer.start()

    feats_parts: List[Dict[str, np.ndarray]] = []
    psnr_parts: List[Dict[str, np.ndarray]] = []
    ssim_parts: List[Dict[str, np.ndarray]] = []
    prev_ref_tail: Optional[Dict] = None
    prev_dist_tail: Optional[Dict] = None
    pending: Optional[Tuple[List[Dict], List[Dict], bool]] = None
    total = 0

    try:
        while True:
            item = pending if pending is not None else q.get()
            pending = None
            if isinstance(item, Exception):
                raise item
            ref_frames, dist_frames, eof = item
            if not ref_frames:
                break
            # Peek one chunk ahead for the next-halo unless this is the end.
            next_head: Optional[Tuple[Dict, Dict]] = None
            if not eof:
                nxt = q.get()
                if isinstance(nxt, Exception):
                    raise nxt
                pending = nxt
                if nxt[0]:
                    next_head = (nxt[0][0], nxt[1][0])

            has_prev = prev_ref_tail is not None
            has_next = next_head is not None
            ref_y = [f["y"] for f in ref_frames]
            dist_y = [f["y"] for f in dist_frames]
            if has_prev:
                ref_y = [prev_ref_tail["y"]] + ref_y
                dist_y = [prev_dist_tail["y"]] + dist_y
            if has_next:
                ref_y = ref_y + [next_head[0]["y"]]
                dist_y = dist_y + [next_head[1]["y"]]
            ref_depth = meta.get("ref_depth", 8)
            dist_depth = meta.get("dist_depth", 8)
            ref_div = float(1 << (ref_depth - 8))
            dist_div = float(1 << (dist_depth - 8))
            depth = max(ref_depth, dist_depth)
            # A pair deeper than 8 bits scores both streams as f32 on the
            # 8-bit scale (a shallower stream left as codes would land
            # 2^(depth diff) dark in to_native_grid; pqa2_tpu
            # streaming.py:221-228).
            rb = upload(ref_y, device, ref_div)
            db = upload(dist_y, device, dist_div)
            if depth > 8:
                rb, db = rb.float(), db.float()
            feats = extract_features_batched(rb, db, has_prev=has_prev,
                                             has_next=has_next, bit_depth=depth,
                                             **params)
            feats_parts.append(fetch_features(feats))

            if with_psnr or with_ssim:
                # Luma reuses the tensors uploaded for the features (core
                # frames, without the motion halo).
                core = slice(1 if has_prev else 0, (1 if has_prev else 0) + len(ref_frames))
                planes = {"y": (rb[core].float(), db[core].float())}
                for p in "uv":
                    planes[p] = (upload([f[p] for f in ref_frames], device, ref_div).float(),
                                 upload([f[p] for f in dist_frames], device, dist_div).float())
                pstats, sstats = plane_metrics(planes, depth, with_psnr, with_ssim)
                if pstats is not None:
                    psnr_parts.append(pstats)
                if sstats is not None:
                    ssim_parts.append(sstats)

            total += len(ref_frames)
            if frame_cb is not None:
                frame_cb(len(ref_frames))
            prev_ref_tail = ref_frames[-1]
            prev_dist_tail = dist_frames[-1]
            if eof:
                break
    finally:
        stop.set()
        # Drain so the producer is never blocked on put().
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        producer.join(timeout=5.0)

    if total == 0:
        raise ValueError("empty input video")

    max_depth = max(meta.get("ref_depth", 8), meta.get("dist_depth", 8))
    return clip_scores(mdl, concat_parts(feats_parts), device=device,
                       psnr=concat_parts(psnr_parts), ssim=concat_parts(ssim_parts),
                       peak=float((1 << max_depth) - 1), frame_step=subsample)
