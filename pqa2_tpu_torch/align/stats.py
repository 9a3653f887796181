"""Per-frame luma statistics for bookend detection (port of pqa2_tpu/align/stats.py).

One pass over each chunk of frames on ``device`` gives every frame's mean,
standard deviation, 256-bin histogram and 8x8 block-mean thumbnail, packed
into one (n, 2 + 256 + 64) f32 block that comes back to the host: detection
reads the statistics (any white-pixel-ratio threshold is then a lookup in the
histogram's suffix sums) and the cross-correlation refinement reads the
thumbnails. The JAX package's ``_stats_chunk`` and ``_stats_thumb_chunk``
are one function here: the thumbnails come from the same read.

Means and thumbnails are float64 sums rounded to f32 and multiplied by the
f32 reciprocal of the pixel count, as XLA computes the JAX package's f32
means. The luma the package hands over is 8-bit codes, or codes divided by
2^(depth-8), so the float64 sums are exact: the means and thumbnails are the
same bits on the CPU and on the card whatever order the reduction takes, and
the JAX package's wherever its f32 sums are exact too (frames below 2^16
pixels). The standard deviation is the two-pass form in float64: E[x^2] -
mean^2 cancels on bright uniform frames, which are the bookend case.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

CHUNK = 64
# Frames taken at a time: their float64 copy is 133 MB at 1080p (a whole
# 64-frame chunk's would be 1 GB), and their 8 x 256 histogram bins fit in a
# block's shared memory, where torch.bincount counts on the card. A chunk's
# 64 x 256 int64 bins do not, and counted in global memory a uniform
# frame's pixels all contend for one bin: 2.5-5x slower
# (tools/stats_pass_ablation.py; PERF.md section 6).
_SUB = 8


def _mean(sums: torch.Tensor, count: int) -> torch.Tensor:
    """float64 sums of ``count`` values -> f32 means, XLA's way: the f32 sum
    times the f32 reciprocal of the count."""
    return sums.float() * (1.0 / count)


def _thumbs(x: torch.Tensor) -> torch.Tensor:
    """(k, H, W) float64 -> (k, 64) f32 block means over the frame cropped
    to (H//8)*8 x (W//8)*8."""
    k, h, w = x.shape
    bh, bw = h // 8, w // 8
    blocks = x[:, : bh * 8, : bw * 8].reshape(k, 8, bh, 8, bw)
    return _mean(blocks.sum(dim=(2, 4)).reshape(k, 64), bh * bw)


def _stats_thumb_chunk(frames: torch.Tensor) -> torch.Tensor:
    """(n, H, W) frames on the device -> (n, 2 + 256 + 64) f32: mean, std,
    histogram and thumbnail of each frame. Histogram counts are exact in f32
    up to 2^24 pixels a frame (3840x2160 is 8.3 M)."""
    n, h, w = frames.shape
    out = torch.empty((n, 2 + 256 + 64), dtype=torch.float32, device=frames.device)
    offsets = torch.arange(_SUB, dtype=torch.int32, device=frames.device).view(-1, 1, 1) * 256
    for s in range(0, n, _SUB):
        sub = frames[s : s + _SUB]
        k = sub.shape[0]
        # The histogram bins clip(int(x), 0, 255): the cast truncates toward
        # zero, as the JAX package's astype(int32) does. One bincount for the
        # frames, each frame's bins offset by 256 * its index.
        idx = sub.to(torch.int32).clamp_(0, 255).add_(offsets[:k])
        out[s : s + k, 2:258] = torch.bincount(idx.view(-1), minlength=k * 256).view(k, 256)
        del idx
        x = sub.to(torch.float64)
        sums = x.sum(dim=(1, 2))
        d = x - (sums / (h * w)).view(-1, 1, 1)
        out[s : s + k, 0] = _mean(sums, h * w)
        out[s : s + k, 1] = (d * d).sum(dim=(1, 2)).div_(h * w).sqrt_()
        del d
        out[s : s + k, 258:] = _thumbs(x)
    return out


def _thumb_chunk(frames: torch.Tensor) -> torch.Tensor:
    """(n, H, W) frames on the device -> (n, 64) f32 thumbnails, the same
    values as :func:`_stats_thumb_chunk`'s."""
    return torch.cat([_thumbs(frames[s : s + _SUB].to(torch.float64))
                      for s in range(0, frames.shape[0], _SUB)])


def _finish_stats(mean, std, hist, h, w) -> Dict[str, np.ndarray]:
    stats = {"mean": mean, "std": std, "hist": hist}
    # Suffix-sum of histogram: white_count[t] = #pixels with value > t.
    above = np.cumsum(hist.astype(np.int64)[:, ::-1], axis=1)[:, ::-1]
    stats["pixels"] = h * w
    stats["_above"] = above
    return stats


def _packed(luma, chunk_size: int, device) -> np.ndarray:
    """The packed block of every frame of ``luma``, chunk by chunk: a tensor
    on ``device`` is sliced where it lies, anything else is uploaded a chunk
    at a time; one block per chunk comes back to the host."""
    device = resolve_device(device)
    return np.concatenate([
        _stats_thumb_chunk(upload(luma[s : s + chunk_size], device)).cpu().numpy()
        for s in range(0, luma.shape[0], chunk_size)])


def stats_and_thumbs(luma, chunk_size: int = CHUNK, *,
                     device: Union[str, torch.device] = "cuda"):
    """(N, H, W) luma (numpy or a tensor) -> (stats dict, (N, 64)
    thumbnails), one packed device round trip per chunk. The combined pass
    for bookend alignment: detection reads the stats, xcorr refinement reads
    the thumbnails."""
    packed = _packed(luma, chunk_size, device)
    stats = _finish_stats(packed[:, 0], packed[:, 1], packed[:, 2:258],
                          luma.shape[-2], luma.shape[-1])
    return stats, packed[:, 258:]


def frame_luma_stats(luma, chunk_size: int = CHUNK, *,
                     device: Union[str, torch.device] = "cuda") -> Dict[str, np.ndarray]:
    """(N, H, W) luma (uint8 or float in [0,255]) -> per-frame stats.

    Returns dict with mean (N,), std (N,), hist (N, 256) int32 and
    white_ratio(threshold) support via cumulative histogram.
    """
    packed = _packed(luma, chunk_size, device)
    return _finish_stats(packed[:, 0], packed[:, 1], packed[:, 2:258].astype(np.int32),
                         luma.shape[-2], luma.shape[-1])


def white_ratio(stats: Dict[str, np.ndarray], threshold: float) -> np.ndarray:
    """Fraction of pixels strictly above `threshold` per frame, from the
    precomputed histograms."""
    t = int(np.floor(threshold)) + 1  # strictly greater
    if t > 255:
        return np.zeros(stats["_above"].shape[0])
    t = max(t, 0)
    return stats["_above"][:, t] / stats["pixels"]
