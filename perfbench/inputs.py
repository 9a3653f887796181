"""The one generator of the benchmark's inputs: a cell's clips, made from
``--seed`` on the card, as its traffic file describes them.

A traffic file (``perfbench/workloads/<cell>.json``) gives the clip length,
the ladder's rungs (blur radius and noise of each distorted clip) and how
the requests reach the program (``entry``: ``frames`` hands decoded planes
with the luma already on the card to ``VMAFAnalyzer.analyze_frames``,
``files`` writes y4m files for ``VMAFAnalyzer.analyze_videos``). The
configuration gives the frame size and the bit depth.

Content: smooth fields moving 3 pixels a frame (a sum of sines with phases
from the seed), each rung a (2r+1)^2 box blur of the reference plus uniform
noise. Chroma is the luma's 2x2 mean (U) and its complement (V). Past 8
bits the codes are the 8-bit field x 2^(depth-8) plus code noise in
[0, 2^(depth-8)). Every seed gives clips of the same sizes and the same
distortions; only the phases and the noise differ.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from one seed of any size."""
    words = np.random.SeedSequence(int(seed)).generate_state(2 * n, dtype=np.uint32)
    return [int(words[2 * i]) << 31 ^ int(words[2 * i + 1]) for i in range(n)]


def smooth_frames(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """(n, h, w) uint8 smooth moving fields on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    ph = torch.rand((4,), generator=g, device=device) * 6.28
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for t in range(n):
        s = 3.0 * t
        v = (128.0
             + 50.0 * torch.sin((xx + s) / 37.0 + ph[0]) * torch.cos((yy - 0.5 * s) / 53.0 + ph[1])
             + 30.0 * torch.sin((xx - yy + 2.0 * s) / 17.0 + ph[2])
             + 12.0 * torch.cos((xx * 0.7 + yy * 1.3 + s) / 5.0 + ph[3]))
        out[t] = v.clamp(0, 255).round().to(torch.uint8)
    return out


def distort(ref: torch.Tensor, seed: int, radius: int, noise: int) -> torch.Tensor:
    """(2r+1)^2 box blur (edges replicated) plus uniform noise in
    [-noise, noise], uint8."""
    g = torch.Generator(device=ref.device).manual_seed(seed)
    h, w = ref.shape[-2:]
    out = torch.empty_like(ref)
    k = 2 * radius + 1
    for t in range(ref.shape[0]):
        x = torch.nn.functional.pad(ref[t].float()[None, None], (radius,) * 4,
                                    mode="replicate")[0, 0]
        b = torch.zeros((h, w), device=ref.device)
        for i in range(k):
            for j in range(k):
                b += x[i: i + h, j: j + w]
        n = torch.randint(-noise, noise + 1, (h, w), generator=g, device=ref.device)
        out[t] = ((b / float(k * k)).round() + n).clamp(0, 255).to(torch.uint8)
    return out


def deepen(x8: torch.Tensor, depth: int, gen: torch.Generator) -> torch.Tensor:
    """8-bit codes -> ``depth``-bit codes (int32): x * 2^(depth-8) plus
    code noise in [0, 2^(depth-8))."""
    if depth == 8:
        return x8
    s = 1 << (depth - 8)
    return x8.to(torch.int32) * s + torch.randint(0, s, x8.shape, generator=gen,
                                                  device=x8.device, dtype=torch.int32)


def planes_of(y8: torch.Tensor, depth: int, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Luma field -> {"y", "u", "v"} code planes (uint8 at 8 bits, int32
    codes deeper) on the luma's device."""
    c8 = torch.nn.functional.avg_pool2d(y8.float()[:, None], 2)[:, 0].round().to(torch.uint8)
    top = (255 << (depth - 8)) if depth > 8 else 255
    y, u = deepen(y8, depth, gen), deepen(c8, depth, gen)
    return {"y": y, "u": u, "v": top - u}


def host_planes(p: Dict[str, torch.Tensor], depth: int) -> Dict[str, np.ndarray]:
    """Device code planes -> host numpy as a file holds them (uint8, or
    uint16 past 8 bits)."""
    if depth == 8:
        return {k: v.cpu().numpy() for k, v in p.items()}
    # Narrowed on the device, so half the bytes cross: the cast keeps the low
    # 16 bits, which the uint16 view reads back (16-bit codes too).
    return {k: v.to(torch.int16).cpu().numpy().view(np.uint16) for k, v in p.items()}


class Clips:
    """A cell's reference clip and its rungs.

    ``ref`` and each of ``dists`` are dicts of host numpy code planes
    ``{"y": (N, H, W), "u": (N, H/2, W/2), "v": ...}`` (uint8 or uint16),
    the data both the program and the reference are handed. ``device_luma``
    holds, for ``entry == "frames"``, each clip's luma on the card as
    ``analyze_frames`` takes it (uint8 codes at 8 bits, float32 on the 8-bit
    scale deeper), reference first."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        h, w, depth = int(cfg["height"]), int(cfg["width"]), int(cfg["bit_depth"])
        n = int(traffic["frames"])
        rungs = traffic["rungs"]
        seeds = sub_seeds(seed, 2 + 2 * len(rungs))
        self.depth = depth
        self.n_frames = n
        gen = torch.Generator(device=device).manual_seed(seeds[1])
        y8 = smooth_frames(n, h, w, seeds[0], device)
        fields = [y8] + [distort(y8, seeds[2 + 2 * i], int(r["blur_radius"]), int(r["noise"]))
                         for i, r in enumerate(rungs)]
        self.ref, self.dists = None, []
        self.device_luma: List[torch.Tensor] = []
        keep_on_card = traffic["entry"] == "frames"
        for i, f in enumerate(fields):
            gen.manual_seed(seeds[1] if i == 0 else seeds[3 + 2 * (i - 1)])
            p = planes_of(f, depth, gen)
            hp = host_planes(p, depth)
            if i == 0:
                self.ref = hp
            else:
                self.dists.append(hp)
            if keep_on_card:
                y = p["y"] if depth == 8 else p["y"].float() / float(1 << (depth - 8))
                self.device_luma.append(y.contiguous())
            del p
        del fields, y8
        self.frame_lists = [self._frame_list(c) for c in [self.ref] + self.dists]

    @staticmethod
    def _frame_list(c: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
        return [{k: c[k][i] for k in ("y", "u", "v")} for i in range(c["y"].shape[0])]

    def write_files(self, directory: str) -> List[str]:
        """Write the reference and every rung as y4m under ``directory``;
        returns the paths, reference first."""
        paths = []
        for i, c in enumerate([self.ref] + self.dists):
            path = os.path.join(directory, "ref.y4m" if i == 0 else f"rung{i - 1}.y4m")
            write_y4m(path, c, self.depth)
            paths.append(path)
        return paths

    def free_device(self) -> None:
        self.device_luma = []


def write_y4m(path: str, c: Dict[str, np.ndarray], depth: int, fps: int = 30) -> None:
    """4:2:0 planes -> a y4m file (little-endian 16-bit samples past 8
    bits), flushed to the disk before it returns: the kernel's writeback
    of the file then cannot fall into the measured window."""
    n, h, w = c["y"].shape
    cs = "C420mpeg2" if depth == 8 else f"C420p{depth}"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 {cs}\n".encode())
        for i in range(n):
            f.write(b"FRAME\n")
            for k in ("y", "u", "v"):
                f.write(np.ascontiguousarray(c[k][i]).astype(c[k].dtype.newbyteorder("<"),
                                                            copy=False).tobytes())
        f.flush()
        os.fsync(f.fileno())
