"""Device meshes and frame placement (port of pqa2_tpu/parallel/mesh.py).

Axis conventions, as in the JAX package:
  "data"  — the frame batch axis, the primary scaling axis;
  "space" — frame rows in the JAX package. The port lays whole frames over
            every entry of the mesh instead (parallel/scoring.py says why),
            so a ``(n_data, n_space)`` mesh is ``n_data * n_space`` places
            for contiguous frame ranges.

``make_mesh()`` with no arguments puts every visible CUDA device on "data".
A caller may list a device more than once (``["cuda:0"] * 4``,
``["cpu"] * 4``): the entries then share that device, as JAX's virtual
``xla_force_host_platform_device_count`` devices share the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from pqa2_tpu_torch._device import require_cuda
from pqa2_tpu_torch.pipeline.scoring import resolve_device, upload

DATA_AXIS = "data"
SPACE_AXIS = "space"

Device = Union[str, torch.device]


class Mesh:
    """An ``(n_data, n_space)`` grid of ``torch.device`` entries."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], SPACE_AXIS: self.devices.shape[1]}

    @property
    def entries(self) -> List[torch.device]:
        """The mesh's devices in row-major order, one per entry."""
        return list(self.devices.ravel())

    def distinct(self) -> List[torch.device]:
        """Each device once, in the order of its first entry."""
        return list(dict.fromkeys(self.entries))


def make_mesh(
    n_data: Optional[int] = None,
    n_space: int = 1,
    devices: Optional[Sequence[Device]] = None,
) -> Mesh:
    """Build a ("data", "space") mesh over ``devices`` (default: every
    visible CUDA device; without a card this raises, there is no CPU
    fallback). CUDA entries must be cards the kernels are built for."""
    if devices is None:
        require_cuda("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data * n_space > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_space} needs {n_data * n_space} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty((n_data, n_space), dtype=object)
    for i, d in enumerate(devices[: n_data * n_space]):
        grid[i // n_space, i % n_space] = d
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class FrameSharding:
    """Contiguous frame ranges over a mesh's entries, in row-major order:
    entry i holds frames ``ranges(n)[i]``; the first ``n % k`` entries
    hold one frame more than the rest (72 frames over 5: 15, 15, 14, 14, 14)."""

    mesh: Mesh

    def ranges(self, n: int):
        """-> [(device, start, stop)] for an n-frame batch, one per entry."""
        k = len(self.mesh.entries)
        out, start = [], 0
        for i, d in enumerate(self.mesh.entries):
            stop = start + n // k + (1 if i < n % k else 0)
            out.append((d, start, stop))
            start = stop
        return out


@dataclasses.dataclass(frozen=True)
class Replicated:
    """The whole batch on every distinct device of the mesh."""

    mesh: Mesh


@dataclasses.dataclass
class Shard:
    """Frames ``[start, stop)`` of a batch, on ``device``."""

    device: torch.device
    start: int
    stop: int
    frames: torch.Tensor


@dataclasses.dataclass
class ShardedFrames:
    """An (N, H, W) batch laid over a mesh by :func:`shard_frames`."""

    mesh: Mesh
    n: int
    shards: List[Shard]


def frame_sharding(mesh: Mesh) -> FrameSharding:
    """Placement of (N, H, W) frame batches: contiguous frame ranges over
    the mesh's entries."""
    return FrameSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_frames(frames, mesh: Mesh) -> ShardedFrames:
    """Upload each entry's frame range of a host (N, H, W) batch (numpy,
    a list of 2-D planes, or a tensor) to its device through
    :func:`pipeline.scoring.upload`: 8-bit luma travels as bytes. Any N
    (an entry past the last frame holds none)."""
    n = len(frames)
    shards = []
    for d, start, stop in frame_sharding(mesh).ranges(n):
        if stop > start:
            shards.append(Shard(d, start, stop, upload(frames[start:stop], d)))
    return ShardedFrames(mesh, n, shards)
