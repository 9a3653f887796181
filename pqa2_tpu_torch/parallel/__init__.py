"""Device-mesh scaling: frame ranges over several devices (port of
pqa2_tpu/parallel).

The reference's only parallelism is libvmaf's CPU thread pool over frames.
Here frames are laid out as contiguous ranges over the entries of a
``("data", "space")`` mesh of torch devices; each range is scored on its
device by the port's kernels, with the motion halo's one frame copied over
from the neighbour range (parallel/scoring.py). Whole clips spread over
processes through ``parallel.multihost``.
"""

from pqa2_tpu_torch.parallel.mesh import (
    frame_sharding,
    make_mesh,
    replicated,
    shard_frames,
)
from pqa2_tpu_torch.parallel.scoring import (
    make_sharded_scorer,
    make_shardmap_scorer,
    score_clip_sharded,
    sharded_extract,
)

__all__ = [
    "frame_sharding",
    "make_mesh",
    "replicated",
    "shard_frames",
    "make_sharded_scorer",
    "make_shardmap_scorer",
    "score_clip_sharded",
    "sharded_extract",
]
