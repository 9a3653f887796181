"""Multi-process scaling helpers (port of pqa2_tpu/parallel/multihost.py).

Across hosts the economical pattern for VQA is a batch sweep: whole clips
are independent, so each process scores its own clip list and only the
small score summaries cross the network.

``initialize()`` joins a ``torch.distributed`` process group when an
address is given or torchrun's environment names one, and is a no-op
otherwise, so the same code path runs on one card or on many. The group
uses NCCL on the card and gloo only where the caller asks for the CPU.
NCCL refuses two ranks on one GPU, so each rank needs a card of its own.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from pqa2_tpu_torch.pipeline.scoring import resolve_device

logger = logging.getLogger(__name__)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               *,
               device: Union[str, torch.device] = "cuda") -> bool:
    """Join the process group if configured; returns True when joined.

    Resolution order: explicit arguments > torchrun's ``MASTER_ADDR``/
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` > single-process no-op
    (False). ``coordinator_address`` is ``host:port``. ``device="cuda"``
    (a card for this rank) uses NCCL and raises without a card; ``"cpu"``
    uses gloo."""
    if not coordinator_address and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coordinator_address:
        return False
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", 1))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("torch.distributed up (%s): process %d/%d", backend, process_id,
                num_processes)
    return True


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_clip_list(clips: Sequence, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List:
    """Static round-robin assignment of independent clips to this process
    (by rank): no traffic between processes until the summary gather."""
    rank, size = _rank_and_size()
    if process_id is None:
        process_id = rank
    if num_processes is None:
        num_processes = size
    return [c for i, c in enumerate(clips) if i % num_processes == process_id]


def gather_summaries(local_summaries: List[Dict]) -> List[Dict]:
    """All-gather per-clip summary dicts across processes, in rank order.
    One process: the identity. Several: ``dist.all_gather_object``."""
    size = _rank_and_size()[1]
    if size == 1:
        return list(local_summaries)
    gathered: List[Optional[List[Dict]]] = [None] * size
    dist.all_gather_object(gathered, list(local_summaries))
    return [s for part in gathered for s in part]
