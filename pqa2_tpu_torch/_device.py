"""The one CUDA gate of the port: a Hopper card or an error."""

from __future__ import annotations

from typing import Optional, Union

import torch

#: Compute capability the kernels are compiled for (sm_90a: H100/H200).
REQUIRED_CAPABILITY = (9, 0)


def require_cuda(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Return the CUDA device to run kernels on, or raise.

    Raises RuntimeError when PyTorch sees no CUDA device, or when the card
    is not compute capability 9.0 (the ``sm_90a`` build target). There is
    no CPU fallback: callers that want the plain PyTorch versions pass CPU
    tensors explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pqa2_tpu_torch kernels need an sm_90 CUDA device, but "
            "torch.cuda.is_available() is False")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"pqa2_tpu_torch kernels are built for sm_90a; "
            f"{torch.cuda.get_device_name(index)} has compute capability {cap}")
    return torch.device("cuda", index)
