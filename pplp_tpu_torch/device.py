"""Choosing the device explicitly."""

from __future__ import annotations

import torch

__all__ = ["cuda_device"]


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when there is no usable card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)
