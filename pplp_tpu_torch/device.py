"""Choosing the device explicitly, and reading the card for measurements."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["cuda_device", "smi_line", "window_ms"]


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when there is no usable card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    return torch.device("cuda", index)


def smi_line() -> str:
    """The first card's name and power limit as nvidia-smi reports them; a
    card may be set below its maximum power, which changes every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def window_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds per call over ``iters`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters
