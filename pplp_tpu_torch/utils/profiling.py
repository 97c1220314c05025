"""Named stage timers: the d_* metrics pattern.

Counterpart of ``pplp_tpu.utils.profiling``'s ``StageTimer``. The reference
instruments every protocol stage with chrono timepoint pairs
(test_client.cc:89-216); here the same stage-timer pattern is a reusable
class. A CUDA device runs asynchronously, so a stage that queues device work
passes ``block_on`` (its tensors, or the device itself) and the clock stops
only after that device has finished.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["StageTimer"]


def _synchronize(block_on):
    """Wait for the CUDA device ``block_on`` names, or for every CUDA device
    that holds one of the tensors ``block_on`` holds."""
    if isinstance(block_on, torch.device):
        devices = {block_on}
    else:
        tensors = (block_on,) if torch.is_tensor(block_on) else block_on
        devices = {t.device for t in tensors if torch.is_tensor(t)}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StageTimer:
    """Named nanosecond stage timers: the d_* metrics pattern."""

    def __init__(self):
        self.ns: dict[str, int] = {}
        self._t0 = time.perf_counter_ns()

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.ns[name] = self.ns.get(name, 0) + time.perf_counter_ns() - start

    def total_ns(self) -> int:
        return time.perf_counter_ns() - self._t0

    def report(self, out=print):
        for name, ns in self.ns.items():
            out(f"d_{name}\t{ns / 1e6:.3f}ms")
        out(f"d_total\t{self.total_ns() / 1e6:.3f}ms")
