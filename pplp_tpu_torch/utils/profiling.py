"""Named stage timers (the d_* metrics pattern) and the program's spans.

Counterpart of ``pplp_tpu.utils.profiling``'s ``StageTimer``. The reference
instruments every protocol stage with chrono timepoint pairs
(test_client.cc:89-216); here the same stage-timer pattern is a reusable
class. A CUDA device runs asynchronously, so a stage that queues device work
passes ``block_on`` (its tensors, or the device itself) and the clock stops
only after that device has finished.

The program's one span recorder lives here too. It is off by default: then
``span(name, **attrs)`` hands back one shared object that does nothing,
after a single check of a module flag. ``enable()`` turns it on; each span
is then kept in memory (``Span``: its id, the id of the span that encloses
it in the same thread, its name, start and end on ``time.perf_counter_ns``
and its attrs) until ``drain()`` hands the finished spans back. A span
times host work only and never synchronizes a device: device time comes
from a profiler's trace, onto whose clock ``clock_anchor()`` maps a span.
A ``StageTimer`` stage opens a span of its own name.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

__all__ = ["StageTimer"]

_on = False
_done: list = []
_ids = itertools.count(1)
_open = threading.local()


class Span:
    """One recorded span, and the context manager that records it."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = None
        self.start_ns = self.end_ns = 0

    def set(self, **attrs):
        """Add attrs known only inside the span (a message's length)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        _done.append(self)
        return False


class _Off:
    """What ``span`` hands back while the recorder is off."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_open, "ids", None)
    if stack is None:
        stack = _open.ids = []
    return stack


def span(name: str, **attrs):
    """A span ``name`` around a ``with`` body: recorded while the recorder
    is on, else the shared no-op."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list[Span]:
    """The finished spans, in the order they ended; the recorder forgets them."""
    out = _done[:]
    del _done[:len(out)]
    return out


def clock_anchor() -> tuple[int, int]:
    """``(time.perf_counter_ns(), time.time_ns())`` read back to back. A span's
    ``t`` falls at ``t + time_ns - perf_counter_ns`` on the Unix clock, where
    ``torch.profiler`` stamps its events (``trace_start_ns`` and the kineto
    events' ``start_ns``)."""
    return time.perf_counter_ns(), time.time_ns()



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
        with span(name):
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
