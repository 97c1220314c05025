"""Spans around the calls into the program, and the profiler's stretch.

Every unit of work (a test, a step) of the measured window records its
spans on the host clock. With tracing on, a short steady stretch of the
window runs under ``torch.profiler``: after ``skip`` units, one unit to
warm the profiler, then ``units`` units inside a range of their own. The spans then also become
``record_function`` ranges, so a device operation is attributed to the
span in which it ran. A span that starts and ends with a synchronize
holds exactly the device work it queued.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

import torch

LABEL = "pplp_bench:"
STRETCH = LABEL + "stretch"
_COPY_PREFIXES = ("Memcpy", "Memset")


class Spans:
    """Host-clock spans of the current unit, and the profiler's ranges."""

    def __init__(self, device: torch.device):
        self.device = device
        self.current: dict[str, float] = {}
        self.ranges = False  # record_function ranges while the profiler runs

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the body on the host clock into the unit's span ``name``
        (summed if it recurs); ``sync`` synchronizes the device before and
        after, so the span covers the device work queued in it."""
        rf = torch.profiler.record_function(LABEL + name) if self.ranges else None
        if sync:
            self.sync()
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                self.sync()
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self.current[name] = self.current.get(name, 0.0) + dt


class Stretch:
    """What the profiler saw in the stretch: device operations, the
    program's host operations and the benchmark's ranges (microseconds on
    the profiler's clock)."""

    def __init__(self, prof, units: int):
        from torch.autograd import DeviceType

        self.units = units
        self.device_ops: list[tuple[str, float, float]] = []
        self.host_ops: list[tuple[float, float, str]] = []
        self.ranges: dict[str, list[tuple[float, float]]] = {}
        for e in prof.events():
            start, end = float(e.time_range.start), float(e.time_range.end)
            if e.name.startswith(LABEL):
                if e.device_type != DeviceType.CUDA:
                    self.ranges.setdefault(e.name[len(LABEL):], []).append((start, end))
            elif e.device_type == DeviceType.CUDA:
                self.device_ops.append((e.name, start, end))
            else:
                self.host_ops.append((start, end, e.name))
        (self.start, self.end), = self.ranges.pop("stretch", [(0.0, 0.0)])
        self.device_ops = [op for op in self.device_ops
                           if op[2] > self.start and op[1] < self.end]
        self.host_ops.sort()

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self):
        return [op for op in self.device_ops if not op[0].startswith(_COPY_PREFIXES)]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's operations, clipped to the stretch."""
        out: list[list[float]] = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            s, e = max(s, self.start), min(e, self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            elif e > s:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def device_s_in(self, span: str) -> list[float]:
        """Device seconds of the operations inside each occurrence of a span."""
        out = []
        for s, e in self.ranges.get(span, []):
            out.append(sum(oe - os for _, os, oe in self.device_ops if os >= s and oe <= e) * 1e-6)
        return out

    def _host_label(self, t: float) -> str:
        spans = [(e - s, name) for name, occ in self.ranges.items() for s, e in occ if s <= t <= e]
        span = min(spans)[1] if spans else "outside spans"
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        return f"{span} / {self.host_ops[i][2] if i >= 0 else 'no host op'}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing in them (the innermost span and
        the host operation begun last)."""
        ops: dict[str, float] = {}
        for name, s, e in self.device_ops:
            ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
        gaps: dict[str, float] = {}
        edge = self.start
        for s, e in self.busy() + [(self.end, self.end)]:
            if s > edge:
                label = self._host_label((edge + s) / 2)
                gaps[label] = gaps.get(label, 0.0) + (s - edge) * 1e-6
            edge = max(edge, e)
        ranked = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


class Tracer:
    """Profiles units ``skip + 1`` to ``skip + units`` of the window; the
    profiler starts before unit ``skip``, which warms it up, and the window
    runs on until the stretch is done. Once the device tracer has started,
    launches stay slower for the rest of the process, so the host-clock
    spans of a traced run are read from the units before ``skip``."""

    def __init__(self, spans: Spans, enabled: bool, skip: int, units: int):
        self.spans, self.enabled, self.skip, self.units = spans, enabled, skip, units
        self.first = skip if enabled else None
        self.prof = None
        self.stretch: Stretch | None = None
        self._range = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.spans.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    @property
    def pending(self) -> bool:
        return self.enabled and self.stretch is None

    def before(self, i: int):
        if not self.pending:
            return
        if i == self.skip:
            self.prof = self._profile()
            self.prof.__enter__()
            self.spans.ranges = True
        elif i == self.skip + 1:
            self.spans.sync()
            self._range = torch.profiler.record_function(STRETCH)
            self._range.__enter__()

    def after(self, i: int):
        if self.pending and i == self.skip + self.units:
            self.spans.sync()
            self._range.__exit__(None, None, None)
            self.spans.ranges = False
            self.prof.__exit__(None, None, None)
            self.stretch = Stretch(self.prof, self.units)
            self.prof = None
