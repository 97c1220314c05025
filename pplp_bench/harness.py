"""Runs one cell of ``BENCHMARK.json``: set-up, the measured window, the
check against the plain reference, then the metrics.

Everything particular to a cell is found by name:
``configs/<config>.json`` (as ``BENCHMARK.json`` lists its file) names the
entry module ``entries/<entry>.py``; the cell's traffic is
``traffic/<mix>.json``; each per-layer metric is read by
``layer_metrics/<metric>.py``. An entry module defines

* ``set_up(session) -> state``: build the program's objects from the seed
  and run every shape of the cell once;
* ``unit(session, state, i)``: run unit i of the window (a test, a step)
  and keep what the check needs;
* ``release(state) -> record``: drop the program's objects, keep the record;
* ``check(session, record, control=None) -> {name: (value, limit)}``;
* ``end_to_end(session, window) -> {quantity: value}`` (see ``quantity``)
  and ``work(session, record) -> dict``, the sizes the per-layer readers
  count from.

A per-layer reader defines ``read(view) -> float | None``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

from . import yardstick
from .tracing import Spans, Stretch, Tracer



def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module of the benchmark's folder by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def quantity(metric: str) -> str:
    """The entry's quantity an end-to-end metric reports: its name up to the
    first dot. ``checks_per_s.device_bound`` is ``checks_per_s`` under a
    bound of its own, for the cells whose noise differs."""
    return metric.split(".")[0]


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    entry: ModuleType
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict[str, ModuleType]


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    pkg = root / "pplp_bench"
    mix = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    entry = load_module(pkg / "entries" / f"{config['entry']}.py",
                        f"pplp_bench.entries.{config['entry']}")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no workloads")
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    readers = {m["name"]: load_module(pkg / "layer_metrics" / f"{m['name']}.py",
                                      f"pplp_bench.layer_metrics.{m['name']}") for m in layer}
    return Cell(workload, config, mix, entry, e2e, layer, readers)


@dataclass
class Session:
    """What an entry module gets: the cell's data, the run's arguments, the
    device and the spans."""
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    spans: Spans
    work: dict = field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix


@dataclass
class Window:
    """The measured window: every unit's host-clock seconds and spans, which
    unit the profiler started at, and the window's length."""
    unit_s: list[float]
    spans: list[dict]
    first: int | None  # the unit before which the profiler started
    window_s: float
    failed: int
    errors: list[str]

    def steady(self):
        """(seconds, spans) of the units before the profiler first started."""
        n = len(self.unit_s) if self.first is None else self.first
        return self.unit_s[:n], self.spans[:n]


@dataclass
class View:
    """What a per-layer reader reads: the window's units and spans, the
    profiled stretch (None untraced or off the card) and the cell's sizes."""
    window: Window
    stretch: Stretch | None
    work: dict


def measure(session: Session, state, tracer: Tracer) -> Window:
    """Units back to back (a closed loop) until ``seconds`` have passed and
    the traced stretch, if any, is done; the window runs from the first
    unit's start to the last one's end."""
    entry, spans = session.cell.entry, session.spans
    unit_s, unit_spans, errors = [], [], []
    failed = 0
    t0 = time.perf_counter()
    now, i = t0, 0
    while now - t0 < session.seconds or tracer.pending:
        tracer.before(i)
        spans.current = {}
        u0 = time.perf_counter()
        try:
            entry.unit(session, state, i)
        except Exception as exc:  # a unit that gives no answer is counted failed
            failed += 1
            if len(errors) < 3:
                errors.append(f"unit {i}: {type(exc).__name__}: {exc}")
        now = time.perf_counter()
        unit_s.append(now - u0)
        unit_spans.append(spans.current)
        tracer.after(i)
        i += 1
    return Window(unit_s, unit_spans, tracer.first, now - t0, failed, errors)


def host_probe_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the host's speed at the
    moment, which tells a host that slowed from a program that did."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    return 1e3 * (time.perf_counter() - t0)


def diagnostics(window: Window) -> dict:
    """Quantiles of the units' milliseconds, the median of those before the
    profiler started, and each span's mean milliseconds a unit."""
    ms = [1e3 * u for u in window.unit_s]
    steady = [1e3 * u for u in window.steady()[0]]
    spans = sorted({k for s in window.spans for k in s})
    return {"units_ms": {f"p{q}": yardstick.quantile(ms, q / 100) for q in (10, 50, 90, 99)}
            | {"count": len(ms), "max": max(ms)},
            "before_profiler_p50_ms": yardstick.quantile(steady, 0.5) if steady else None,
            "span_mean_ms": {k: 1e3 * sum(s.get(k, 0.0) for s in window.spans) / len(ms)
                             for k in spans}}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """One run of a cell. ``started``: the process's start on the
    ``perf_counter`` clock, from which set-up is timed."""
    device = torch.device(device)
    cell = resolve(root, workload)
    session = Session(cell, seed, seconds, device, Spans(device))
    entry = cell.entry
    before_s = time.perf_counter() - started
    state = entry.set_up(session)
    session.spans.sync()
    setup_s = time.perf_counter() - started
    setup_split = dict(session.spans.current, before_entry=before_s)
    tracer = Tracer(session.spans, trace, skip=int(cell.mix["trace_skip"]),
                    units=int(cell.mix["trace_units"]))
    window = measure(session, state, tracer)
    session.spans.sync()
    host_ms = host_probe_ms()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    record = entry.release(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = {"failed": (window.failed, 0)}
    checks.update(entry.check(session, record))
    correct = all(v <= limit for v, limit in checks.values())
    session.work.update(entry.work(session, record))
    if trace:
        view = View(window, tracer.stretch, session.work)
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(entry.end_to_end(session, window), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[quantity(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end}
    return {
        "correct": correct,
        "attempted": len(window.unit_s) * int(session.work.get("per_unit", 1)),
        "failed": window.failed * int(session.work.get("per_unit", 1)),
        "metrics": metrics,
        "errors": window.errors,
        "peak": peak,
        "stretch": tracer.stretch,
        "setup_split": setup_split,
        "diagnostics": dict(diagnostics(window), host_probe_ms=host_ms),
        "checks": checks,
    }
