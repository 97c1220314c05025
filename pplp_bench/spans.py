"""Where a cell's time goes inside the program: the program's own spans, on
the host clock and, under the device's trace, by the launch of each kernel.

    python3 pplp_bench/spans.py --workload <name> --seed <n> [--units N] [--traced K] [--json PATH]

Set-up as a run of the cell makes it. Then ``N`` units (default twice the
mix's ``trace_skip``) alternate the program's span recorder
(``pplp_tpu_torch.utils.profiling``) off and on: the two medians give the
recorder's cost, and the units with it on give each span's mean host
milliseconds a unit. Last, ``K`` units (default the mix's ``trace_units``)
run under ``torch.profiler``, after one that warms it, with the recorder
on. Each device operation is credited to the innermost program span that
holds its launch, the host runtime call of the same correlation id, mapped
onto the profiler's clock through ``profiling.clock_anchor``, whenever the
operation ran. The stretch's idle gaps are summed by the innermost program
span and the host operation begun last. The spans' attrs are read a unit:
numbers summed, words counted by value, and the host GB/s of each span that
states its ``bytes``.

Prints the lines ``program spans``, ``program attrs``, ``program device``
and ``program idle gaps``, then the result as one JSON object (also written
to ``--json``). It runs on the card and exits 2 without one, as ``run.py``
does. A program without the recorder makes it exit non-zero.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pplp_bench.tracing import LABEL, Stretch  # noqa: E402

# Readings of the program's spans, by the name a per-layer metric would take:
# the mean host milliseconds a unit of the spans named, together, leaving out
# those nested in the span named second. The client's load of the blind
# distance is part of ``roles.decrypt`` (the benchmark's ``dec``), so the
# wire reading holds only the BFV stages' saves and loads.
HOST_READINGS = {
    "demo.dec_table_copy_ms": (("bloom.table_to_host",), None),
    "demo.dec_host_copy_ms": (("roles.bf_join", "bloom.deserialize"), None),
    "demo.dec_decrypt_ms": (("roles.decrypt", "roles.probe"), None),
    "demo.bfv_encode_ms": (("bfv.plain_encode",), None),
    "demo.bfv_wire_ms": (("bfv.save_ciphertext", "bfv.load_ciphertext"), "roles.decrypt"),
    "pipeline.enqueue_ms": (("pipeline.step",), None),
}
# The device milliseconds a traced unit of the kernels launched in a span.
DEVICE_READINGS = {
    "pipeline.evaluate_device_ms": "pipeline.evaluate",
    "pipeline.decode_device_ms": "pipeline.decode",
    "pipeline.probe_device_ms": "pipeline.probe",
}
# The benchmark's own span that host readings split, for their cover of it.
HOST_COVERS = {"dec": ("demo.dec_table_copy_ms", "demo.dec_host_copy_ms",
                       "demo.dec_decrypt_ms")}
NO_SPAN, NO_LAUNCH = "(no program span)", "(launch not found)"
_COPY_PREFIXES = ("Memcpy", "Memset")
# Host calls into the CUDA runtime (``cuda*``) or its low-level API (``cu*``)
# that put work on the device.
_RUNTIME_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")


# -- the profiler's events ------------------------------------------------

def device_ops(events) -> list[tuple[str, int, int, int | None]]:
    """(name, start, end, launch) of each device operation among the kineto
    events ``events`` (``prof.profiler.kineto_results.events()``), in ns on
    the profiler's clock. ``launch`` is the start of the host runtime call of
    the operation's correlation id (None where the profiler lost it)."""
    from torch.autograd import DeviceType

    runtime, ops = {}, []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith(_RUNTIME_PREFIXES):
                runtime[e.correlation_id()] = e.start_ns()
        elif not e.name().startswith(LABEL):  # the benchmark's ranges, seen on the device
            ops.append(e)
    return [(e.name(), e.start_ns(), e.end_ns(), runtime.get(e.correlation_id())) for e in ops]


def host_ops(events) -> list[tuple[int, str]]:
    """(start, name) of the host operations and runtime calls, sorted (ns)."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU and not e.name().startswith(LABEL))


def mapped(spans, anchor: tuple[int, int]) -> list[tuple[int, int, str]]:
    """(start, end, name) of recorded spans on the profiler's clock, given
    ``profiling.clock_anchor()``'s (perf_counter_ns, time_ns) pair."""
    offset = anchor[1] - anchor[0]
    return [(s.start_ns + offset, s.end_ns + offset, s.name) for s in spans]


def innermost(spans: list[tuple[int, int, str]], t: float) -> str | None:
    """The name of the latest-started span that holds ``t`` (for spans
    nested in one thread, the innermost)."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or s > best[0]):
            best = (s, name)
    return best[1] if best else None


def credit(ops, spans, t0: int, t1: int) -> tuple[dict, dict]:
    """Device ns of the operations launched in [t0, t1], by the innermost
    span holding each launch: ({span: kernel ns}, {span: copy ns}). An
    operation whose launch was not found counts under ``NO_LAUNCH`` when it
    started in the range; one launched outside every span under
    ``NO_SPAN``."""
    kernels, copies = {}, {}
    for name, s, e, launch in ops:
        if launch is None:
            if not t0 <= s <= t1:
                continue
            owner = NO_LAUNCH
        elif t0 <= launch <= t1:
            owner = innermost(spans, launch) or NO_SPAN
        else:
            continue
        into = copies if name.startswith(_COPY_PREFIXES) else kernels
        into[owner] = into.get(owner, 0) + (e - s)
    return kernels, copies


def idle_gaps(ops, spans, host, t0: int, t1: int) -> list[list]:
    """The stretch [t0, t1]'s idle device time (no operation running), in
    seconds, the largest first, summed by the innermost program span and the
    host operation begun last. A gap is cut where a span starts or ends, and
    each piece is labelled at its middle. The busy time is the harness's own
    union (``Stretch.busy``) of these operations."""
    stretch = Stretch.__new__(Stretch)
    stretch.device_ops = [op[:3] for op in ops]
    stretch.start, stretch.end = t0, t1
    busy = stretch.busy()
    starts = [t for t, _ in host]
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    gaps: dict[str, float] = {}
    edge = t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            cuts = [edge, *edges[bisect.bisect_right(edges, edge):bisect.bisect_left(edges, s)], s]
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                i = bisect.bisect_right(starts, mid) - 1
                label = f"{innermost(spans, mid) or 'outside program spans'} / " \
                        f"{host[i][1] if i >= 0 else 'no host op'}"
                gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-9
        edge = max(edge, e)
    return [[k[:120], v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])]


# -- host readings --------------------------------------------------------

def per_unit_ms(units: list[list]) -> dict[str, float]:
    """Mean host milliseconds a unit of each span name, over ``units`` (each
    a list of recorded spans)."""
    total: dict[str, int] = {}
    for spans in units:
        for s in spans:
            total[s.name] = total.get(s.name, 0) + s.end_ns - s.start_ns
    return {k: v / 1e6 / len(units) for k, v in sorted(total.items())} if units else {}


def _within(span, name: str | None, by_id: dict) -> bool:
    """Whether a span ``name`` encloses ``span`` (recorded in one unit)."""
    parent = by_id.get(span.parent)
    while name is not None and parent is not None:
        if parent.name == name:
            return True
        parent = by_id.get(parent.parent)
    return False


def host_readings(units: list[list]) -> dict[str, float]:
    """``HOST_READINGS`` over ``units`` (each a list of recorded spans), for
    the readings whose spans were recorded."""
    out = {}
    for reading, (names, outside) in HOST_READINGS.items():
        picked = [s for spans in units for s in spans if s.name in names
                  and not _within(s, outside, {r.id: r for r in spans})]
        if picked:
            out[reading] = sum(s.end_ns - s.start_ns for s in picked) / 1e6 / len(units)
    return out


def attrs_a_unit(units: list[list]) -> dict[str, dict]:
    """The spans' attrs a unit, by span name: a number's mean sum (a
    message's ``bytes``, ``bloom.insert``'s ``chunks`` and ``keys``), a
    word's mean count by value (its ``route``); and ``gb_per_s``, the bytes
    over the host time of the spans that state them."""
    out: dict[str, dict] = {}
    ns: dict[str, int] = {}
    for s in (s for spans in units for s in spans if s.attrs):
        mine = out.setdefault(s.name, {})
        for k, v in s.attrs.items():
            if isinstance(v, str):
                mine.setdefault(k, {})
                mine[k][v] = mine[k].get(v, 0) + 1 / len(units)
            else:
                mine[k] = mine.get(k, 0) + v / len(units)
        if "bytes" in s.attrs:
            ns[s.name] = ns.get(s.name, 0) + s.end_ns - s.start_ns
    for name, t in ns.items():
        if t:
            out[name]["gb_per_s"] = out[name]["bytes"] * len(units) / t
    return dict(sorted(out.items()))


def device_readings(kernel_ns: dict[str, int], units: int) -> dict[str, float]:
    return {name: kernel_ns.get(span, 0) / 1e6 / units
            for name, span in DEVICE_READINGS.items() if span in kernel_ns}


# -- the run --------------------------------------------------------------

def measure(root: Path, workload: str, seed: int, units: int | None, traced: int | None,
            device) -> dict:
    import torch

    from pplp_bench import harness
    from pplp_tpu_torch.utils import profiling

    if not hasattr(profiling, "enable"):
        raise RuntimeError("this program records no spans (no profiling.enable)")
    device = torch.device(device)
    cell = harness.resolve(root, workload)
    session = harness.Session(cell, seed, 0.0, device, harness.Spans(device))
    entry, spans = cell.entry, session.spans
    units = units or 2 * int(cell.mix["trace_skip"])
    traced = traced or int(cell.mix["trace_units"])
    state = entry.set_up(session)
    spans.sync()
    profiling.drain()

    off_ms, on_ms, on_units, bench = [], [], [], []
    for i in range(units):
        on = i % 2 == 1
        if on:
            profiling.enable()
        spans.current = {}
        u0 = time.perf_counter()
        entry.unit(session, state, i)
        dt = time.perf_counter() - u0
        profiling.disable()
        (on_ms if on else off_ms).append(1e3 * dt)
        if on:
            on_units.append(profiling.drain())
            bench.append(spans.current)
    by_name = per_unit_ms(on_units)
    host = host_readings(on_units)
    bench_ms = {k: 1e3 * statistics.fmean(b.get(k, 0.0) for b in bench)
                for k in sorted({k for b in bench for k in b})}
    covers = {stage: sum(host.get(r, 0.0) for r in parts) / bench_ms[stage]
              for stage, parts in HOST_COVERS.items()
              if stage in bench_ms and bench_ms[stage] > 0 and any(r in host for r in parts)}

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profiling.enable()
    anchor = profiling.clock_anchor()
    with profile(activities=acts) as prof:
        spans.ranges = True
        entry.unit(session, state, units)  # warms the profiler
        spans.sync()
        profiling.drain()
        t0 = time.perf_counter_ns()
        for i in range(units + 1, units + 1 + traced):
            entry.unit(session, state, i)
        spans.sync()
        t1 = time.perf_counter_ns()
        spans.ranges = False
    profiling.disable()
    stretch_spans = profiling.drain()
    events = prof.profiler.kineto_results.events()
    ops = device_ops(events)
    on_clock = mapped(stretch_spans, anchor)
    offset = anchor[1] - anchor[0]
    t0, t1 = t0 + offset, t1 + offset
    kernel_ns, copy_ns = credit(ops, on_clock, t0, t1)
    all_kernels = sum(kernel_ns.values())
    readings = device_readings(kernel_ns, traced)
    on_device = {
        "kernel_ms_by_span": {k: v / 1e6 / traced for k, v in sorted(kernel_ns.items())},
        "copy_ms_by_span": {k: v / 1e6 / traced for k, v in sorted(copy_ns.items())},
        "kernels_ms": all_kernels / 1e6 / traced,
        "cover": (sum(kernel_ns.get(s, 0) for s in DEVICE_READINGS.values()) / all_kernels
                  if all_kernels and DEVICE_READINGS.keys() & readings.keys() else None),
        "ops": len(ops),
        "ops_launch_not_found": sum(1 for op in ops if op[3] is None),
        "window_ms": (t1 - t0) / 1e6,
    } if ops else None
    gaps = idle_gaps(ops, on_clock, host_ops(events), t0, t1) if ops else None
    if gaps:
        on_device["idle_ms"] = sum(v for _, v in gaps) * 1e3
        on_device["idle_in_program_spans"] = sum(
            v for k, v in gaps if not k.startswith("outside program spans")) / sum(
            v for _, v in gaps)
    return {
        "workload": workload, "seed": seed, "on": str(device),
        "units": {"alternated": units, "traced": traced},
        "recorder_cost": {f"{side}_{k}_ms": v for side, ms in (("off", off_ms), ("on", on_ms))
                          for k, v in zip(("q1", "p50", "q3"), statistics.quantiles(ms, n=4))},
        "readings": dict(host, **readings),
        "host_ms_by_span": by_name,
        "attrs_a_unit": attrs_a_unit(on_units),
        "spans_a_unit": {k: c / len(on_units) for k, c in _counts(on_units).items()},
        "bench_spans_ms": bench_ms,
        "host_cover": covers,
        "device": on_device,
        "idle_gaps": gaps[:10] if gaps else None,
    }


def _counts(units) -> dict[str, int]:
    out: dict[str, int] = {}
    for spans in units:
        for s in spans:
            out[s.name] = out.get(s.name, 0) + 1
    return dict(sorted(out.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--traced", type=int, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans.py: no CUDA device; it reads the card only", file=sys.stderr)
        return 2
    out = measure(ROOT, args.workload, args.seed, args.units, args.traced, "cuda")
    out["card"] = torch.cuda.get_device_name(0)
    print("program spans: " + json.dumps(out["host_ms_by_span"]), flush=True)
    print("program attrs: " + json.dumps(out["attrs_a_unit"]), flush=True)
    print("program device: " + json.dumps(out["device"]), flush=True)
    print("program idle gaps: " + json.dumps(out["idle_gaps"]), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
