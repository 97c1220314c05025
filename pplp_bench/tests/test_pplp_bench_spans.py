"""``spans.py``: the program's spans read by the benchmark, on the CPU.

The readers run on synthetic kineto events, where a kernel is credited to
the span that launched it even when it runs after that span has ended; the
tiny cells run with the recorder left off by the harness, and through
``spans.measure`` with it on.
"""

from __future__ import annotations

import time

import pytest
import torch
from torch.autograd import DeviceType

from pplp_bench import harness, spans
from pplp_bench.tests import tiny
from pplp_tpu_torch.utils import profiling


class Event:
    """The part of a kineto event the readers use."""

    def __init__(self, name, where, start, end, corr=0):
        self._name, self._where, self._start, self._end = name, where, start, end
        self._corr = corr

    def name(self):
        return self._name

    def device_type(self):
        return self._where

    def correlation_id(self):
        return self._corr

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
# A step from 1,000 to 2,000 ns: ``evaluate`` launches two kernels, ``decode``
# one, ``probe`` one that runs after the step; a copy is launched outside
# every span and one kernel's launch is lost.
EVENTS = [
    Event("aten::add", CPU, 1_100, 1_150, corr=7),
    Event("cudaLaunchKernel", CPU, 1_110, 1_120, corr=501),
    Event("cudaLaunchKernel", CPU, 1_200, 1_210, corr=502),
    Event("aten::where", CPU, 1_600, 1_700, corr=8),
    Event("cudaLaunchKernelExC", CPU, 1_610, 1_620, corr=503),
    Event("cudaLaunchKernel", CPU, 1_800, 1_810, corr=504),
    Event("cudaMemcpyAsync", CPU, 2_100, 2_110, corr=505),
    Event("pplp_bench:step", CPU, 1_000, 2_000, corr=9),
    Event("add_kernel", CUDA, 1_300, 1_500, corr=501),
    Event("ntt_forward", CUDA, 1_500, 1_900, corr=502),
    Event("where_kernel", CUDA, 1_900, 2_000, corr=503),
    Event("bf_probe", CUDA, 2_000, 2_050, corr=504),
    Event("Memcpy DtoH", CUDA, 2_150, 2_400, corr=505),
    Event("lost_kernel", CUDA, 2_500, 2_520, corr=777),
    Event("pplp_bench:step", CUDA, 1_000, 2_000, corr=0),
]
SPANS = [(1_000, 2_000, "pipeline.step"), (1_050, 1_550, "pipeline.evaluate"),
         (1_550, 1_750, "pipeline.decode"), (1_750, 1_900, "pipeline.probe")]


def test_device_ops_find_each_launch():
    ops = {name: launch for name, _, _, launch in spans.device_ops(EVENTS)}
    assert ops == {"add_kernel": 1_110, "ntt_forward": 1_200, "where_kernel": 1_610,
                   "bf_probe": 1_800, "Memcpy DtoH": 2_100, "lost_kernel": None}


def test_kernels_are_credited_by_launch_not_by_execution():
    kernels, copies = spans.credit(spans.device_ops(EVENTS), SPANS, 1_000, 3_000)
    assert kernels == {"pipeline.evaluate": 600, "pipeline.decode": 100, "pipeline.probe": 50,
                       spans.NO_LAUNCH: 20}
    assert copies == {spans.NO_SPAN: 250}
    # An execution-time reading would give ``probe`` nothing: bf_probe runs
    # after the step, and ntt_forward mostly inside ``decode``'s range.
    only_step = spans.credit(spans.device_ops(EVENTS), SPANS, 1_000, 2_000)[0]
    assert spans.NO_LAUNCH not in only_step and sum(only_step.values()) == 750
    assert spans.device_readings(kernels, units=2) == {
        "pipeline.evaluate_device_ms": 600 / 2e6, "pipeline.decode_device_ms": 100 / 2e6,
        "pipeline.probe_device_ms": 50 / 2e6}


def test_idle_gaps_by_program_span_and_host_op():
    ops = spans.device_ops(EVENTS)
    gaps = dict(spans.idle_gaps(ops, SPANS, spans.host_ops(EVENTS), 1_000, 2_600))
    # The first gap (1,000-1,300) is cut where ``evaluate`` starts.
    assert gaps == pytest.approx({"pipeline.step / no host op": 50e-9,
                                  "pipeline.evaluate / cudaLaunchKernel": 250e-9,
                                  "outside program spans / cudaMemcpyAsync": 280e-9})


class Rec:
    """The part of a recorded span the host readers use."""

    def __init__(self, id, name, s, e, parent=None, **attrs):
        self.id, self.name, self.start_ns, self.end_ns = id, name, s, e
        self.parent, self.attrs = parent, attrs


def test_mapped_spans_and_host_readings():
    units = [[Rec(1, "roles.bf_join", 0, 2_000_000, bytes=4_000_000),
              Rec(2, "bloom.deserialize", 0, 1_000_000)],
             [Rec(1, "roles.bf_join", 0, 4_000_000, bytes=4_000_000)]]
    by_name = spans.per_unit_ms(units)
    assert by_name == {"bloom.deserialize": 0.5, "roles.bf_join": 3.0}
    assert spans.host_readings(units) == {"demo.dec_host_copy_ms": 3.5}
    assert spans.mapped(units[1], (100, 1_100)) == [(1_000, 4_001_000, "roles.bf_join")]


def test_wire_reading_leaves_out_the_decrypts_load():
    """The client's load of the blind distance, inside ``roles.decrypt``,
    counts in ``dec_decrypt_ms`` and not in the BFV stages' wire."""
    unit = [Rec(1, "bfv.save_ciphertext", 0, 3_000_000),
            Rec(2, "bfv.load_ciphertext", 0, 1_000_000),
            Rec(3, "roles.decrypt", 5_000_000, 9_000_000),
            Rec(4, "bfv.plain_encode", 5_500_000, 5_600_000, parent=3),
            Rec(5, "bfv.load_ciphertext", 6_000_000, 8_000_000, parent=4)]
    assert spans.host_readings([unit]) == {
        "demo.bfv_wire_ms": 4.0, "demo.dec_decrypt_ms": 4.0, "demo.bfv_encode_ms": 0.1}


def test_attrs_are_read_a_unit():
    units = [[Rec(1, "bloom.insert", 0, 10, route="subslice", chunks=6, keys=600),
              Rec(2, "bloom.table_to_host", 0, 1_000, bytes=2_000),
              Rec(3, "roles.probe", 0, 5)],
             [Rec(1, "bloom.insert", 0, 10, route="direct", chunks=1, keys=100),
              Rec(2, "bloom.table_to_host", 0, 3_000, bytes=2_000)]]
    assert spans.attrs_a_unit(units) == {
        "bloom.insert": {"route": {"subslice": 0.5, "direct": 0.5}, "chunks": 3.5, "keys": 350},
        "bloom.table_to_host": {"bytes": 2_000, "gb_per_s": 1.0}}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is there")
def test_main_refuses_without_a_card(capsys):
    assert spans.main(["--workload", "demo-tiny", "--seed", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
def test_the_harness_leaves_the_recorder_off(root, trace):
    profiling.drain()
    out = harness.run_cell(root, "demo-tiny", tiny.SEED, 1.0, trace, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert not profiling.enabled() and profiling.drain() == []


@pytest.mark.parametrize("cell", ["demo-tiny", "pipe-tiny"])
def test_measure_reads_the_programs_spans(root, cell):
    out = spans.measure(root, cell, tiny.SEED, 4, 1, "cpu")
    assert not profiling.enabled() and profiling.drain() == []
    assert out["device"] is None and out["idle_gaps"] is None  # no device on the CPU
    if cell == "demo-tiny":
        want = {"demo.dec_table_copy_ms", "demo.dec_host_copy_ms", "demo.dec_decrypt_ms",
                "demo.bfv_encode_ms", "demo.bfv_wire_ms"}
        assert out["spans_a_unit"]["roles.bf_join"] == 1
        assert 0.5 < out["host_cover"]["dec"] <= 1
        wire = out["attrs_a_unit"]["roles.bf_join"]
        assert wire["bytes"] > 0 and wire["gb_per_s"] > 0
        assert out["attrs_a_unit"]["bloom.insert"]["route"] == {"plain": 1}
    else:
        want = {"pipeline.enqueue_ms"}
        assert out["attrs_a_unit"] == {"pipeline.step": {"checks": 4096}}  # one row of n
        assert out["spans_a_unit"] == {"pipeline.decode": 1, "pipeline.evaluate": 1,
                                       "pipeline.probe": 1, "pipeline.step": 1}
    assert set(out["readings"]) == want and all(v > 0 for v in out["readings"].values())
    assert set(out["recorder_cost"]) == {f"{side}_{q}_ms" for side in ("off", "on")
                                         for q in ("q1", "p50", "q3")}
    assert all(v > 0 for v in out["recorder_cost"].values())
