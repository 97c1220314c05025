"""The port's span recorder (``utils.profiling``) on the CPU.

* off (the default): ``span`` is one shared no-op and a demo records nothing;
* on: nested spans carry their parents (per thread), ``drain`` clears, and a
  ``StageTimer`` stage is a span of its name, which the spans inside it nest in;
* ``clock_anchor`` maps a span onto ``torch.profiler``'s clock;
* ``run_local_demo`` records every span of the demo's path inside its stage,
  with the wire messages' lengths;
* the packed step gives the same verdicts with the recorder on and off, and
  one evaluate / decode / probe span a step.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pplp_tpu_torch import bfv
from pplp_tpu_torch.ops.primes import get_primes
from pplp_tpu_torch.parallel import pipeline
from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo
from pplp_tpu_torch.utils import profiling

DEMO = dict(xa=1234, ya=1212, xb=1000, yb=1000, radius=96, poly_modulus_degree_bits=12,
            plain_modulus_bits=40, profile="tpu", seed=1234, false_positive_probability=1e-6)
# Each span of the demo's path and the stages it runs in.
DEMO_SPANS = {
    "bfv.keygen": {"kGen"},
    "bloom.insert": {"setBF"},
    "bfv.plain_encode": {"enc", "homoCalc"},
    "bfv.encrypt": {"enc"},
    "bfv.save_ciphertext": {"enc", "homoCalc"},
    "bfv.load_ciphertext": {"homoCalc", "dec"},
    "bfv.evaluate": {"homoCalc"},
    "bloom.table_to_host": {"dec"},
    "roles.bf_join": {"dec"},
    "bloom.deserialize": {"dec"},
    "roles.decrypt": {"dec"},
    "roles.probe": {"dec"},
}
STAGES = ("setParms", "kGen", "setBF", "enc", "homoCalc", "dec")


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _on(fn, *args, **kwargs):
    profiling.enable()
    try:
        return fn(*args, **kwargs)
    finally:
        profiling.disable()


def test_off_span_is_the_shared_no_op_and_a_demo_records_nothing():
    assert not profiling.enabled()
    off = profiling.span("a")
    assert profiling.span("b", bytes=3) is off
    with off as rec:
        rec.set(bytes=4)
    res = run_local_demo(ProtocolConfig(**DEMO), verbose=False, device="cpu")
    assert set(res.stage_ns) == set(STAGES)
    assert profiling.drain() == []


def test_nested_spans_carry_their_parents_and_drain_clears():
    def other_thread():
        with profiling.span("thread"):
            pass

    def record():
        with profiling.span("outer", level=0) as outer:
            with profiling.span("inner") as inner:
                inner.set(bytes=7)
                t = threading.Thread(target=other_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
            with profiling.span("sibling"):
                pass
        return outer, inner

    outer, inner = _on(record)
    got = profiling.drain()
    assert [s.name for s in got] == ["thread", "inner", "sibling", "outer"]
    by = {s.name: s for s in got}
    assert by["outer"].parent is None and by["outer"].attrs == {"level": 0}
    assert by["inner"].parent == by["sibling"].parent == outer.id
    assert by["inner"].attrs == {"bytes": 7}
    assert by["thread"].parent is None  # another thread's spans do not nest in this one's
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len({s.id for s in got}) == 4
    assert profiling.drain() == []


def test_stage_is_a_span_of_its_name():
    timer = profiling.StageTimer()

    def stages():
        with timer.stage("enc"):
            with profiling.span("bfv.encrypt"):
                pass
        with timer.stage("dec"):
            pass

    with timer.stage("off"):  # the recorder off: timed, not recorded
        pass
    assert profiling.drain() == []
    _on(stages)
    inner, enc, dec = profiling.drain()
    assert [(s.name, s.attrs, s.parent) for s in (enc, dec)] == [("enc", {}, None),
                                                                 ("dec", {}, None)]
    assert (inner.name, inner.parent) == ("bfv.encrypt", enc.id)
    assert set(timer.ns) == {"off", "enc", "dec"}
    assert timer.ns["enc"] >= inner.end_ns - inner.start_ns


def test_span_maps_onto_the_profilers_clock():
    """A span around a ``record_function`` range, mapped through
    ``clock_anchor``, holds the range's midpoint: on the kineto events'
    clock (ns) and as the profiler's events give it (us from
    ``trace_start_ns``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def traced():
        anchor = profiling.clock_anchor()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("outer"):
                with record_function("inner"):
                    time.sleep(0.02)
        return anchor, prof

    (pc0, unix0), prof = _on(traced)
    (rec,) = profiling.drain()
    kineto = prof.profiler.kineto_results
    (ev,) = [e for e in kineto.events() if e.name() == "inner"]
    offset = unix0 - pc0
    assert rec.start_ns + offset <= (ev.start_ns() + ev.end_ns()) / 2 <= rec.end_ns + offset
    (fe,) = [e for e in prof.events() if e.name == "inner"]
    us = lambda t: (t + offset - kineto.trace_start_ns()) / 1000  # noqa: E731
    assert us(rec.start_ns) <= (fe.time_range.start + fe.time_range.end) / 2 <= us(rec.end_ns)


def test_demo_records_every_span_inside_its_stage():
    res = _on(run_local_demo, ProtocolConfig(**DEMO), verbose=False, device="cpu")
    got = profiling.drain()
    by_id = {s.id: s for s in got}
    names = {s.name for s in got}
    assert set(DEMO_SPANS) | set(STAGES) <= names

    def stage_of(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    for s in got:
        if s.name in STAGES:
            assert s.parent is None and s.attrs == {}
            continue
        stage = stage_of(s)
        assert stage.name in DEMO_SPANS[s.name], (s.name, stage.name)
        assert stage.start_ns <= s.start_ns <= s.end_ns <= stage.end_ns
    copies = [s for s in got if s.name in ("roles.bf_join", "bloom.deserialize",
                                           "bloom.table_to_host")]
    one = {s.name: s.attrs for s in copies}
    assert len(copies) == len(one) == 3
    # The message's assembly, its table's copy and the client's read are
    # disjoint spans of the stage, none nested in another.
    assert all(by_id[s.parent].name == "dec" for s in copies)
    assert one["roles.bf_join"] == {"bytes": res.bf_wire_bytes}
    assert one["bloom.deserialize"] == {"bytes": res.bf_wire_bytes - 8, "copied": 0}
    assert one["bloom.table_to_host"] == {"bytes": res.bf_table_bits // 8, "pinned": 0}
    saved = sorted(s.attrs["bytes"] for s in got if s.name == "bfv.save_ciphertext")
    loaded = sorted(s.attrs["bytes"] for s in got if s.name == "bfv.load_ciphertext")
    assert len(saved) == 4 and saved == loaded
    encodes = [s.attrs["count"] for s in got if s.name == "bfv.plain_encode"]
    assert sorted(encodes) == [1, 1, 1, 1, 1, 3]
    # The CPU's unpacked filter inserts in padded chunks, each key at least once.
    inserts = [s.attrs for s in got if s.name == "bloom.insert"]
    assert all(a["route"] == "plain" and a["chunks"] == 1 for a in inserts)
    assert sum(a["keys"] for a in inserts) >= DEMO["radius"] ** 2


def test_packed_step_same_verdicts_with_the_recorder_on_and_off():
    n, t, xb, yb, s_blind, r_blind, w = 256, 1 << 20, 1000, 900, 501, 99, 0xA5A5
    chain = list(get_primes(28, 2, n)) + list(get_primes(27, 2, n))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain), "cpu")
    gen = torch.Generator().manual_seed(21)
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rng = np.random.default_rng(21)
    xa = (xb + rng.integers(-150, 150, 2 * n)).astype(np.uint64)
    ya = (yb + rng.integers(-150, 150, 2 * n)).astype(np.uint64)
    cts = pipeline.make_packed_inputs(ctx, bfv.Encryptor(ctx, pk), xa, ya, gen)
    bf = pipeline.build_pipeline_filter(t, s_blind, r_blind, w, "cpu")
    fn = pipeline.build_packed_pipeline_bf(ctx, sk, xb, yb, s_blind, r_blind, w,
                                           w.bit_length())
    table = (bf.bits_device, bf._salts_device(), bf.table_size)
    off = fn(*cts, *table)
    assert profiling.drain() == []
    on = [_on(fn, *cts, *table) for _ in range(2)]
    assert all(torch.equal(v, off) for v in on)
    d2 = (xa.astype(np.int64) - xb) ** 2 + (ya.astype(np.int64) - yb) ** 2
    assert (off.numpy().reshape(-1)[d2 < r_blind ** 2]).all()
    got = profiling.drain()
    steps = [s for s in got if s.name == "pipeline.step"]
    assert len(steps) == 2 and all(s.attrs == {"checks": 2 * n} for s in steps)
    for part in ("pipeline.evaluate", "pipeline.decode", "pipeline.probe"):
        spans = [s for s in got if s.name == part]
        assert sorted(s.parent for s in spans) == sorted(s.id for s in steps), part
