"""The benchmark's entry modules, reference, control and yardstick on the CPU.

Each entry runs a tiny cell of its own (``tiny.tree``) through the whole
run but the card: set-up, the window, the check against the plain
reference, the metrics. The faults planted under the timed path, and the
control, must make ``correct`` false.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pplp_bench import control, harness, traffic, yardstick
from pplp_bench.reference import bloom as ref_bloom
from pplp_bench.reference import proximity as ref
from pplp_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("tiny"))


def run(root, cell, trace=False, seconds=2.5, seed=tiny.SEED):
    return harness.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", ["demo-tiny", "pipe-tiny", "pipe-tiny-dev"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_agrees_with_the_reference(root, cell, trace):
    out = run(root, cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v == 0 for v, _ in out["checks"].values())
    names = set(out["metrics"])
    if trace:
        host = {"demo-tiny": {"demo.setbf_ms", "demo.dec_ms", "demo.bfv_ms"},
                "pipe-tiny": {"pipeline.batch_ms_p90.device_bound"},
                "pipe-tiny-dev": {"pipeline.batch_ms_p90.device_bound"}}[cell]
        assert host <= names
        # No device on the CPU: the device readers find nothing and are left out.
        assert not any(n.startswith("device.") or "roofline" in n for n in names)
        assert out["stretch"] is not None and out["stretch"].units >= 1
    else:
        e2e = {"demo-tiny": {"setup_s", "tests_per_s", "test_ms_p90"},
               "pipe-tiny": {"setup_s", "checks_per_s.device_bound"},
               "pipe-tiny-dev": {"setup_s", "checks_per_s.device_bound"}}[cell]
        assert names == e2e
        assert all(m["value"] > 0 for m in out["metrics"].values())


def _stale(fn):
    """Each step answers with the step before's answer: the set-up's warm
    steps end on the last batch, so the window's first step is stale."""
    last = []

    def wrapped(*args):
        out = fn(*args).clone()
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return wrapped


def _half(fn):
    def wrapped(*args):
        out = fn(*args).clone()
        out.view(-1)[out.numel() // 2:] = False
        return out
    return wrapped


def _altered(fn):
    def wrapped(*args):
        out = fn(*args).clone()
        out.view(-1)[0] ^= True
        return out
    return wrapped


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_pipeline_faults_read_not_correct(root, monkeypatch, fault):
    """A step that returns the answer of the step before; half the checks
    left out; one verdict altered where it is produced."""
    from pplp_tpu_torch.parallel import pipeline

    build = pipeline.build_packed_pipeline_bf
    monkeypatch.setattr(pipeline, "build_packed_pipeline_bf",
                        lambda *a, **k: fault(build(*a, **k)))
    out = run(root, "pipe-tiny", seconds=1.0)
    assert not out["correct"]
    assert out["checks"]["verdict_wrong"][0] > 0


def _no_insert(self, blinding, sq_radius):
    self.inserted_element_count += sq_radius


def _half_insert(orig):
    def insert(self, blinding, sq_radius):
        orig(self, blinding, sq_radius // 2)
        self.inserted_element_count += sq_radius - sq_radius // 2
    return insert


@pytest.mark.parametrize("fault", ["state unchanged", "half the keys", "answer altered"])
def test_demo_faults_read_not_correct(root, monkeypatch, fault):
    """The server's filter left as it was made; half of its keys left out;
    the client's blind distance altered where it is decrypted."""
    from pplp_tpu_torch.primitives.bloom import BloomFilter
    from pplp_tpu_torch.protocol.roles import ProximityClient

    if fault == "state unchanged":
        monkeypatch.setattr(BloomFilter, "insert_blind_distances", _no_insert)
    elif fault == "half the keys":
        monkeypatch.setattr(BloomFilter, "insert_blind_distances",
                            _half_insert(BloomFilter.insert_blind_distances))
    else:
        decrypt = ProximityClient.receive_blind_distance

        def altered(self, blob):
            near = decrypt(self, blob)
            self.blind_distance += 1
            return near
        monkeypatch.setattr(ProximityClient, "receive_blind_distance", altered)
    out = run(root, "demo-tiny", seconds=1.0)
    assert not out["correct"]
    wrong = {"state unchanged": "wire_wrong", "half the keys": "wire_wrong",
             "answer altered": "blind_distance_wrong"}[fault]
    assert out["checks"][wrong][0] > 0


@pytest.mark.parametrize("cell", ["demo-tiny", "pipe-tiny"])
def test_control_reads_not_correct(root, cell):
    for seed in (3, 2**31 + 11):
        got = control.readings(root, cell, seed, 6, "cpu")
        assert any(v > lim for v, lim in got.values()), got


def test_traffic_demo_stream():
    mix = {"radius": 64, "near_share": 0.5, "far_radius_factor": 4, "coordinate_span": 1 << 20}
    a = traffic.DemoTraffic(mix, 56, 2**31 + 5)
    tests = [a.test(i) for i in range(40)]
    assert tests == [traffic.DemoTraffic(mix, 56, 2**31 + 5).test(i) for i in range(40)]
    assert sum(t.near for t in tests) == 20
    assert all(abs(sum(t.near for t in tests[:k]) - k / 2) <= 1 for k in range(1, 41))
    for t in tests:
        assert (t.d2 < 64 * 64) == t.near and t.d2 < (4 * 64) ** 2
        assert t.s % 2 == 1 and t.s * (64 * 64 - 1 + t.r) < 1 << 56 and 0 < t.w < 1 << 16
        assert min(t.xa, t.ya, t.xb, t.yb) >= 0 and max(t.xa, t.ya) < 1 << 27
    other = traffic.DemoTraffic(mix, 56, 2**31 + 6)
    assert [other.test(i) for i in range(40)] != tests


def test_traffic_batches():
    mix = {"radius": 99, "near_share": 0.5, "far_radius_factor": 4, "rows": 2, "batches": 3}
    bt = traffic.BatchTraffic(mix, 256, 1000, 900, 2**32 + 1)
    for b in range(3):
        xa, ya = bt.batch(b)
        d2 = (xa.astype(np.int64) - 1000) ** 2 + (ya.astype(np.int64) - 900) ** 2
        assert xa.shape == (512,) and int((d2 < 99 * 99).sum()) == 256
        assert (d2 < (4 * 99) ** 2).all()
    assert not np.array_equal(bt.batch(0)[0], bt.batch(1)[0])
    np.testing.assert_array_equal(bt.batch(2)[1], traffic.BatchTraffic(mix, 256, 1000, 900,
                                                                       2**32 + 1).batch(2)[1])


def test_sample_keeps_every_kth():
    s = traffic.Sample(2**33, 5)
    kept = [i for i in range(30) if i in s]
    assert kept[0] < 3 and np.all(np.diff(kept) == 5) and len(kept) == 6


def test_reference_filter_sizes():
    # The reference's filters: config[3]'s 187,920 bits and 13 salts; the
    # demo's r = 4096 table of 964,867,048 bits and 40 salts.
    assert ref_bloom.optimal_parameters(99 * 99, 1e-4) == (13, 187920)
    assert ref_bloom.optimal_parameters(4096 * 4096, 1e-12) == (40, 964867048)


def test_reference_filter_holds_its_keys():
    bf = ref.server_filter(20, 501, 20, 0xA5A5, 1 << 20, 1e-4, 0xA5A5A5A5, True, "cpu")
    bd = (501 * (torch.arange(400) + 20)) % (1 << 20)
    member, tested = bf.probe(*ref.key_words(bd, 0xA5A5))
    assert bool(member.all()) and bool((tested == bf.hashes).all())
    far, tested = bf.probe(*ref.key_words(bd + 7, 0xA5A5))
    assert int(far.sum()) <= 2 and bool((tested >= 1).all())
    assert len(bf.serialize()) == ref_bloom.HEADER.size + 4 * bf.hashes + bf.table_bits // 8


def test_yardstick_bounds():
    # The demo's r = 4096 insert: 16.7M keys x 40 salts x 5 multiplies.
    ins = yardstick.bloom_insert(4096 * 4096, 40, 964867048)
    assert ins["side"] == "ops" and abs(ins["seconds"] - 2.006e-4) < 1e-7
    step = yardstick.packed_step(25, 4, 4096, 187920, 13, 102400 * 7)
    assert step["side"] == "ops" and 3e-6 < step["seconds"] < 6e-6
    assert yardstick.quantile([1.0] * 9 + [11.0], 0.9) == pytest.approx(2.0)
    assert yardstick.quantile(list(range(101)), 0.9) == pytest.approx(90.0)
