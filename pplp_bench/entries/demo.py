"""Entry module: the single-process proximity test, back to back.

A unit is one test as ``pplp_tpu_torch.protocol.demo.run_local_demo``
runs it (the reference's ``./pplp``): a fresh client and server
(``ProximityClient``, ``ProximityServer``), then ``setParms``, ``kGen``,
``setBF``, ``enc``, ``homoCalc`` and ``dec`` in its order, each stage
between two synchronizes. The stages are driven here rather than through
``run_local_demo`` so that the benchmark hands the server the blinding it
drew (the reference is given the same) and keeps the w || filter message
that went over the wire. The BFV context stays cached between tests, as
the program caches it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from pplp_bench import yardstick
from pplp_bench.reference import bloom as ref_bloom
from pplp_bench.reference import proximity as ref
from pplp_bench.traffic import DemoTraffic, Sample

# A test drawn apart from the window's stream, to warm every shape up.
WARM_TEST = 1 << 40


@dataclass
class Record:
    results: dict = field(default_factory=dict)  # i -> (blind distance, near, one-coefficient flag)
    wire: dict = field(default_factory=dict)  # i -> w || filter, for the sampled tests


@dataclass
class State:
    traffic: DemoTraffic
    sample: Sample
    record: Record = field(default_factory=Record)


def _protocol_config(c: dict, radius: int, test):
    from pplp_tpu_torch.protocol.config import ProtocolConfig

    return ProtocolConfig(
        xa=test.xa, ya=test.ya, xb=test.xb, yb=test.yb, radius=radius,
        plain_modulus_bits=c["plain_modulus_bits"],
        poly_modulus_degree_bits=c["poly_modulus_degree_bits"],
        false_positive_probability=c["false_positive_probability"],
        bf_seed=c["bf_seed"], profile=c["profile"], seed=test.key_seed,
        bf_index_mode=c["bf_index_mode"])


def run_test(session, test):
    """One test through the program's roles -> (blind distance, near, the
    program's own flag that the plaintext has one coefficient, the w ||
    filter message)."""
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol.roles import ProximityClient, ProximityServer

    span = session.spans.span
    cfg = _protocol_config(session.config, int(session.mix["radius"]), test)
    client = ProximityClient(cfg, session.device)
    server = ProximityServer(cfg, session.device, blinding=Blinding(r=test.r, s=test.s, w=test.w))
    with span("setParms", sync=True):
        server.receive_parms(client.parms_message())
    with span("kGen", sync=True):
        client.keygen()
    with span("setBF", sync=True):
        server.build_bloom_filter()
    with span("enc", sync=True):
        blobs = client.ciphertext_messages()
    with span("homoCalc", sync=True):
        server.receive_ciphertexts(blobs)
        bd_blob = server.blind_distance_message()
    with span("dec", sync=True):
        bf_blob = server.bf_message()
        client.receive_bf(bf_blob)
        near = client.receive_blind_distance(bd_blob)
    return client.blind_distance, near, client.decrypt_consistent, bf_blob


def set_up(session) -> State:
    state = _state(session)
    run_test(session, state.traffic.test(WARM_TEST))
    return state


def _state(session) -> State:
    return State(DemoTraffic(session.mix, session.config["plain_modulus_bits"], session.seed),
                 Sample(session.seed, int(session.mix["wire_check_every"])))


def unit(session, state: State, i: int):
    bd, near, consistent, blob = run_test(session, state.traffic.test(i))
    state.record.results[i] = (bd, near, consistent)
    if i in state.sample:
        state.record.wire[i] = blob


def release(state: State) -> tuple:
    return state.traffic, state.record


def blank_record(session, units: int) -> tuple:
    """What ``release`` gives after ``units`` tests, with no output in it:
    a control fills it in."""
    state = _state(session)
    for i in range(units):
        state.record.results[i] = (None, None, True)
        if i in state.sample:
            state.record.wire[i] = None
    return release(state)


def check(session, record, control: str | None = None) -> dict:
    """Every test's blind distance and verdict against the reference; the
    sampled tests' wire messages byte for byte. ``decrypt_flagged`` is no
    comparison with the reference: it counts the tests whose decrypted
    plaintext the program itself flagged as holding more than the constant
    coefficient (``ProximityClient.decrypt_consistent``). With ``control``,
    the reference's weakened copy stands where the program's outputs were."""
    traffic, rec = record
    c = session.config
    t = 1 << c["plain_modulus_bits"]
    mixed = c["bf_index_mode"] == "mixed"
    bd_wrong = near_wrong = flagged = wire_wrong = 0
    for i, (bd, near, consistent) in rec.results.items():
        test = traffic.test(i)
        wire = i in rec.wire
        want = ref.demo_test(test, traffic.radius, t, c["false_positive_probability"],
                             c["bf_seed"], mixed, session.device, wire)
        if control is not None:
            got = ref.demo_test(test, traffic.radius, t, c["false_positive_probability"],
                                c["bf_seed"], mixed, session.device, wire, control=control)
            bd, near, consistent = got["blind_distance"], got["near"], True
            if wire:
                rec.wire[i] = got["wire"]
        bd_wrong += bd != want["blind_distance"]
        near_wrong += near != want["near"]
        flagged += not consistent
        if wire:
            wire_wrong += rec.wire[i] != want["wire"]
    return {"blind_distance_wrong": (bd_wrong, 0), "verdict_wrong": (near_wrong, 0),
            "decrypt_flagged": (flagged, 0), "wire_wrong": (wire_wrong, 0),
            "wire_unchecked": (int(not rec.wire), 0)}


def work(session, record) -> dict:
    traffic, _ = record
    c = session.config
    salts, bits = ref_bloom.optimal_parameters(traffic.radius ** 2, c["false_positive_probability"])
    return {"per_unit": 1, "keys": traffic.radius ** 2, "salts": salts, "table_bits": bits}


def end_to_end(session, window) -> dict:
    tests = len(window.unit_s)
    return {"tests_per_s": tests / window.window_s,
            "test_ms_p90": 1e3 * yardstick.quantile(window.unit_s, 0.9)}
