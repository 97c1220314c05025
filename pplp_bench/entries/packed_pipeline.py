"""Entry module: the batched proximity service, step after step.

A unit is one step of the function that
``pplp_tpu_torch.parallel.pipeline.build_packed_pipeline_bf`` returns:
``rows * n`` coefficient-packed checks evaluated homomorphically, decoded
on the card and probed in the server's filter, with their verdicts copied
to the host. The batches are encrypted in set-up and cycled, so the window
holds only the server's work and the client's decode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pplp_bench.reference import bloom as ref_bloom
from pplp_bench.reference import proximity as ref
from pplp_bench.traffic import BatchTraffic, Sample


@dataclass
class State:
    traffic: BatchTraffic
    step: object
    inputs: list
    table: tuple
    sample: Sample
    kept: list = field(default_factory=list)  # (batch, verdicts) of the sampled steps


def set_up(session) -> State:
    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.parallel import pipeline

    c, mix, dev = session.config, session.mix, session.device
    span = session.spans.span
    t = 1 << c["plain_modulus_bits"]
    traffic = _traffic(session)
    with span("context", sync=True):
        ctx = bfv.BFVContext.build(
            bfv.EncryptionParameters.bfv(traffic.n, t, profile=c["profile"]), dev)
    if ctx.L != c["limbs"]:
        raise ValueError(f"the chain has {ctx.L} limbs, the configuration states {c['limbs']}")
    with span("keys_filter", sync=True):
        gen = torch.Generator(device=dev).manual_seed(traffic.key_seed())
        kg = bfv.KeyGenerator(ctx, gen)
        sk, pk = kg.secret_key(), kg.create_public_key()
        bf = pipeline.build_pipeline_filter(t, c["s"], traffic.radius, c["w"], dev)
    with span("encrypt", sync=True):
        enc = bfv.Encryptor(ctx, pk)
        inputs = [pipeline.make_packed_inputs(ctx, enc, *traffic.batch(b), gen)
                  for b in range(traffic.batches)]
    step = pipeline.build_packed_pipeline_bf(ctx, sk, c["xb"], c["yb"], c["s"], traffic.radius,
                                             c["w"], c["w"].bit_length())
    state = State(traffic, step, inputs, (bf.bits_device, bf._salts_device(), bf.table_size),
                  Sample(session.seed, int(mix["verdict_check_every"])))
    with span("warm_steps", sync=True):
        for b in range(traffic.batches):  # every batch once
            step(*inputs[b], *state.table).cpu()
    return state


def unit(session, state: State, i: int):
    b = i % state.traffic.batches
    with session.spans.span("step"):
        near = state.step(*state.inputs[b], *state.table)
    with session.spans.span("to_host"):
        host = near.cpu()
    if i in state.sample:
        state.kept.append((b, host.numpy().reshape(-1)))


def release(state: State) -> tuple:
    return state.traffic, state.kept


def _traffic(session) -> BatchTraffic:
    c = session.config
    return BatchTraffic(session.mix, 1 << c["poly_modulus_degree_bits"], c["xb"], c["yb"],
                        session.seed)


def blank_record(session, units: int) -> tuple:
    """What ``release`` gives after ``units`` steps, with no verdict in it:
    a control fills it in."""
    traffic = _traffic(session)
    sample = Sample(session.seed, int(session.mix["verdict_check_every"]))
    return traffic, [(i % traffic.batches, None) for i in range(units) if i in sample]


def check(session, record, control: str | None = None) -> dict:
    """Every verdict of the sampled steps against the reference's verdicts
    of its batch. With ``control``, the reference's weakened copy stands
    where the program's verdicts were."""
    traffic, kept = record
    c, dev = session.config, session.device
    t = 1 << c["plain_modulus_bits"]
    mixed = c["bf_index_mode"] == "mixed"
    want, tested, bf, weak = [], [], None, None
    for b in range(traffic.batches):
        xa, ya = traffic.batch(b)
        near, salts, bf = ref.packed_checks(xa, ya, c["xb"], c["yb"], traffic.radius, c["s"],
                                            c["w"], t, c["false_positive_probability"],
                                            c["bf_seed"], mixed, dev, bf=bf)
        want.append(near.cpu().numpy())
        tested.append(int(salts.sum()))
        if control is not None:
            got, _, weak = ref.packed_checks(xa, ya, c["xb"], c["yb"], traffic.radius, c["s"],
                                             c["w"], t, c["false_positive_probability"],
                                             c["bf_seed"], mixed, dev, control=control, bf=weak)
            kept = [(kb, got.cpu().numpy() if kb == b else v) for kb, v in kept]
    session.work["salts_tested"] = tested
    wrong = sum(int(np.count_nonzero(v != want[b])) for b, v in kept)
    return {"verdict_wrong": (wrong, 0), "steps_unchecked": (int(not kept), 0)}


def work(session, record) -> dict:
    traffic, _ = record
    c = session.config
    salts, bits = ref_bloom.optimal_parameters(traffic.radius ** 2, c["false_positive_probability"])
    return {"per_unit": traffic.checks, "rows": traffic.rows, "n": traffic.n,
            "limbs": c["limbs"], "salts": salts, "table_bits": bits,
            "batches": traffic.batches}


def end_to_end(session, window) -> dict:
    return {"checks_per_s": len(window.unit_s) * session.work["per_unit"] / window.window_s}
