"""Measure the ct x ct multiply path and the mulmod chain on one CUDA card.

    python3 -m pplp_tpu_torch.measure_multiply [--json PATH]

The workload is the one ``chip_smoke.py`` drives: n = 4096 on the tpu chain
(4 primes, |B_sk| = 6), t = 2^16, random canonical residues made from a
seeded ``torch.Generator``, keys from ``behz.make_keys``. The script

1. checks the width-2 multiply + relinearize at batch 256 against the plain
   version (bit-exact) once, and fails if they differ;
2. times at batch 256, with CUDA events: ``multiply_relinearize`` at
   widths 2 and 1, ``multiply`` alone, ``relinearize`` alone at widths 2
   and 1, the plain version of the width-2 call, and the mulmod chain on
   [256, 4, 4096] beside its plain version. Every variant is warmed once,
   then timed once per round as the mean of a window of calls; the rounds
   run the variants in order and reversed, alternately. Reported: the
   median over rounds and the min-max;
3. sweeps the batch (16, 64, 256, 1024) of the width-2 call, median of 3
   rounds;
4. runs ``torch.profiler`` over 10 width-2 calls at batch 256: device time
   per kernel (ms per call, share) and the device's busy share of the
   CUDA-event window; then over 20 chain calls, whose kernel is shorter
   than its host launch path, so that only the profiler reads its time.

Prints one line per measurement and the card's name and power limit, and
writes every number as JSON to ``--json`` if given. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from .device import cuda_device, smi_line, window_ms

N = 4096
T_BITS = 16
BATCH = 256
SWEEP = (16, 64, 256, 1024)
CHAIN_SHAPE = (256, 4, 4096)
PROFILE_CALLS = 10
ROUNDS = 5
SEED = 4096
# Kernel name fragment -> phase, for the profile.
PHASES = ("ntt_forward", "ntt_inverse", "to_bsk", "tensor", "floor_sk", "lift",
          "keyprod", "add", "mulmod_chain")


def rounds_ms(variants: dict, rounds: int) -> dict:
    """{name: (fn, iters)} -> {name: {median_ms, min_ms, max_ms, rounds}}.

    Each variant is warmed once; round r runs the variants in order when r
    is even and reversed when it is odd."""
    for fn, _ in variants.values():
        fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in variants}
    names = list(variants)
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            fn, iters = variants[name]
            samples[name].append(window_ms(fn, iters))
    return {name: {"median_ms": statistics.median(s), "min_ms": min(s), "max_ms": max(s),
                   "rounds": len(s)} for name, s in samples.items()}


def profile_phases(fn, calls: int) -> dict:
    """Device time per phase (ms per call) and the busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(stop)
    us = {}
    launches = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        phase = next((p for p in PHASES if f"{p}_kernel" in e.name), "other: " + e.name)
        us[phase] = us.get(phase, 0.0) + e.time_range.elapsed_us()
        launches[phase] = launches.get(phase, 0) + 1
    busy_ms = sum(us.values()) / 1e3
    return {
        "window_ms": window, "busy_ms": busy_ms,
        "busy_share": busy_ms / window if window else 0.0,
        "phases": {p: {"ms_per_call": v / 1e3 / calls, "share": v / 1e3 / busy_ms,
                       "launches_per_call": launches[p] / calls}
                   for p, v in sorted(us.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write every number here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_multiply: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1

    from . import bfv
    from .bfv import behz
    from .bfv.behz_fused import FusedMultiplier
    from .ops import mulmod_chain

    dev = cuda_device(0)
    card = smi_line()
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, 1 << T_BITS, profile="tpu"),
                               dev)
    mul = behz.multiplier(ctx)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk, rlk2 = behz.make_keys(ctx, gen)
    rlk1 = behz.create_relin_keys(ctx, sk, gen, width=1)
    fused2, fused1 = FusedMultiplier(ctx, rlk2), FusedMultiplier(ctx, rlk1)

    def cts(batch):
        def poly():
            x = torch.randint(0, 1 << 62, (batch, ctx.L, ctx.n), generator=gen,
                              device=dev, dtype=torch.int64)
            return x % ctx.q2
        return bfv.Ciphertext((poly(), poly())), bfv.Ciphertext((poly(), poly()))

    ct1, ct2 = cts(BATCH)
    ct3 = fused2.multiply(ct1, ct2)
    got = fused2.relinearize(ct3)
    want = behz.relinearize(ctx, mul.multiply(ct1, ct2), rlk2)
    if not all(torch.equal(a, b) for a, b in zip(got.polys, want.polys)):
        print("measure_multiply: the kernel differs from the plain version", file=sys.stderr)
        return 1
    x = torch.randint(0, mulmod_chain.Q, CHAIN_SHAPE, generator=gen, device=dev,
                      dtype=torch.int64)

    result = {"card": card, "n": N, "L": ctx.L, "bsk": mul.K, "t_bits": T_BITS,
              "batch": BATCH, "rounds": ROUNDS}
    result["calls"] = rounds_ms({
        "multiply_relinearize_w2": (lambda: fused2.multiply_relinearize(ct1, ct2), 10),
        "multiply_relinearize_w1": (lambda: fused1.multiply_relinearize(ct1, ct2), 10),
        "multiply": (lambda: fused2.multiply(ct1, ct2), 10),
        "relinearize_w2": (lambda: fused2.relinearize(ct3), 10),
        "relinearize_w1": (lambda: fused1.relinearize(ct3), 10),
        "plain_multiply_relinearize_w2": (
            lambda: behz.relinearize(ctx, mul.multiply(ct1, ct2), rlk2), 3),
        "mulmod_chain": (lambda: mulmod_chain.chain(x), 20),
        "plain_mulmod_chain": (lambda: mulmod_chain.chain_plain(x), 5),
    }, ROUNDS)
    for name, s in result["calls"].items():
        rate = ""
        if name.startswith("multiply_relinearize"):
            rate = f" = {BATCH / (s['median_ms'] / 1e3):.1f} mult+relin/s"
        elif name == "mulmod_chain":
            rate = f" = {x.numel() * mulmod_chain.STEPS / (s['median_ms'] / 1e3):.4e} mulmods/s"
        print(f"[calls] {name}: median {s['median_ms']:.4f} ms "
              f"[{s['min_ms']:.4f}-{s['max_ms']:.4f}] over {s['rounds']} rounds{rate}",
              flush=True)

    result["sweep"] = {}
    for batch in SWEEP:
        a, b = (ct1, ct2) if batch == BATCH else cts(batch)
        s = rounds_ms({"w2": (lambda a=a, b=b: fused2.multiply_relinearize(a, b), 10)},
                      3)["w2"]
        s["per_s"] = batch / (s["median_ms"] / 1e3)
        result["sweep"][batch] = s
        print(f"[sweep] batch {batch}: {s['median_ms']:.4f} ms "
              f"({s['per_s']:.1f} mult+relin/s)", flush=True)

    prof = profile_phases(lambda: fused2.multiply_relinearize(ct1, ct2), PROFILE_CALLS)
    result["profile"] = prof
    print(f"[profile] {PROFILE_CALLS} width-2 calls at batch {BATCH}: device busy "
          f"{prof['busy_ms'] / PROFILE_CALLS:.4f} ms per call, "
          f"{100 * prof['busy_share']:.1f}% of the window", flush=True)
    for p, v in prof["phases"].items():
        print(f"[profile] {p}: {v['ms_per_call']:.4f} ms per call, "
              f"{100 * v['share']:.1f}%, {v['launches_per_call']:g} launches per call",
              flush=True)
    # A chain call is shorter than its host launch path, so its CUDA-event
    # window reads the launch rate; the profiler reads the kernel itself.
    prof = profile_phases(lambda: mulmod_chain.chain(x), 20)
    result["chain_profile"] = prof
    ms = prof["phases"]["mulmod_chain"]["ms_per_call"]
    print(f"[profile] mulmod_chain on {CHAIN_SHAPE}: {ms:.4f} ms of device time per call "
          f"({x.numel() * mulmod_chain.STEPS / (ms / 1e3):.4e} mulmods/s), device busy "
          f"{100 * prof['busy_share']:.1f}% of the window", flush=True)
    print(card, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
