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
   per kernel (ms per call, share, launches), beside each kernel's
   shape-derived work (``kernel_counts``: the bytes its interface moves,
   Shoup products), its bound (``bound``) and its share of the bound; the
   device's busy share of the CUDA-event window; then over 20 chain calls
   at 16 steps, whose kernel is shorter than its host launch path, so that
   only the profiler reads its time, and at 256 steps, where the chain is
   bound by integer work, as a reading of the card's Shoup-product rate
   beside ``MULMODS_PER_S``.

Two byte counts, for two uses. ``work_counts`` is the logical work of each
phase at 4 B per residue whatever a kernel stores: a yardstick that is the
same for every design of the phases (the parent's int64 kernels, the fused
u32 ones). ``kernel_counts`` (and every bound) counts the bytes each
kernel's interface must move: int64 ciphertexts in and out, u32
intermediates, the packed keys once.

Prints one line per measurement and the card's name and power limit, and
writes every number as JSON to ``--json`` if given. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
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
# Device kernel name -> kernel (the wrappers' launch-count names).
PHASES = {"ntt_forward_kernel": "ntt_forward", "ntt_inverse_kernel": "ntt_inverse",
          "ntt_forward_u32_kernel": "ntt_forward_u32",
          "ntt_inverse_u32_kernel": "ntt_inverse_u32", "to_bsk_kernel": "behz_to_bsk",
          "tensor_ntt_kernel": "behz_tensor_ntt", "floor_sk_kernel": "behz_floor_sk",
          "relin_ntt_kernel": "behz_relin_ntt", "tensor_kernel": "behz_tensor",
          "lift_kernel": "behz_lift", "keyprod_kernel": "behz_keyprod",
          "add_kernel": "behz_add", "mulmod_chain_kernel": "mulmod_chain"}
_KERNEL_NAME = re.compile(r"(?:^|[\s:])(\w+_kernel)[<(]")
CEILING_STEPS = 256  # chain steps at which the chain is bound by integer work
# The bound's two rates on one H100 SXM: device memory (NVIDIA's data sheet)
# and Shoup products at the integer-multiply peak: 132 SMs x 64 32-bit
# integer multiplies per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 1.98 GHz (the top SM
# clock) / 3 multiplies per product (w x, umulhi(w', x), est q).
BYTES_PER_S = 3.35e12
MULMODS_PER_S = 132 * 64 * 1.98e9 / 3
RESIDUE_BYTES = 4  # the least that holds an m31 residue


def _phase(rows_or_elems, mulmods, nbytes, launches=1) -> dict:
    return {"rows": rows_or_elems, "mulmods": mulmods, "bytes": nbytes, "launches": launches}


def transform_mulmods(n: int, inverse: bool) -> int:
    """Shoup products of one row's transform: n/2 per stage, and the
    inverse's n^-1 product."""
    return (n // 2) * (n.bit_length() - 1) + (n if inverse else 0)


def work_counts(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """The logical work of one multiply + relinearize, per phase, from the
    shapes: rows (transforms) or coefficients, Shoup products (a modular
    reduction counts as one) and bytes at 4 B per residue, each input and
    output read or written once. K = |B_sk|, D = gadget digits."""
    B, l, rb = batch, K - 1, RESIDUE_BYTES
    fwd_rows = B * (4 * L + 4 * K + D * L)
    inv_rows = B * (3 * L + 3 * K + 2 * L)
    elems_q, elems = B * L * n, B * (L + K) * n
    return {
        "ntt_forward": _phase(fwd_rows, fwd_rows * transform_mulmods(n, False),
                              fwd_rows * n * 2 * rb),
        "ntt_inverse": _phase(inv_rows, inv_rows * transform_mulmods(n, True),
                              inv_rows * n * 2 * rb),
        "to_bsk": _phase(4 * B * n, 4 * B * n * (L + K * L + 3 * K), 4 * elems * rb),
        "tensor": _phase(elems, 3 * elems, 7 * elems * rb),
        "floor_sk": _phase(3 * B * n, 3 * B * n * (2 * L + K * L + 3 * K + l + (l + 2)
                                                   + L * l + 2 * L),
                           3 * B * (2 * L + K) * n * rb),
        # Width-1 digits reduce once per limb; width-2 digits also form t
        # and its product (L - D two-limb digits).
        "lift": _phase(elems_q, elems_q * ((2 * D - L) + 3 * (L - D)), (1 + D) * elems_q * rb),
        "keyprod": _phase(elems_q, 2 * D * elems_q, (D + 2) * elems_q * rb),
        "add": _phase(elems_q, 0, 6 * elems_q * rb),
    }


def bound(c: dict) -> dict:
    """``c`` with its bound: the larger of its bytes over BYTES_PER_S and its
    Shoup products over MULMODS_PER_S, in ms, and which side binds."""
    t_bytes = c["bytes"] / BYTES_PER_S * 1e3
    t_ops = c["mulmods"] / MULMODS_PER_S * 1e3
    return {**c, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def transform_counts(rows: int, n: int, inverse: bool, in_bytes: int, out_bytes: int) -> dict:
    """One standalone transform launch over ``rows`` rows of n, its residues
    read at ``in_bytes`` and written at ``out_bytes``, with its bound."""
    return bound(_phase(rows, rows * transform_mulmods(n, inverse),
                        rows * n * (in_bytes + out_bytes)))


def kernel_counts(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """``work_counts`` split over the kernels one multiply + relinearize
    launches at this n (the fused route up to ``behz_cuda``'s limits, the
    separate launches above), each with its bound. Bytes are what each
    kernel's interface moves: int64 ciphertexts in and out (8 B), u32
    intermediates (4 B), the packed keys (16 B per key coefficient) once."""
    from .ops.behz_cuda import FUSED_RELIN_MAX_N, FUSED_TENSOR_MAX_N

    w = work_counts(n, L, K, D, batch)
    fwd_row, inv_row = transform_mulmods(n, False), transform_mulmods(n, True)
    e = batch * n  # coefficients of one limb over the batch
    keys = 16 * D * L * n
    rows_t, rows_r = batch * (L + K), batch * L
    out = {"behz_to_bsk": {**w["to_bsk"], "bytes": e * (32 * L + 16 * K)},
           "behz_floor_sk": {**w["floor_sk"], "bytes": e * (36 * L + 12 * K)}}
    fwd = inv = (0, 0, 0)  # rows, bytes, launches of the standalone u32 transforms
    if n <= FUSED_TENSOR_MAX_N:
        out["behz_tensor_ntt"] = _phase(
            rows_t, 4 * rows_t * fwd_row + w["tensor"]["mulmods"] + 3 * rows_t * inv_row,
            e * (44 * L + 28 * K))
    else:
        out["behz_tensor"] = {**w["tensor"], "bytes": 28 * e * (L + K), "launches": 2}
        fwd = (4 * rows_t, e * (48 * L + 32 * K), 5)
        inv = (3 * rows_t, 24 * e * (L + K), 2)
    if n <= FUSED_RELIN_MAX_N:
        out["behz_relin_ntt"] = _phase(
            rows_r, w["lift"]["mulmods"] + D * rows_r * fwd_row + w["keyprod"]["mulmods"]
            + 2 * rows_r * inv_row, 40 * e * L + keys)
    else:
        out["behz_lift"] = {**w["lift"], "bytes": e * L * (8 + 4 * D)}
        out["behz_keyprod"] = {**w["keyprod"], "bytes": e * L * (4 * D + 8) + keys}
        out["behz_add"] = {**w["add"], "bytes": 40 * e * L}
        fwd = (fwd[0] + D * rows_r, fwd[1] + 8 * D * e * L, fwd[2] + 1)
        inv = (inv[0] + 2 * rows_r, inv[1] + 16 * e * L, inv[2] + 1)
    if fwd[0]:
        out["ntt_forward_u32"] = _phase(fwd[0], fwd[0] * fwd_row, fwd[1], fwd[2])
        out["ntt_inverse_u32"] = _phase(inv[0], inv[0] * inv_row, inv[1], inv[2])
    return {k: bound(v) for k, v in out.items()}


def call_counts(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """One multiply + relinearize as one function, with its bound: every
    phase's Shoup products; bytes of its interface (four int64 polynomials
    in, two out, the packed keys once)."""
    mulmods = sum(v["mulmods"] for v in work_counts(n, L, K, D, batch).values())
    return bound(_phase(batch, mulmods, batch * n * 48 * L + 16 * D * L * n))


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
        m = _KERNEL_NAME.search(e.name)
        phase = PHASES.get(m.group(1), "other: " + e.name) if m else "other: " + e.name
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {sms} SMs, top SM clock {clocks}; MULMODS_PER_S {MULMODS_PER_S:.4e}",
          flush=True)
    result = {"card": card, "sms": sms, "max_sm_clock": clocks, "n": N, "L": ctx.L,
              "bsk": mul.K, "t_bits": T_BITS, "batch": BATCH, "rounds": ROUNDS,
              "mulmods_per_s": MULMODS_PER_S}
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
    D = len(rlk2.digit_groups(ctx.L))
    counts = kernel_counts(N, ctx.L, mul.K, D, BATCH)
    for p, v in prof["phases"].items():
        if p in counts:
            v.update(counts[p])
            v["bound_share"] = v["bound_ms"] / v["ms_per_call"]
    result["profile"] = prof
    result["work"] = {k: bound(v) for k, v in work_counts(N, ctx.L, mul.K, D, BATCH).items()}
    result["call"] = call = call_counts(N, ctx.L, mul.K, D, BATCH)
    busy = prof["busy_ms"] / PROFILE_CALLS
    total = sum(c["bound_ms"] for c in counts.values())
    print(f"[profile] {PROFILE_CALLS} width-2 calls at batch {BATCH}: device busy "
          f"{busy:.4f} ms per call, {100 * prof['busy_share']:.1f}% of the window; sum of "
          f"kernel bounds {total:.4f} ms ({100 * total / busy:.1f}%); the call's own bound "
          f"{call['bound_ms']:.4f} ms ({call['bound_by']}: {call['bytes'] / 1e6:.1f} MB, "
          f"{call['mulmods'] / 1e6:.1f}M Shoup products), {100 * call['bound_ms'] / busy:.1f}%",
          flush=True)
    for p, v in prof["phases"].items():
        extra = ""
        if "bound_ms" in v:
            extra = (f"; {v['bytes'] / 1e6:.1f} MB at its I/O widths, "
                     f"{v['mulmods'] / 1e6:.1f}M Shoup products, bound {v['bound_ms']:.4f} ms "
                     f"({v['bound_by']}), {100 * v['bound_share']:.1f}% of bound")
        print(f"[profile] {p}: {v['ms_per_call']:.4f} ms per call, "
              f"{100 * v['share']:.1f}%, {v['launches_per_call']:g} launches per call{extra}",
              flush=True)
    # A chain call is shorter than its host launch path, so its CUDA-event
    # window reads the launch rate; the profiler reads the kernel itself.
    result["chain_profile"] = {}
    for steps in (mulmod_chain.STEPS, CEILING_STEPS):
        prof = profile_phases(lambda steps=steps: mulmod_chain.chain(x, steps=steps), 20)
        result["chain_profile"][steps] = prof
        ms = prof["phases"]["mulmod_chain"]["ms_per_call"]
        rate = x.numel() * steps / (ms / 1e3)
        print(f"[profile] mulmod_chain x{steps} on {CHAIN_SHAPE}: {ms:.4f} ms of device time "
              f"per call ({rate:.4e} mulmods/s, {100 * rate / MULMODS_PER_S:.1f}% of "
              f"MULMODS_PER_S), device busy {100 * prof['busy_share']:.1f}% of the window",
              flush=True)
    print(card, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
