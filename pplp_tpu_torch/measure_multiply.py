"""Measure the ct x ct multiply path and the mulmod chain on one CUDA card.

    python3 -m pplp_tpu_torch.measure_multiply [--profile tpu|seal] [--json PATH]
        [--n N --batch B --t-bits T] [--sass]

The workload is the one ``chip_smoke.py`` drives: n = 4096 on the tpu chain
(4 primes, |B_sk| = 6, the fused m31 kernels of ``csrc/behz.cu``) or, with
``--profile seal``, on SEAL's BFVDefault(4096) chain (3 primes of 36-37
bits, |B_sk| = 5, the u64 route of ``csrc/behz64.cu`` around the u64
transforms), t = 2^16, random canonical residues made from a seeded
``torch.Generator``, keys from ``behz.make_keys`` (the default width: 2 on
tpu, 1 on seal) and ``create_relin_keys`` at the other width. The script

1. checks the default-width multiply + relinearize at batch 256 against the
   plain version (bit-exact) once, and fails if they differ;
2. times at batch 256, with CUDA events: ``multiply_relinearize`` at
   widths 2 and 1, ``multiply`` alone, ``relinearize`` alone at widths 2
   and 1, the plain version of the default-width call (one call per window
   on seal, where it takes seconds), and the mulmod chain on [256, 4, 4096]
   beside its plain version (tpu only). Every variant is warmed once,
   then timed once per round as the mean of a window of calls; the rounds
   run the variants in order and reversed, alternately. Reported: the
   median over rounds and the min-max;
3. sweeps the batch (16, 64, 256, 1024) of the default-width call, median
   of 3 rounds (at the default n only);
4. runs ``torch.profiler`` over 10 default-width calls at batch 256: device time
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
intermediates, the packed keys once. ``kernel_counts64`` does the same for
the u64 route, whose kernels are its logical phases one for one: each
operation at the fewest 32-bit multiplies it needs (``U64_*_MULS``),
converted to u64 Shoup products (``U64_PRODUCT_MULS``).

``--n``, ``--batch`` and ``--t-bits`` move the workload to another chain
of the profile (the seal chains at n = 8192, t = 2^56, batch 64 and
n = 32768, batch 2 are ``chip_smoke.py``'s). ``--sass`` also counts, per
kernel function of the profile's BEHZ library, its SASS instructions and
among them the 32-bit multiplies by kind (``cuobjdump -sass``), the static
code that the profiler's times run.

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
          "add_kernel": "behz_add", "mulmod_chain_kernel": "mulmod_chain",
          "ntt_forward_u64_kernel": "ntt_forward_u64",
          "ntt_forward_u64_cluster_kernel": "ntt_forward_u64",
          "ntt_inverse_u64_kernel": "ntt_inverse_u64",
          "ntt_inverse_u64_cluster_kernel": "ntt_inverse_u64",
          "to_bsk64_kernel": "behz64_to_bsk", "tensor64_kernel": "behz64_tensor",
          "floor_sk64_kernel": "behz64_floor_sk", "lift64_kernel": "behz64_lift",
          "keyprod64_kernel": "behz64_keyprod", "add64_kernel": "behz64_add",
          "dgk_mulmod_kernel": "dgk_mulmod", "dgk_powmod_lanes_kernel": "dgk_powmod_lanes",
          "dgk_powmod_shared_kernel": "dgk_powmod_shared",
          "dgk_blind_distance_kernel": "dgk_blind_distance"}
_KERNEL_NAME = re.compile(r"(?:^|[\s:])(\w+_kernel)[<(]")
CEILING_STEPS = 256  # chain steps at which the chain is bound by integer work
# The bound's two rates on one H100 SXM: device memory (NVIDIA's data sheet)
# and Shoup products at the integer-multiply peak: 132 SMs x 64 32-bit
# integer multiplies per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 1.98 GHz (the top SM
# clock) / 3 multiplies per product (w x, umulhi(w', x), est q).
BYTES_PER_S = 3.35e12
MULS_PER_S = 132 * 64 * 1.98e9
MULMODS_PER_S = MULS_PER_S / 3
# A u64 (m62) Shoup product w x - umul64hi(w', x) q: 32-bit multiplies per
# product, from the kernels' SASS; ``measure_ntt --sass`` counts them.
U64_PRODUCT_MULS = 10
MULMODS64_PER_S = MULS_PER_S / U64_PRODUCT_MULS
# The u64 route's other operations at the fewest 32 x 32-bit partial
# products each needs (a Shoup product, 10, is two low words of 3 and a
# high word of 4). One term of a 128-bit conversion sum is a whole
# 64 x 64 -> 128-bit product: its 4 partial products. The reduction of a
# 128-bit z by r = floor(2^128 / q) = rh 2^64 + r0 (rh < 2^32, q > 2^32)
# forms its estimate from z0 rh (2), z1 r0 (4) and z1 rh (2), then the low
# word of est q (3): 11 (behz64.cu's reduce128; the high word of z0 r0 is
# left out, and a second conditional subtract covers the carry it may
# hold); of a 64-bit value, 2 x 3 + 3 = 9. A general product mod q is a
# whole product and a 128-bit reduction: 15. These count what the
# functions need, for every design of the kernels alike.
U64_MAC_MULS = 4
U64_REDUCE128_MULS = 11
U64_REDUCE64_MULS = 9
U64_MULMOD_MULS = U64_MAC_MULS + U64_REDUCE128_MULS
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


def bound(c: dict, mulmods_per_s: float = MULMODS_PER_S) -> dict:
    """``c`` with its bound: the larger of its bytes over BYTES_PER_S and its
    Shoup products over ``mulmods_per_s`` (the u32 rate unless given), in ms,
    and which side binds."""
    t_bytes = c["bytes"] / BYTES_PER_S * 1e3
    t_ops = c["mulmods"] / mulmods_per_s * 1e3
    return {**c, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def transform_counts(rows: int, n: int, inverse: bool, in_bytes: int, out_bytes: int,
                     u64: bool = False) -> dict:
    """One standalone transform launch over ``rows`` rows of n, its residues
    read at ``in_bytes`` and written at ``out_bytes``, with its bound; ``u64``
    counts its Shoup products at the u64 kernels' rate."""
    return bound(_phase(rows, rows * transform_mulmods(n, inverse),
                        rows * n * (in_bytes + out_bytes)),
                 MULMODS64_PER_S if u64 else MULMODS_PER_S)


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


def kernel_counts64(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """The u64 route's launches of one multiply + relinearize (``behz64_cuda``),
    each with its bytes at its interface (8 B per residue: int64 in and out,
    u64 intermediates, the packed keys at 32 B per key coefficient once), its
    logical work in u64 Shoup-product equivalents (the fewest 32-bit
    multiplies of each operation, ``U64_*_MULS``, over ``U64_PRODUCT_MULS``)
    and its bound at ``MULMODS64_PER_S``. D digits: one limb each when
    D == L, else consecutive pairs (``L - D`` of them).

    The conversions count each output as one sum of products reduced once:
    every modular step between two conversions that stays in one modulus
    folds into the conversion's constants (behz64.cu's header). to_bsk: a
    Shoup product per source limb, then per B_sk limb L + 1 terms and a
    reduction. floor_sk: a Shoup product per Q limb, then per prime of B
    L + 1 terms and a reduction, alpha's L + K terms and a reduction, and
    per Q limb K terms and a reduction."""
    e, l = batch * n, K - 1  # coefficients of one limb over the batch
    wide = L - D  # two-limb digits
    shoup, mac, red, red64 = (U64_PRODUCT_MULS, U64_MAC_MULS, U64_REDUCE128_MULS,
                              U64_REDUCE64_MULS)
    muls = {
        "behz64_to_bsk": 4 * e * (L * shoup + K * ((L + 1) * mac + red)),
        "behz64_tensor": e * (L + K) * 3 * U64_MULMOD_MULS,
        "behz64_floor_sk": 3 * e * (L * shoup + l * ((L + 1) * mac + red)
                                    + (L + K) * mac + red + L * (K * mac + red)),
        "behz64_lift": e * (D * L * red64 + wide * (red64 + shoup + L * shoup)),
        "behz64_keyprod": e * L * 2 * D * shoup,
        "behz64_add": 0,
    }
    nbytes = {
        "behz64_to_bsk": 8 * 4 * e * (L + K),
        "behz64_tensor": 8 * 7 * e * (L + K),
        "behz64_floor_sk": 8 * 3 * e * (L + K + L),
        "behz64_lift": 8 * e * L * (1 + D),
        "behz64_keyprod": 8 * e * L * (D + 2) + 32 * D * L * n,
        "behz64_add": 8 * 6 * e * L,
    }
    out = {k: _phase(e, muls[k] / U64_PRODUCT_MULS, nbytes[k]) for k in muls}
    fwd_row, inv_row = transform_mulmods(n, False), transform_mulmods(n, True)
    fwd_rows, inv_rows = batch * (4 * L + 4 * K + D * L), batch * (3 * L + 3 * K + 2 * L)
    out["ntt_forward_u64"] = _phase(fwd_rows, fwd_rows * fwd_row, 16 * fwd_rows * n, 3)
    out["ntt_inverse_u64"] = _phase(inv_rows, inv_rows * inv_row, 16 * inv_rows * n, 3)
    return {k: bound(v, MULMODS64_PER_S) for k, v in out.items()}


def call_counts(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """One multiply + relinearize as one function, with its bound: every
    phase's Shoup products; bytes of its interface (four int64 polynomials
    in, two out, the packed keys once)."""
    mulmods = sum(v["mulmods"] for v in work_counts(n, L, K, D, batch).values())
    return bound(_phase(batch, mulmods, batch * n * 48 * L + 16 * D * L * n))


def call_counts64(n: int, L: int, K: int, D: int, batch: int) -> dict:
    """``call_counts`` of the u64 route: the logical work of every phase
    (``kernel_counts64``, in u64 Shoup products) against the call's
    interface at 8 B per residue."""
    mulmods = sum(v["mulmods"] for v in kernel_counts64(n, L, K, D, batch).values())
    return bound(_phase(batch, mulmods, batch * n * 48 * L + 32 * D * L * n), MULMODS64_PER_S)


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


_SASS_KINDS = {"IMAD.WIDE": r"IMAD\.WIDE", "IMAD.HI": r"IMAD\.HI",
               "IMAD": r"IMAD(?![.\w]*(WIDE|HI))", "LDS": r"\bLDS", "LDG": r"\bLDG",
               "STG": r"\bSTG"}


def sass_counts(library) -> dict:
    """{kernel function: {"instructions": n, kind: n for _SASS_KINDS}} of a
    built kernel library, from ``cuobjdump -sass``."""
    from .ops.cuda_build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        code = [ln for ln in part.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln)]
        counts = {"instructions": len(code)}
        counts.update({k: sum(bool(re.search(rx, ln)) for ln in code)
                       for k, rx in _SASS_KINDS.items()})
        out[name] = counts
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", choices=("tpu", "seal"), default="tpu",
                    help="the chain: tpu (m31, csrc/behz.cu) or seal (m62, csrc/behz64.cu)")
    ap.add_argument("--json", default=None, help="write every number here")
    ap.add_argument("--n", type=int, default=N, help="ring degree (default %(default)s)")
    ap.add_argument("--batch", type=int, default=BATCH, help="batch (default %(default)s)")
    ap.add_argument("--t-bits", type=int, default=T_BITS,
                    help="plaintext modulus bits (default %(default)s)")
    ap.add_argument("--sass", action="store_true",
                    help="count the BEHZ library's SASS instructions per kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_multiply: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1

    from . import bfv
    from .bfv import behz
    from .bfv.behz_fused import FusedMultiplier
    from .ops import behz64_cuda, behz_cuda, cuda_build, mulmod_chain

    seal = args.profile == "seal"
    n, batch_size = args.n, args.batch
    dev = cuda_device(0)
    card = smi_line()
    ctx = bfv.BFVContext.build(
        bfv.EncryptionParameters.bfv(n, 1 << args.t_bits, profile=args.profile), dev)
    mul = behz.multiplier(ctx)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sk, rlk_default = behz.make_keys(ctx, gen)
    w_default = behz.default_relin_width(ctx)
    rlk = {w_default: rlk_default,
           3 - w_default: behz.create_relin_keys(ctx, sk, gen, width=3 - w_default)}
    fused = {w: FusedMultiplier(ctx, k) for w, k in rlk.items()}
    fd = fused[w_default]

    def cts(batch):
        def poly():
            x = torch.randint(0, 1 << 62, (batch, ctx.L, ctx.n), generator=gen,
                              device=dev, dtype=torch.int64)
            return x % ctx.q2
        return bfv.Ciphertext((poly(), poly())), bfv.Ciphertext((poly(), poly()))

    ct1, ct2 = cts(batch_size)
    ct3 = fd.multiply(ct1, ct2)
    got = fd.relinearize(ct3)
    want = behz.relinearize(ctx, mul.multiply(ct1, ct2), rlk_default)
    if not all(torch.equal(a, b) for a, b in zip(got.polys, want.polys)):
        print("measure_multiply: the kernel differs from the plain version", file=sys.stderr)
        return 1
    x = torch.randint(0, mulmod_chain.Q, CHAIN_SHAPE, generator=gen, device=dev,
                      dtype=torch.int64)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rate = MULMODS64_PER_S if seal else MULMODS_PER_S
    print(f"[card] {sms} SMs, top SM clock {clocks}; {'MULMODS64' if seal else 'MULMODS'}"
          f"_PER_S {rate:.4e}", flush=True)
    result = {"card": card, "sms": sms, "max_sm_clock": clocks, "profile": args.profile,
              "n": n, "L": ctx.L, "bsk": mul.K, "t_bits": args.t_bits, "batch": batch_size,
              "rounds": ROUNDS, "mulmods_per_s": rate, "default_width": w_default}
    variants = {f"multiply_relinearize_w{w}": (
        lambda w=w: fused[w].multiply_relinearize(ct1, ct2), 10) for w in (2, 1)}
    variants["multiply"] = (lambda: fd.multiply(ct1, ct2), 10)
    variants.update({f"relinearize_w{w}": (lambda w=w: fused[w].relinearize(ct3), 10)
                     for w in (2, 1)})
    variants[f"plain_multiply_relinearize_w{w_default}"] = (
        lambda: behz.relinearize(ctx, mul.multiply(ct1, ct2), rlk_default), 1 if seal else 3)
    if not seal:
        variants["mulmod_chain"] = (lambda: mulmod_chain.chain(x), 20)
        variants["plain_mulmod_chain"] = (lambda: mulmod_chain.chain_plain(x), 5)
    result["calls"] = rounds_ms(variants, ROUNDS)
    for name, s in result["calls"].items():
        rate_s = ""
        if name.startswith("multiply_relinearize"):
            rate_s = f" = {batch_size / (s['median_ms'] / 1e3):.1f} mult+relin/s"
        elif name == "mulmod_chain":
            rate_s = f" = {x.numel() * mulmod_chain.STEPS / (s['median_ms'] / 1e3):.4e} mulmods/s"
        print(f"[calls] {args.profile} {name}: median {s['median_ms']:.4f} ms "
              f"[{s['min_ms']:.4f}-{s['max_ms']:.4f}] over {s['rounds']} rounds{rate_s}",
              flush=True)

    result["sweep"] = {}
    for batch in SWEEP if n == N else ():
        a, b = (ct1, ct2) if batch == batch_size else cts(batch)
        s = rounds_ms({"w": (lambda a=a, b=b: fd.multiply_relinearize(a, b), 10)}, 3)["w"]
        s["per_s"] = batch / (s["median_ms"] / 1e3)
        result["sweep"][batch] = s
        print(f"[sweep] {args.profile} width {w_default}, batch {batch}: "
              f"{s['median_ms']:.4f} ms ({s['per_s']:.1f} mult+relin/s)", flush=True)

    prof = profile_phases(lambda: fd.multiply_relinearize(ct1, ct2), PROFILE_CALLS)
    D = len(rlk_default.digit_groups(ctx.L))
    if seal:
        counts = kernel_counts64(n, ctx.L, mul.K, D, batch_size)
        call = call_counts64(n, ctx.L, mul.K, D, batch_size)
    else:
        counts = kernel_counts(n, ctx.L, mul.K, D, batch_size)
        call = call_counts(n, ctx.L, mul.K, D, batch_size)
        result["work"] = {k: bound(v) for k, v in work_counts(n, ctx.L, mul.K, D,
                                                               batch_size).items()}
    for p, v in prof["phases"].items():
        if p in counts:
            v.update(counts[p])
            v["bound_share"] = v["bound_ms"] / v["ms_per_call"]
    result["profile_phases"] = prof
    result["call"] = call
    busy = prof["busy_ms"] / PROFILE_CALLS
    total = sum(c["bound_ms"] for c in counts.values())
    print(f"[profile] {PROFILE_CALLS} width-{w_default} calls at n = {n}, batch {batch_size}: "
          f"device busy "
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
    if not seal:
        # A chain call is shorter than its host launch path, so its CUDA-event
        # window reads the launch rate; the profiler reads the kernel itself.
        result["chain_profile"] = {}
        for steps in (mulmod_chain.STEPS, CEILING_STEPS):
            prof = profile_phases(lambda steps=steps: mulmod_chain.chain(x, steps=steps), 20)
            result["chain_profile"][steps] = prof
            ms = prof["phases"]["mulmod_chain"]["ms_per_call"]
            rate_c = x.numel() * steps / (ms / 1e3)
            print(f"[profile] mulmod_chain x{steps} on {CHAIN_SHAPE}: {ms:.4f} ms of device "
                  f"time per call ({rate_c:.4e} mulmods/s, {100 * rate_c / MULMODS_PER_S:.1f}% "
                  f"of MULMODS_PER_S), device busy {100 * prof['busy_share']:.1f}% of the "
                  f"window", flush=True)
    if args.sass:
        source = (behz64_cuda if seal else behz_cuda).SOURCE
        result["sass"] = sass_counts(cuda_build.build([source])[source])
        for name, c in result["sass"].items():
            print(f"[sass] {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    print(card, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
