"""Time the DGK kernels on one CUDA card, against their bounds.

    python3 -m pplp_tpu_torch.measure_dgk [--batches 1000,10000,30000]
        [--parts probe,kernels,calls,bsgs,sass] [--keys 2048,320,16] [--json PATH]

BASELINE config[2] as ``chip_smoke.py``'s ``dgk`` phase runs it: keys
(k, t, l) = (2048, 320, 16) from seed 5 (``--keys`` picks others, such as
1024,160,16 for the kernels at W = 33), ciphertexts of B comparisons from
``comparison_inputs`` (the same function and seed ``chip_smoke.py`` uses),
800-bit randomness. ``--parts`` picks what runs (default
``probe,kernels,calls,bsgs``):

* ``probe``: the multiply-add probe (``ops/mulmod_chain.mad_probe``), the
  rate the card reaches for 32 x 32 -> 64-bit multiply-adds as
  IMAD.WIDE.U32 and as IMAD + IMAD.HI pairs, in slots of its 32-bit
  multiply rate;
* ``kernels``: at every B of ``--batches``, each DGK kernel under
  ``torch.profiler`` (device ms a launch): h^r and g^m
  (``dgk_powmod_lanes``), encrypt's product (``dgk_mulmod``), the blind
  distance (``dgk_blind_distance``), the decrypt's c^vpq on the blind
  distances (``dgk_powmod_shared``) and the BSGS giant step (``dgk_mulmod``
  by G^-m), each with its Montgomery products, bound (``kernel_bounds``,
  ``lanes_bound``) and share of it, its share of the older count, and where
  ``probe`` ran, its share at the probe's rate too;
* ``calls``: at B = 10,000 the three calls and the full comparison by CUDA
  events (median of windows), the comparisons/s eval-only and full, the
  peak device memory of a full comparison, and the split of
  ``encrypt_batch``: its window, the device time of its kernels in it, and
  the rest (host time between them);
* ``bsgs``: ``decrypt_batch_device_bsgs`` on the first 1,000 blind
  distances by CUDA events (median), and one call under ``torch.profiler``
  split into the giant steps' kernel, the c^vpq kernel, the per-step table
  probe and select (every other kernel: the fingerprint folds, gathers and
  selects in plain torch) and the host time between launches;
* ``sass``: a probe of the group product's limb row, compiled once and
  twice in two forms (``csrc/dgk_rows.cuh``'s ``mad_row``, the kernels' u64
  multiply-adds, and two PTX carry chains): the SASS instructions of one
  32 x 32-bit limb product in each; and ``dgk_mont.cu`` built anew: each
  DGK kernel's instruction counts and ptxas's register and stack report.

``kernel_bounds`` counts the Montgomery products each kernel's function
needs on this run's exponents: for an exponentiation the fewer of the
binary method's (``dgk_products``) and the kernels' fixed window's
(``window_products``), for the blind distance the joint walk's
(``blind_distance_products``); each product is 2 W^2 + W multiply-adds of
32 x 32 -> 64 bits, each ``MAD_SLOTS`` = 2 of the card's 32-bit multiply
slots (``MULS_PER_S``). Beside it stands the share of the older count (the
binary method, and the reference chain's conversions for the blind
distance), so that earlier records compare.

``kernels``, ``calls`` and ``bsgs`` use only what every tree of the port
with ``dgk_cuda.mulmod_const`` has, so a copy of this file runs them inside
a ``git archive`` of such a tree: parent, change, change, parent in one run
on one card compares two designs.

Prints one line per measurement with the card's name and power limit, and
writes every number as JSON to ``--json`` if given. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from .device import cuda_device, smi_line, window_ms
from .measure_multiply import BYTES_PER_S, MULS_PER_S

DGK_KEYS = (2048, 320, 16)  # (k, t, l) of bench.py:165, BASELINE config[2]
DGK_SEED = 5
DGK_XB, DGK_YB, DGK_S = 123321, 123654, 37  # bench.py:171
INPUT_SEED = 2048
MAIN_B = 10_000
BATCHES = (1_000, 10_000, 30_000)
# 32-bit multiply slots (MULS_PER_S) of one 32 x 32 -> 64-bit multiply-add
# at the card's nominal rate: an IMAD.WIDE.U32 issues at half the 32-bit
# rate, as the two halves it writes, which the other kernels' bounds charge
# as an IMAD and an IMAD.HI, one slot each. The probe (``probe``) reads what
# the card reaches, which is more.
MAD_SLOTS = 2
WINDOW = 3  # dgk_mont.cu's kWindow: the exponentiations' window bits
PARTS = ("probe", "kernels", "calls", "bsgs", "sass")
BSGS_B = 1_000
MAD_STEPS = 4096
# The row probe: the kernel's mad_row (csrc/dgk_rows.cuh) and the same row
# as two PTX carry chains, each run once and twice.
_ROW_PROBE = """
#include "dgk_rows.cuh"
template <int L>
__device__ __forceinline__ uint32_t ptx_row(uint32_t (&t)[L], uint32_t a,
                                            const uint32_t (&b)[L]) {{
  uint32_t lo_carry, c;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(a), "r"(b[0]));
#pragma unroll
  for (int j = 1; j < L; ++j)
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(a), "r"(b[j]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(lo_carry));
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a), "r"(b[0]));
#pragma unroll
  for (int j = 1; j + 1 < L; ++j)
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(a), "r"(b[j]));
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(c) : "r"(a), "r"(b[L - 1]), "r"(lo_carry));
  return c;
}}
template <int R>
__global__ void row_probe(uint32_t* io) {{
  uint32_t t[{L}], b[{L}];
#pragma unroll
  for (int j = 0; j < {L}; ++j) {{ t[j] = io[j]; b[j] = io[{L} + j]; }}
  uint32_t a = io[2 * {L}], c = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) c ^= {row}<{L}>(t, a ^ r, b);
#pragma unroll
  for (int j = 0; j < {L}; ++j) io[j] = t[j];
  io[{L}] = c;
}}
template __global__ void row_probe<1>(uint32_t*);
template __global__ void row_probe<2>(uint32_t*);
"""
_ROWS = {"u64 multiply-add (the kernel's)": "pplp_dgk::mad_row", "ptx carry chains": "ptx_row"}


def dgk_products(e: int) -> int:
    """Montgomery products of a left-to-right binary exponentiation by ``e``
    from its top bit: a square per lower bit, a product per lower set bit."""
    return e.bit_length() + bin(e).count("1") - 2 if e else 0


def blind_distance_products(xb: int, yb: int, s: int) -> int:
    """Montgomery products a lane of ``dgk_blind_distance`` as the kernel runs
    it: c2 R', c3 R', c2 c3 R'; the joint walk over xb and yb (a squaring
    per bit below the top one, a product per such bit where either exponent
    has it set); c1 and back to the domain; the binary walk over s; cz, the
    domain, cr."""
    def walk(e1, e2):
        top = max(e1.bit_length(), e2.bit_length())
        return sum(1 + ((e1 | e2) >> i & 1) for i in range(top - 1))

    return 3 + walk(xb, yb) + 2 + walk(s, 0) + 3


def window_products(bits: int, k: int = WINDOW) -> int:
    """Montgomery products a lane of ``dgk_powmod_lanes``/``_shared`` over an
    exponent of ``bits`` bits by the k-bit fixed window: to the domain, the
    table's 2^k - 2, k squarings and a product for each window below the
    top one, back."""
    return (1 << k) + max(-(-bits // k) - 1, 0) * (k + 1)


def exp_products(e: int) -> int:
    """Montgomery products base^e mod n needs a lane, the conversions in and
    out included: the fewer of the binary method's and the window's."""
    return min(2 + dgk_products(e), window_products(e.bit_length()))


def dgk_bound(W: int, products: int, nbytes: int) -> dict:
    """A DGK kernel's bound: ``products`` Montgomery products of 2 W^2 + W
    32 x 32 -> 64-bit multiply-adds, ``MAD_SLOTS`` multiply slots each at
    ``MULS_PER_S``, against ``nbytes`` read or written once at 3.35 TB/s."""
    t_ops = products * (2 * W * W + W) * MAD_SLOTS / MULS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "products": products}


def _with_reference(W: int, products: int, reference: int, nbytes: int) -> dict:
    return {**dgk_bound(W, products, nbytes), "reference_products": reference,
            "reference_bound_ms": dgk_bound(W, reference, nbytes)["bound_ms"]}


def kernel_bounds(W: int, D: int, B: int, vpq: int) -> dict:
    """The bounds of the kernels with shared or no exponents on B lanes of W
    limbs: the product (two products a lane; its rows int64 digits, D a
    number), the giant step (one product), c^vpq (u32 limb rows) and the
    blind distance at bench.py's exponents; each with the products the
    function needs and ``reference_products``, the older count."""
    digits, limbs = 8 * D * B, 4 * W * B  # bytes of one row a lane, in each form
    exps = (DGK_XB, DGK_YB, DGK_S)
    ref = 10 + sum(map(dgk_products, exps))
    return {
        "dgk_mulmod": _with_reference(W, 2 * B, 2 * B, 3 * digits),
        "giant step": _with_reference(W, B, B, 2 * digits),
        "dgk_powmod_shared": _with_reference(W, B * exp_products(vpq),
                                             B * (2 + dgk_products(vpq)), 2 * limbs),
        "dgk_blind_distance": _with_reference(W, B * blind_distance_products(*exps),
                                              B * ref, 6 * digits),
    }


def lanes_bound(W: int, exps) -> dict:
    """``dgk_powmod_lanes``'s bound on per-lane exponents ``exps`` and one
    base (u32 rows: the base, the exponents' words, the results)."""
    B = len(exps)
    ew = (max(e.bit_length() for e in exps) + 31) // 32
    nbytes = 4 * (W + B * ew + B * W)
    return _with_reference(W, sum(map(exp_products, exps)),
                           sum(2 + dgk_products(e) for e in exps), nbytes)


def comparison_inputs(pub, t: int, l: int, B: int, seed: int = INPUT_SEED) -> dict:
    """B comparisons' plaintexts and randomness, as ``chip_smoke.py`` encrypts
    them: coordinates around (DGK_XB, DGK_YB), the five messages of each
    (x^2 + y^2, -2x, -2y, s(xb^2 + yb^2), s r), randomness of 2.5 t bits, and
    the blind distance each decrypts to."""
    from .dgk.dgk import dgk_random_num

    rng, u = random.Random(seed), pub.u
    xa = [DGK_XB + rng.randrange(-300, 301) for _ in range(B)]
    ya = [DGK_YB + rng.randrange(-300, 301) for _ in range(B)]
    r_blind = dgk_random_num(l, rng)
    msgs = [[(x * x + y * y) % u for x, y in zip(xa, ya)], [(-2 * x) % u for x in xa],
            [(-2 * y) % u for y in ya], [DGK_S * (DGK_XB ** 2 + DGK_YB ** 2) % u] * B,
            [DGK_S * r_blind % u] * B]
    rands = [[dgk_random_num(int(2.5 * t), rng) for _ in range(B)] for _ in msgs]
    want = [DGK_S * ((x - DGK_XB) ** 2 + (y - DGK_YB) ** 2 + r_blind) % u
            for x, y in zip(xa, ya)]
    return {"msgs": msgs, "rands": rands, "want": want}


def giant_step(mc, priv, pub):
    """The BSGS giant step as ``decrypt_batch_device_bsgs`` runs it: a
    function of the lanes z -> z G^-m mod n, one product a lane
    (``mulmod_const``)."""
    import math

    from .ops import dgk_cuda

    m_steps = math.isqrt(pub.u) + 1
    giant = pow(pow(priv.g, priv.vpq, priv.n), -m_steps, priv.n)
    return lambda z: dgk_cuda.mulmod_const(mc, z, giant)


def bsgs_split(db, priv, btab, cts) -> dict:
    """``decrypt_batch_device_bsgs`` on ``cts``: the call by CUDA events
    (median of 3), and one call under the profiler split into the giant
    steps (``dgk_mulmod``), c^vpq (``dgk_powmod_shared``), the table probe
    and select (every other kernel) and the host between launches; the
    first of up to three profiled calls that recorded both DGK kernels (late
    in a long process a window was seen to miss a kernel's events)."""
    from .measure_multiply import profile_phases

    def call():
        return db.decrypt_batch_device_bsgs(priv, btab, cts)

    ms = median_ms(call)
    for _ in range(3):
        prof = profile_phases(call, 1)
        phases = prof["phases"]
        if "dgk_mulmod" in phases and "dgk_powmod_shared" in phases:
            break
    giant, cv = phases.get("dgk_mulmod"), phases.get("dgk_powmod_shared")
    other = [v for k, v in phases.items() if k not in ("dgk_mulmod", "dgk_powmod_shared")]
    return {
        "call_ms": ms, "window_ms": prof["window_ms"], "device_busy_ms": prof["busy_ms"],
        "giant_steps_ms": giant and giant["ms_per_call"],
        "giant_steps": giant["launches_per_call"] if giant else 0,
        "c_vpq_ms": cv and cv["ms_per_call"],
        "probe_select_ms": sum(v["ms_per_call"] for v in other),
        "probe_select_launches": sum(v["launches_per_call"] for v in other),
        "host_ms": prof["window_ms"] - prof["busy_ms"],
    }


def bsgs_text(split: dict) -> str:
    """``bsgs_split``'s numbers as one line (None: the profiler recorded no
    such kernel in its windows)."""
    def ms(v):
        return "not recorded by the profiler" if v is None else f"{v:.4f} ms"

    return (f"{split['call_ms']:.4f} ms a call (CUDA events, median); one call under the "
            f"profiler, a {split['window_ms']:.4f} ms window: giant steps "
            f"{ms(split['giant_steps_ms'])} ({split['giant_steps']} launches), c^vpq "
            f"{ms(split['c_vpq_ms'])}, table probe and select "
            f"{ms(split['probe_select_ms'])} ({split['probe_select_launches']} launches), "
            f"host between launches {ms(split['host_ms'])}")


def kernel_ms(fn, name: str, calls: int = 2) -> float:
    """Device ms a launch of kernel ``name`` in ``fn`` (torch.profiler); the
    CUDA-event window a call where the profiler recorded none."""
    from .measure_multiply import profile_phases

    for _ in range(3):
        phases = profile_phases(fn, calls)["phases"]
        if name in phases:
            p = phases[name]
            return p["ms_per_call"] / p["launches_per_call"]
    return window_ms(fn, calls)


def median_ms(fn, windows: int = 3, iters: int = 1) -> float:
    """Median over ``windows`` CUDA-event windows of ``iters`` calls each."""
    fn()
    return statistics.median(window_ms(fn, iters) for _ in range(windows))


def mad_probe(dev) -> dict:
    """Rates of the two multiply-add forms and the slots one takes."""
    from .ops import mulmod_chain

    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    mads = blocks * mulmod_chain.MAD_THREADS * mulmod_chain.MAD_CHAINS * MAD_STEPS
    out = {}
    for form, wide in (("IMAD.WIDE.U32", True), ("IMAD + IMAD.HI", False)):
        ms = median_ms(lambda: mulmod_chain.mad_probe(dev, wide, MAD_STEPS, blocks), 5, 3)
        for _ in range(400):  # ~0.6-0.8 s of queued probes: read the clock under load
            mulmod_chain.mad_probe(dev, wide, MAD_STEPS, blocks)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
        rate = mads / (ms / 1e3)
        out[form] = {"ms": ms, "mads_per_s": rate, "slots": MULS_PER_S / rate, "clock": clock}
        print(f"[probe] {form}: {mads} multiply-adds in {ms:.4f} ms = {rate:.4e}/s, "
              f"{MULS_PER_S / rate:.3f} slots of MULS_PER_S ({MULS_PER_S:.4e}/s) each; SM "
              f"clock under the probe {clock}", flush=True)
    return out


def sass_report() -> dict:
    """SASS instructions of one limb product in each form (row probe), and
    per DGK kernel of the built library; ptxas's report of dgk_mont.cu."""
    from .measure_multiply import sass_counts
    from .ops import cuda_build, dgk_cuda

    nvcc = cuda_build.find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = {"row": {}, "kernels": {}}
    L = dgk_cuda.group(65)[1]
    for k, (form, row) in enumerate(_ROWS.items()):
        src = cuda_build.BUILD_DIR / f"dgk_row_probe_{k}.cu"
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(_ROW_PROBE.format(row=row, L=L))
        cubin = src.with_suffix(".cubin")
        subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-cubin", "-I",
                        str(cuda_build.CSRC), "-o", str(cubin), str(src)], check=True)
        sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True, text=True,
                              check=True).stdout
        counts, ops = {}, {}
        for part in sass.split("Function : ")[1:]:
            r = 2 if "Li2E" in part.splitlines()[0] else 1
            code = [ln.split("*/", 1)[1].strip() for ln in part.splitlines()
                    if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln)]
            counts[r] = len(code)
            ops[r] = {}
            for ln in code:
                op = ln.split()[0] if not ln.startswith("@") else ln.split()[1]
                ops[r][op] = ops[r].get(op, 0) + 1
        per = (counts[2] - counts[1]) / L
        diff = {op: ops[2].get(op, 0) - ops[1].get(op, 0) for op in set(ops[2]) | set(ops[1])}
        out["row"][form] = {"L": L, "row1": counts[1], "row2": counts[2],
                            "per_limb_product": per,
                            "row_opcodes": {k: v for k, v in sorted(diff.items()) if v}}
        print(f"[sass] mad_row<{L}> as {form}: {counts[1]} instructions once, {counts[2]} "
              f"twice: {per:.2f} a 32 x 32-bit limb product; the row's opcodes "
              f"{out['row'][form]['row_opcodes']}", flush=True)
    from .ops import mulmod_chain

    with tempfile.TemporaryDirectory() as tmp:  # a build of its own, for ptxas's report
        lib = cuda_build.build([dgk_cuda.SOURCE], tmp)[dgk_cuda.SOURCE]
        for name, c in sass_counts(lib).items():
            if "dgk_" in name:
                out["kernels"][name] = c
                print(f"[sass] {name}: {c}", flush=True)
    chain = cuda_build.build([mulmod_chain.SOURCE])[mulmod_chain.SOURCE]
    for name, c in sass_counts(chain).items():  # the probe's two forms
        if "mad_probe" in name:
            out["kernels"][name] = c
            print(f"[sass] {name}: {c}", flush=True)
    log = cuda_build.build_info.get(dgk_cuda.SOURCE.name, {}).get("log", "")
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if re.search(r"registers|stack frame|spill|Compiling entry", ln)]
    for ln in out["ptxas"]:
        print(f"[ptxas] {ln}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)),
                    help="comma-separated B (default %(default)s)")
    ap.add_argument("--parts", default="probe,kernels,calls,bsgs",
                    help=f"comma-separated, of {','.join(PARTS)} (default %(default)s)")
    ap.add_argument("--keys", default=",".join(map(str, DGK_KEYS)),
                    help="k,t,l of the keys (default %(default)s)")
    ap.add_argument("--json", default=None, help="write every number here")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"unknown parts {sorted(parts - set(PARTS))}")
    if not torch.cuda.is_available():
        print("measure_dgk: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1

    from .dgk import dgk_gen_keys
    from .dgk.batched import DGKBatch
    from .dgk.modexp import to_digits
    from .ops import dgk_cuda

    dev = cuda_device(0)
    card = smi_line()
    batches = sorted(int(b) for b in args.batches.split(","))
    keys = tuple(int(v) for v in args.keys.split(","))
    k, t, l = keys
    priv, pub = dgk_gen_keys(k, t, l, seed=DGK_SEED)
    db = DGKBatch.build(pub, device=dev)
    mc = db.mc
    W = dgk_cuda.limbs(mc)
    result = {"card": card, "keys": keys, "W": W, "mad_slots": MAD_SLOTS, "batches": {}}
    print(f"[dgk] keys {keys} seed {DGK_SEED}: n of {pub.n.bit_length()} bits, W = {W} "
          f"[{card}]", flush=True)
    if "sass" in parts:
        result["sass"] = sass_report()
    probe_slots = None
    if "probe" in parts:
        result["probe"] = mad_probe(dev)
        probe_slots = result["probe"]["IMAD.WIDE.U32"]["slots"]
    top = max(batches + ([MAIN_B] if "calls" in parts else [])
              + ([BSGS_B] if "bsgs" in parts else []))
    inp = comparison_inputs(pub, t, l, top)
    msgs, rands = inp["msgs"], inp["rands"]
    g, h = to_digits([pub.g], mc.D, dev), to_digits([pub.h], mc.D, dev)
    cts_all = [db.encrypt_batch(m, r) for m, r in zip(msgs, rands)]
    giant = giant_step(mc, priv, pub)
    torch.cuda.synchronize()
    for B in batches if "kernels" in parts else ():
        cts = [c[:B] for c in cts_all]
        out = db.blind_distance_batch(*cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:])
        gm, hr = dgk_cuda.powmod(mc, g, msgs[0][:B]), dgk_cuda.powmod(mc, h, rands[0][:B])
        bounds = kernel_bounds(W, mc.D, B, priv.vpq)
        kernels = {
            "dgk_powmod_lanes h^r": ("dgk_powmod_lanes", lambda: dgk_cuda.powmod(
                mc, h, rands[0][:B]), lanes_bound(W, rands[0][:B])),
            "dgk_powmod_lanes g^m": ("dgk_powmod_lanes", lambda: dgk_cuda.powmod(
                mc, g, msgs[0][:B]), lanes_bound(W, msgs[0][:B])),
            "dgk_mulmod": ("dgk_mulmod", lambda: dgk_cuda.mulmod(mc, gm, hr),
                           bounds["dgk_mulmod"]),
            "dgk_powmod_shared c^vpq": ("dgk_powmod_shared", lambda: dgk_cuda.powmod_shared_exp(
                mc, out, priv.vpq), bounds["dgk_powmod_shared"]),
            "dgk_blind_distance": ("dgk_blind_distance", lambda: dgk_cuda.blind_distance(
                mc, *cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:]), bounds["dgk_blind_distance"]),
            "dgk_mulmod giant step": ("dgk_mulmod", lambda: giant(out), bounds["giant step"]),
        }
        rows = {}
        for key, (name, fn, c) in kernels.items():
            ms = kernel_ms(fn, name)
            rows[key] = {"ms": ms, **c, "share": c["bound_ms"] / ms,
                         "reference_share": c["reference_bound_ms"] / ms}
            at_probe = ""
            if probe_slots:  # the same count at the rate the probe reached
                rows[key]["share_at_probe"] = c["bound_ms"] * probe_slots / MAD_SLOTS / ms
                at_probe = (f"; {100 * rows[key]['share_at_probe']:.1f}% at the probe's "
                            f"{probe_slots:.3f} slots")
            print(f"[dgk] B = {B} {key}: {ms:.4f} ms a launch (profiler); {c['products']} "
                  f"products needed ({c['products'] / B:.1f} a lane); bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {MAD_SLOTS} slots a "
                  f"multiply-add), {100 * rows[key]['share']:.1f}% of it{at_probe}; "
                  f"{100 * rows[key]['reference_share']:.1f}% of the older count's "
                  f"{c['reference_products'] / B:.1f} a lane [{card}]", flush=True)
        result["batches"][B] = rows
    if "calls" in parts:
        B = MAIN_B
        cts = [c[:B] for c in cts_all]
        m0, r0 = msgs[0][:B], rands[0][:B]
        dtab = db.build_device_table(priv)
        out = db.blind_distance_batch(*cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:])
        want = inp["want"][:B]
        if db.decrypt_batch_device(priv, dtab, out).tolist() != want:
            print("measure_dgk: a blind distance decrypts to another value", file=sys.stderr)
            return 1

        def comparisons():
            c = [db.encrypt_batch(m[:B], r[:B]) for m, r in zip(msgs, rands)]
            o = db.blind_distance_batch(*c[:3], DGK_XB, DGK_YB, DGK_S, *c[3:])
            return db.decrypt_batch_device(priv, dtab, o)

        calls = {
            "encrypt_batch": median_ms(lambda: db.encrypt_batch(m0, r0)),
            "blind_distance_batch": median_ms(lambda: db.blind_distance_batch(
                *cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:]), 5, 3),
            "decrypt_batch_device": median_ms(lambda: db.decrypt_batch_device(priv, dtab, out)),
            "full": median_ms(comparisons),
        }
        for name, ms in calls.items():
            print(f"[dgk] B = {B} {name}: {ms:.4f} ms a call (CUDA events, median) [{card}]",
                  flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        comparisons()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        from .measure_multiply import profile_phases

        prof = profile_phases(lambda: db.encrypt_batch(m0, r0), 2)
        dgk_ms = sum(p["ms_per_call"] for name, p in prof["phases"].items()
                     if name.startswith("dgk_"))
        split = {"window_ms": prof["window_ms"] / 2, "dgk_kernels_ms": dgk_ms,
                 "device_busy_ms": prof["busy_ms"] / 2,
                 "rest_ms": prof["window_ms"] / 2 - prof["busy_ms"] / 2}
        t0 = time.perf_counter()
        db.encrypt_batch(m0, r0)
        split["host_return_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        rates = {"eval_only": B / (calls["blind_distance_batch"] / 1e3),
                 "full": B / (calls["full"] / 1e3)}
        result.update({"calls": calls, "rates": rates, "peak_bytes": peak,
                       "encrypt_split": split})
        print(f"[dgk] encrypt_batch at B = {B} under the profiler: window "
              f"{split['window_ms']:.4f} ms a call, DGK kernels {dgk_ms:.4f} ms, all device "
              f"work {split['device_busy_ms']:.4f} ms, rest (host between launches) "
              f"{split['rest_ms']:.4f} ms ({100 * split['rest_ms'] / split['window_ms']:.1f}%); "
              f"the call returns to the host after {split['host_return_ms']:.4f} ms [{card}]",
              flush=True)
        print(f"[dgk] comparisons/s at B = {B}: eval-only {rates['eval_only']:.1f}, full "
              f"{rates['full']:.1f}; peak device memory of a full comparison {peak} B "
              f"[{card}]", flush=True)
    if "bsgs" in parts:
        B = BSGS_B
        out = db.blind_distance_batch(*[c[:B] for c in cts_all[:3]], DGK_XB, DGK_YB, DGK_S,
                                      *[c[:B] for c in cts_all[3:]])
        btab = db.build_bsgs_table(priv)
        if db.decrypt_batch_device_bsgs(priv, btab, out).tolist() != inp["want"][:B]:
            print("measure_dgk: a BSGS decrypt differs from s(d^2 + r)", file=sys.stderr)
            return 1
        split = bsgs_split(db, priv, btab, out)
        result["bsgs"] = split
        print(f"[dgk] BSGS decrypt at B = {B}: {bsgs_text(split)} [{card}]", flush=True)
    print(f"[dgk] card: {card}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
