"""Time the NTT kernels on one CUDA card.

    python3 -m pplp_tpu_torch.measure_ntt [--json PATH] [--sass]

Forward and inverse, through ``ops/ntt_cuda.forward`` / ``inverse``, on the
u64 kernels (seal chains, m62) and the int64-I/O u32 kernels (tpu chains,
m31), at ``chip_smoke.py``'s kernel shapes (64 rows per limb at
n = 4096 .. 32768) and at the three shapes the demo transforms (1, 3 and 6
polynomials at n = 8192). Random canonical residues from a seeded
``torch.Generator``; a round trip must give the input back. Every variant is
warmed once, then timed once per round as the mean of a CUDA-event window of
back-to-back calls; the rounds run the variants in order and reversed,
alternately (``measure_multiply.rounds_ms``). Reported per variant: the
median over the rounds with min and max, the device time per call under
``torch.profiler`` (``device_ms``: all kernels of the call; at the demo's
shapes a call is shorter than its host launch path, so the window reads the
launch rate and only the profiler reads the kernel), and the bound
(``measure_multiply.transform_counts``) with its side.

The script uses nothing that an earlier tree of the port lacks, so that a
copy of it runs unchanged inside a ``git archive`` of the parent commit: run
parent, change, change, parent in one run on one card to compare two designs.

``--sass`` counts the 32-bit multiply instructions of one u64 Shoup product
(``measure_multiply.U64_PRODUCT_MULS``): it compiles a probe kernel that
chains one and two ``shoup_lazy64`` products and prints the multiply lines
of both from ``cuobjdump -sass`` and the difference of their counts.

Prints one line per measurement and the card's name and power limit, and
writes every number as JSON to ``--json`` if given. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from .device import cuda_device, smi_line, window_ms
from .measure_multiply import rounds_ms, transform_counts

# (profile, n, batch): chip_smoke.KERNEL_SHAPES at 64 rows per limb, then the
# demo's transforms (decrypt; encrypt and plaintext spectra; the blind
# distance's stack) at its n = 8192.
SHAPES = tuple((prof, n, (64,)) for prof in ("seal", "tpu")
               for n in (4096, 8192, 16384, 32768)) + tuple(
    (prof, 8192, batch) for prof in ("seal", "tpu") for batch in ((), (3,), (6,)))
ROUNDS = 5
ITERS = 20
PROFILE_CALLS = 10
SEED = 62
_PROBE = """
#include "ntt_block64.cuh"
template <int N>
__global__ void probe(const uint64_t* in, uint64_t* out) {
  uint64_t x = in[threadIdx.x];
  const uint64_t w = in[32], ws = in[33], q = in[34];
#pragma unroll
  for (int i = 0; i < N; ++i) x = pplp::shoup_lazy64(x, w, ws, q);
  out[threadIdx.x] = x;
}
template __global__ void probe<1>(const uint64_t*, uint64_t*);
template __global__ void probe<2>(const uint64_t*, uint64_t*);
"""
# SASS multiplies: IMAD / IMUL forms, but for the moves, shifts and adds that
# the compiler writes as IMAD with a unit operand.
_MUL = re.compile(r"\b(IMAD|IMUL)(?!\.(MOV|SHL|IADD|X\b))[.\w]*\s")


def device_ms(fn, calls: int = PROFILE_CALLS) -> float:
    """Device milliseconds of one call of ``fn`` under ``torch.profiler``:
    per kernel name, the mean duration of its recorded events times its
    launches per call, summed over the names. The launches per call are the
    events over ``calls`` rounded up: late in a long process a sum over a
    window of 20 launches was seen to read a 0.54 ms kernel as 0.37 ms, as
    if events were missing, and a mean over the events seen does not. A
    window with no device event at all (seen once) is taken again; after
    three, the CUDA-event window per call stands in, which also holds the
    host's launch path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if us:
            return sum(statistics.mean(v) * -(-len(v) // calls) for v in us.values()) / 1e3
    return window_ms(fn, calls)


def _bound(rows: int, n: int, inverse: bool, u64: bool):
    """The transform's bound, at the u64 rate where this tree states one."""
    if "u64" in inspect.signature(transform_counts).parameters:
        return transform_counts(rows, n, inverse, 8, 8, u64=u64)
    return None if u64 else transform_counts(rows, n, inverse, 8, 8)


def sass_multiplies() -> dict:
    """Multiply instructions of the probe with one and with two chained u64
    Shoup products; their difference is one product's."""
    from .ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "shoup64_probe.cu"
    src.write_text(_PROBE)
    nvcc = cuda_build.find_nvcc()
    cubin = src.with_suffix(".cubin")
    subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-cubin", "-I",
                    str(cuda_build.CSRC), "-o", str(cubin), str(src)], check=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        steps = 2 if "Li2E" in part.splitlines()[0] else 1
        lines = [ln.strip() for ln in part.splitlines() if _MUL.search(ln)]
        counts[steps] = len(lines)
        for ln in lines:
            print(f"[sass] probe<{steps}>: {ln}", flush=True)
    per_product = counts[2] - counts[1]
    print(f"[sass] multiply instructions: probe<1> {counts[1]}, probe<2> {counts[2]}; one "
          f"u64 Shoup product = {per_product}", flush=True)
    return {"probe1": counts[1], "probe2": counts[2], "per_product": per_product}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write every number here")
    ap.add_argument("--sass", action="store_true",
                    help="count the multiply instructions of a u64 Shoup product")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_ntt: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1

    from .ops import ntt, ntt_cuda
    from .ops.primes import Modulus, bfv_default, tpu_default

    dev = cuda_device(0)
    card = smi_line()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    result = {"card": card, "rounds": ROUNDS, "iters": ITERS, "transforms": {}}
    if args.sass:
        result["sass"] = sass_multiplies()
    variants, meta, tables = {}, {}, {}
    for prof, n, batch in SHAPES:
        if (prof, n) not in tables:
            chain = (bfv_default if prof == "seal" else tpu_default)(n)
            tables[prof, n] = ntt.build_tables([Modulus(q) for q in chain], n, dev)
        tb = tables[prof, n]
        x = torch.randint(0, 1 << 62, batch + (tb.L, n), generator=gen, device=dev,
                          dtype=torch.int64) % tb.q_b(1)
        spec = ntt_cuda.forward(x, tb)
        if not torch.equal(ntt_cuda.inverse(spec, tb), x):
            print(f"measure_ntt: {prof} {tuple(x.shape)} round trip is not the identity",
                  file=sys.stderr)
            return 1
        for name, fn in (("forward", lambda x=x, tb=tb: ntt_cuda.forward(x, tb)),
                         ("inverse", lambda s=spec, tb=tb: ntt_cuda.inverse(s, tb))):
            key = f"{prof} {list(x.shape)} {name}"
            variants[key] = (fn, ITERS)
            meta[key] = (x.numel() // n, n, name == "inverse", tb.profile == "m62")
    times = rounds_ms(variants, ROUNDS)
    for key, (fn, _) in variants.items():
        s = times[key]
        s["device_ms"] = device_ms(fn)
        c = _bound(*meta[key])
        extra = ""
        if c is not None:
            s.update(bound_ms=c["bound_ms"], bound_by=c["bound_by"], bytes=c["bytes"],
                     mulmods=c["mulmods"])
            extra = (f"; bound {c['bound_ms']:.4f} ms ({c['bound_by']}), "
                     f"{100 * c['bound_ms'] / s['device_ms']:.1f}% of bound")
        result["transforms"][key] = s
        print(f"[ntt] {key}: median {s['median_ms']:.4f} ms [{s['min_ms']:.4f}-"
              f"{s['max_ms']:.4f}] over {s['rounds']} rounds of {ITERS} calls; device "
              f"{s['device_ms']:.4f} ms per call{extra}", flush=True)
    print(card, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
