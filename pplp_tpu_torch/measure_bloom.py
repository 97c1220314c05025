"""The Bloom filter's device paths on the card: the demo's stages and the
kernels' bounds.

    python3 -m pplp_tpu_torch.measure_bloom [--radii 4096,8192] [--repeats 3] [--json PATH]

Runs the local demo (``run_local_demo``: seal, -d 13 -b 56, the near pair
(1234, 1212) / (1000, 1000), seed 7, the CLI's defaults otherwise) once at
r = 128 to build the kernels, then ``repeats`` times at each radius, and
prints each run's stages (host clock, each ending in a synchronize;
``setBF`` builds the server's filter, ``dec`` serializes it, deserializes
it on the client and probes), its wall time, the verdict and its peak
device memory, with the card's name and power limit. It uses only ``run_local_demo`` and ``device``, so a copy of this
file runs unchanged in a tree from before the Bloom kernels: run parent,
change, change, parent in one call to compare them.

``insert_bound`` and ``probe_bound`` are the bounds ``chip_smoke.py`` puts
beside the kernels' times: the larger of the bytes the function must move
(each input read once, each output written once) over ``BYTES_PER_S`` and
the 32-bit multiplies of its indices (one in the AP hash, two in fmix32,
two a reduction by a size) over ``MULS_PER_S``. ``sector_ms`` is the model
for a table larger than the 50 MB L2, where each bit set reads and writes
one random 32-byte sector and each probed bit reads one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .measure_multiply import BYTES_PER_S, MULS_PER_S

__all__ = ["insert_bound", "probe_bound", "demo_runs", "main"]

SECTOR = 32  # bytes


def _bound(nbytes: int, indices: int, mixed: bool, n_sizes: int, sector_bytes: int) -> dict:
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = indices * (1 + 2 * int(mixed) + 2 * n_sizes) / MULS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "sector_ms": sector_bytes / BYTES_PER_S * 1e3}


def insert_bound(keys: int, salts: int, table_bits: int, mixed: bool, n_sizes: int = 1,
                 key_bytes: int = 16) -> dict:
    """An insert of ``keys`` keys (``key_bytes`` read a key: 16 for int64
    (lo, hi) words, 0 for keys the kernel makes) into a table of
    ``table_bits`` bits, read and written once."""
    table = 4 * ((table_bits + 31) // 32)
    return _bound(2 * table + keys * key_bytes + 8 * salts, keys * salts, mixed, n_sizes,
                  2 * SECTOR * keys * salts)


def probe_bound(keys: int, tested: int, salts: int, table_bits: int, mixed: bool,
                n_sizes: int = 1, key_bytes: int = 16) -> dict:
    """A probe of ``keys`` keys that tests ``tested`` (key, salt) bits in all
    (it stops at a key's first clear bit): the keys, the table and the
    salts read once, a bool written a key."""
    table = 4 * ((table_bits + 31) // 32)
    return _bound(keys * (key_bytes + 1) + table + 8 * salts, tested, mixed, n_sizes,
                  SECTOR * tested)


def demo_runs(radius: int, repeats: int, dev) -> list[dict]:
    """The seal demo at ``radius``, ``repeats`` times: stages (ms), wall
    time, verdict and peak device memory of each run."""
    import torch

    from .protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(xa=1234, ya=1212, xb=1000, yb=1000, radius=radius,
                         plain_modulus_bits=56, poly_modulus_degree_bits=13, seed=7)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = run_local_demo(cfg, verbose=False, device=dev)
        runs.append({"radius": radius, "near": res.is_near,
                     "stages_ms": {k: v / 1e6 for k, v in res.stage_ns.items()},
                     "wall_s": res.elapsed_s,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        del res
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--radii", default="4096,8192")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from .device import cuda_device, smi_line

    dev = cuda_device(0)
    card = smi_line()
    print(f"measure_bloom: {card}", flush=True)
    out = {"card": card, "runs": []}
    t0 = time.perf_counter()
    demo_runs(128, 1, dev)  # builds and loads the kernels the demo runs
    print(f"warm-up (r = 128): {time.perf_counter() - t0:.1f} s", flush=True)
    for radius in (int(r) for r in args.radii.split(",")):
        t0 = time.perf_counter()
        for run in demo_runs(radius, args.repeats, dev):
            out["runs"].append(run)
            st = run["stages_ms"]
            print(f"demo seal r={radius}: {'near' if run['near'] else 'far'}; setBF "
                  f"{st['setBF']:.1f} ms, dec {st['dec']:.1f} ms; stages "
                  + ", ".join(f"{k} {v:.1f}" for k, v in st.items())
                  + f"; wall {run['wall_s']:.3f} s; peak device memory {run['peak_bytes']} B "
                  f"[{card}]", flush=True)
        print(f"r={radius}: {time.perf_counter() - t0:.1f} s with set-up", flush=True)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
