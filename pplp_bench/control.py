"""The control of a cell's check: the reference, weakened, in the program's place.

    python3 pplp_bench/control.py --workload <name> --seeds 1 2 3 [--units N]

For each seed it takes the tests or steps a run of ``N`` units would keep,
lets the plain reference compute them with the filter at the square root
of the configuration's false-positive rate (``reference.proximity.fpp_of``)
and compares them with the unweakened reference as a run compares the
program's outputs. Every line it prints is one seed's readings beside their
limits; a sound check reads not correct on every seed. It runs on the
card when there is one, else on the CPU, and never runs the program.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)


def readings(root: Path, workload: str, seed: int, units: int, device) -> dict:
    """{check: (value, limit)} of the control on ``units`` units of one seed."""
    import torch

    from pplp_bench import harness

    cell = harness.resolve(root, workload)
    device = torch.device(device)
    session = harness.Session(cell, seed, 0.0, device, harness.Spans(device))
    record = cell.entry.blank_record(session, units)
    return cell.entry.check(session, record, control="weak_filter")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=int, nargs="+")
    ap.add_argument("--units", type=int, default=100)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        got = readings(ROOT, args.workload, seed, args.units, device)
        correct = all(v <= lim for v, lim in got.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "units": args.units,
                          "device": device, "correct": correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
