"""Command line of the port: the local demo (the reference's ``./pplp``).

    python -m pplp_tpu_torch.cli demo [--profile seal|tpu] [--device cuda] [...]

Flags keep the reference's names, defaults and range checks
(``pplp_tpu.cli``), with one addition: ``--device``, the torch device the
demo runs on (``cuda`` by default; ``cpu`` runs the plain PyTorch versions).
The default profile is ``seal``, the SEAL-4.1-style chain (m62 arithmetic,
the u64 NTT kernel on a card); ``tpu`` runs primes below 2^30. The client,
server, tc, ts and 2pc subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

COORD_MAX = 1 << 27


def _ranged(lo, hi, cast=int):
    def check(s):
        v = cast(s)
        if not (lo <= v <= hi):
            raise argparse.ArgumentTypeError(f"value {v} out of range [{lo}, {hi}]")
        return v

    return check


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pplp_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("demo", help="local both-roles proximity run (./pplp)")
    d.add_argument("--xa", "-x", type=_ranged(0, COORD_MAX), default=1234)
    d.add_argument("--ya", "-y", type=_ranged(0, COORD_MAX), default=1212)
    d.add_argument("--xb", "-u", type=_ranged(0, COORD_MAX), default=1000)
    d.add_argument("--yb", "-v", type=_ranged(0, COORD_MAX), default=1000)
    d.add_argument("--radius", "-r", type=_ranged(1, 8192), default=128)
    d.add_argument("--print_bf", "-g", type=int, default=0)
    d.add_argument("--seed", type=int, default=None)
    d.add_argument("--plain_modulus_bits", "-b", type=_ranged(1, 56), default=56,
                   help="bit length of plain modulus")
    d.add_argument("--poly_modulus_degree", "-d", type=_ranged(12, 15), default=13,
                   help="set degree of polynomial(2^d)")
    d.add_argument("--profile", choices=["seal", "tpu"], default="seal",
                   help="coeff-modulus chain profile")
    d.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    return ap


def demo_main(args) -> int:
    from .protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(
        xa=args.xa,
        ya=args.ya,
        xb=args.xb,
        yb=args.yb,
        radius=args.radius,
        plain_modulus_bits=args.plain_modulus_bits,
        poly_modulus_degree_bits=args.poly_modulus_degree,
        profile=args.profile,
        seed=args.seed,
    )
    res = run_local_demo(cfg, print_bf=bool(args.print_bf), device=args.device)
    return 0 if res is not None else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "demo":
        return demo_main(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
