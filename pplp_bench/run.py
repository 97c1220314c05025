"""Run one cell of the benchmark once on the card and print its result.

    python3 pplp_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m pplp_bench.run`` is the same.) The last line of standard
output is the result as one JSON object; the numbers compared with the
plain reference, each beside its limit, are the last lines of standard
error and the result's last key. Exits non-zero, printing no result, when
there is no CUDA device or fewer than the cell asks for, and when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache at a fixed place inside the checkout. The
# program builds its own kernels into its package's ``_build``.
CACHE = HERE / "_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# Python's bytecode too. Where PYTHONDONTWRITEBYTECODE is set, as on the
# card's machine, every run would compile torch's modules from source again
# (about 6 s of set-up); the cache keeps their bytecode inside the checkout.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CACHE / "pyc")

FORBIDDEN = ("jax", "jaxlib", "flax", "pplp_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def toolchain(device) -> dict:
    """The toolchain and the card, as an earlier line of the output."""
    import subprocess

    import torch
    from torch.utils import cpp_extension

    triton = None
    if importlib.util.find_spec("triton") is not None:
        from importlib.metadata import version

        triton = version("triton")
    nvcc = None
    for base in (os.environ.get("CUDA_HOME"), cpp_extension.CUDA_HOME):
        if base and os.access(os.path.join(base, "bin", "nvcc"), os.X_OK):
            nvcc = os.path.join(base, "bin", "nvcc")
            break
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "unavailable"
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "triton": triton,
            "nvcc": nvcc, "nvidia_smi": smi, "card": torch.cuda.get_device_name(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    imported = time.perf_counter()
    from pplp_bench import harness, yardstick

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    marks = {"torch_imported": imported - STARTED, "cuda_ready": time.perf_counter() - STARTED}
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, STARTED)
    print("toolchain: " + json.dumps(toolchain(device)), flush=True)
    print("roofline basis: " + yardstick.BASIS, flush=True)
    print("setup split (s): " + json.dumps(dict(marks, **out["setup_split"])), flush=True)
    print("diagnostics: " + json.dumps(out["diagnostics"]), flush=True)
    for err in out["errors"]:
        print(err, file=sys.stderr)
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                         "count": chips, "memory_peak_bytes": out["peak"]}}
    if args.trace:
        stretch = out["stretch"]
        result["device"]["busy_s"] = stretch.busy_s if stretch else 0.0
        result["device"]["window_s"] = stretch.window_s if stretch else 0.0
        if stretch:
            result["breakdown"] = stretch.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
