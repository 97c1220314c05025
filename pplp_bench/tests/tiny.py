"""A copy of the benchmark with tiny cells added as new files, for CPU tests.

``tree(tmp)`` copies ``BENCHMARK.json`` and ``pplp_bench/`` into ``tmp``,
then adds the configurations ``demo-tiny`` (seal, n = 4096, t = 2^40) and
``pipe-tiny`` (tpu, n = 4096), the mixes ``tiny-demo`` (r = 16),
``tiny-pipe`` (one row, two batches) and ``tiny-pipe-2`` (two rows) and
their cells (both pipeline cells report what ``pipe-r99-1m`` does), editing
no file that was there but ``BENCHMARK.json``'s lists.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2**33 + 7  # more than 32 signed bits hold

DEMO_CONFIG = {"entry": "demo", "profile": "seal", "poly_modulus_degree_bits": 12,
               "plain_modulus_bits": 40, "false_positive_probability": 1e-12,
               "bf_seed": 0xA5A5A5A5, "bf_index_mode": "mixed", "chips": 1, "reduced": []}
PIPE_CONFIG = {"entry": "packed_pipeline", "profile": "tpu", "poly_modulus_degree_bits": 12,
               "plain_modulus_bits": 20, "limbs": 4, "xb": 1000, "yb": 900, "s": 501,
               "w": 0xA5A5, "false_positive_probability": 1e-4, "bf_seed": 0xA5A5A5A5,
               "bf_index_mode": "mixed", "chips": 1, "reduced": []}
DEMO_MIX = {"radius": 16, "near_share": 0.5, "far_radius_factor": 4, "coordinate_span": 4096,
            "wire_check_every": 2, "trace_skip": 1, "trace_units": 1}
PIPE_MIX = {"radius": 99, "near_share": 0.5, "far_radius_factor": 4, "rows": 1, "batches": 2,
            "verdict_check_every": 1, "trace_skip": 2, "trace_units": 2}


def write(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def add_cell(root: Path, cell: str, config: str, mix: str, like: str):
    """List ``cell`` (``config`` under ``mix``) in ``root``'s BENCHMARK.json
    with every metric that the cell ``like`` reports."""
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": config, "source": "a tiny copy for CPU tests",
                                 "file": f"pplp_bench/configs/{config}.json", "reduced": [],
                                 "why": "CPU tests"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    write(path, bench)


def tree(tmp: Path) -> Path:
    root = Path(tmp) / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "pplp_bench", root / "pplp_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    pkg = root / "pplp_bench"
    write(pkg / "configs" / "demo-tiny.json", DEMO_CONFIG)
    write(pkg / "configs" / "pipe-tiny.json", PIPE_CONFIG)
    write(pkg / "traffic" / "tiny-demo.json", DEMO_MIX)
    write(pkg / "traffic" / "tiny-pipe.json", PIPE_MIX)
    write(pkg / "traffic" / "tiny-pipe-2.json", dict(PIPE_MIX, rows=2))
    add_cell(root, "demo-tiny", "demo-tiny", "tiny-demo", like="demo-seal-r4096")
    add_cell(root, "pipe-tiny", "pipe-tiny", "tiny-pipe", like="pipe-r99-1m")
    add_cell(root, "pipe-tiny-dev", "pipe-tiny", "tiny-pipe-2", like="pipe-r99-1m")
    return root
