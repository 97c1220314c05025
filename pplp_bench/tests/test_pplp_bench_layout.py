"""The benchmark's files: BENCHMARK.json's contract, cells added as files,
and what a run may import."""

from __future__ import annotations

import ast
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pplp_bench import harness
from pplp_bench.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["pplp_bench"]
    assert BENCH["command"][1].startswith("pplp_bench/") and len(BENCH["command"]) <= 32
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s
    # a cell to compile, 1200 s spare, in 43200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("pplp_bench/configs/") and (REPO / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and c["reduced"] == []
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (REPO / "pplp_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c for c, _ in pairs} == configs


def test_metrics_of_every_cell():
    cells = [w["name"] for w in BENCH["workloads"]]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"} and UNIT.match(m["unit"])
        assert m["better"] in {"lower", "higher"} and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and m["better"] in {"lower",
                                                                                   "higher"}
        assert (REPO / "pplp_bench" / "layer_metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        c = harness.resolve(REPO, cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        assert all(m["moves"] in e2e for m in c.per_layer)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "pplp_bench").rglob("*")) if p.is_file()}


def test_cell_added_as_files_needs_no_edit(tmp_path):
    """A configuration, a mix and a per-layer metric added as new files
    (and entries in BENCHMARK.json) run without an edit to a file there."""
    root = tiny.tree(tmp_path)
    before = _digest(root)
    pkg = root / "pplp_bench"
    tiny.write(pkg / "configs" / "demo-tiny-b.json", dict(tiny.DEMO_CONFIG,
                                                          plain_modulus_bits=36))
    tiny.write(pkg / "traffic" / "tiny-demo-far.json", dict(tiny.DEMO_MIX, near_share=0.25))
    (pkg / "layer_metrics" / "demo.kgen_ms.py").write_text(
        "def read(view):\n"
        "    _, spans = view.window.steady()\n"
        "    return 1e3 * sum(s['kGen'] for s in spans) / len(spans) if spans else None\n")
    tiny.add_cell(root, "demo-tiny-b", "demo-tiny-b", "tiny-demo-far", like="demo-tiny")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "demo.kgen_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "BFV stages",
                               "moves": "tests_per_s", "workloads": ["demo-tiny-b"]})
    tiny.write(root / "BENCHMARK.json", bench)
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    out = harness.run_cell(root, "demo-tiny-b", 5, 2.0, True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["demo.kgen_ms"]["value"] > 0


def test_per_layer_metric_must_list_its_workloads(tmp_path):
    root = tiny.tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    tiny.write(root / "BENCHMARK.json", bench)
    with pytest.raises(KeyError, match="lists no workloads"):
        harness.resolve(root, "demo-tiny")


def _top_level_modules_after(code: str, cwd: Path) -> set[str]:
    done = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in "
         "sys.modules}))"], cwd=cwd, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return set(eval(done.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = tiny.tree(tmp_path)
    code = (f"import sys, time; sys.path[:0] = [{str(REPO)!r}]\n"
            "from pathlib import Path\nfrom pplp_bench import harness, run\n"
            "for cell in ('demo-tiny', 'pipe-tiny'):\n"
            f"    out = harness.run_cell(Path({str(root)!r}), cell, 9, 1.0, True, 'cpu', "
            "time.perf_counter())\n"
            "    assert out['correct'], out['checks']\n"
            "assert run.forbidden_modules() == []")
    loaded = _top_level_modules_after(code, tmp_path)
    assert "pplp_tpu_torch" in loaded and "pplp_bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "pplp_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from pplp_bench import run

    monkeypatch.setitem(sys.modules, "pplp_tpu_torch_like", sys)
    assert "pplp_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pplp_tpu.bfv", sys)
    assert "pplp_tpu.bfv" in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "pplp_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(n.split(".")[0] in {"pplp_tpu_torch", "pplp_tpu", "jax"}
                           for n in names), (path.name, names)
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}]\n"
            "from pplp_bench.reference import proximity as ref\n"
            "bf = ref.server_filter(8, 5, 8, 3, 1 << 20, 1e-4, 7, True, 'cpu')\n"
            "assert bf.probe(*ref.key_words(__import__('torch').tensor([45]), 3))[0].all()")
    loaded = _top_level_modules_after(code, REPO)
    assert not loaded & {"pplp_tpu_torch", "pplp_tpu", "jax", "pplp_bench.entries"}


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    done = subprocess.run([sys.executable, "pplp_bench/run.py", "--workload", "demo-seal-r4096",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the program is missing and a run fails."""
    root = tiny.tree(tmp_path)
    code = ("import sys, time; sys.path[:0] = ['.']\nfrom pathlib import Path\n"
            "from pplp_bench import harness\n"
            "harness.run_cell(Path('.'), 'demo-tiny', 1, 1.0, False, 'cpu', time.perf_counter())")
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and "pplp_tpu_torch" in done.stderr
