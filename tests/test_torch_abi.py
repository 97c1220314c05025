"""The ctypes declarations of the kernel wrappers against the C entry points
of ``pplp_tpu_torch/csrc/*.cu``: every declared entry point exists, with as
many arguments, pointers where the C side takes pointers, and every entry
point of the C side is declared. A mismatch would
show only as a failed call on the card; this test needs neither nvcc nor a
card."""

import ctypes
import re

import pytest

from pplp_tpu_torch.ops import (behz64_cuda, behz_cuda, bloom_cuda, dgk_cuda, modmath_cuda,
                                mulmod_chain, ntt_cuda, pipeline_cuda)

_ENTRY = re.compile(r"^[\w \*]*?\b(pplp_\w+)\(([^)]*)\)\s*\{", re.M)


class _Function:
    argtypes = None
    restype = None


class _Library:
    """Records what a wrapper's ``_declare`` sets on each entry point."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        if not name.startswith("pplp_"):
            raise AttributeError(name)
        return self.functions.setdefault(name, _Function())


def _entry_points(source) -> dict:
    """{name: ["p" for a pointer, "i" for an integer, ...]} of the C side."""
    text = source.read_text()
    body = text[text.index('extern "C" {'):]
    return {m.group(1): ["p" if "*" in a else "i" for a in m.group(2).split(",") if a.strip()]
            for m in _ENTRY.finditer(body)}


@pytest.mark.parametrize("wrapper", [ntt_cuda, behz_cuda, behz64_cuda, mulmod_chain, dgk_cuda,
                                     bloom_cuda, pipeline_cuda, modmath_cuda],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_argtypes_match_the_c_entry_points(wrapper):
    lib = _Library()
    wrapper._declare(lib)
    c_side = _entry_points(wrapper.SOURCE)
    assert lib.functions, "the wrapper declares no entry point"
    undeclared = set(c_side) - set(lib.functions) - {"pplp_cuda_error_string"}
    assert not undeclared, f"entry points without argtypes: {sorted(undeclared)}"
    for name, fn in lib.functions.items():
        assert name in c_side, f"{name} is not an entry point of {wrapper.SOURCE.name}"
        kinds = ["p" if t is ctypes.c_void_p else "i" for t in fn.argtypes]
        assert kinds == c_side[name], f"{name}: declared {kinds}, C takes {c_side[name]}"
        assert fn.restype is ctypes.c_int


def test_bloom_entry_points():
    """``csrc/bloom.cu`` exports the direct insert, the sub-slice and the
    partitioned inserts' three steps each, the probe and the probe's
    launch floor (an empty kernel at its geometry), and
    ``bloom_cuda._declare`` declares each: the partitioned count and
    scatter take the chunk's keys and partition (17 arguments) before
    their buffers and stream, the sub-slice count and scatter the chunk's
    keys and buckets (16) before theirs, the sub-slice apply the table,
    its words, the stash, the counts, the buckets and the stream; the
    probe takes 15 arguments, its floor the table's words, the key count
    and the stream."""
    lib = _Library()
    bloom_cuda._declare(lib)
    c_side = _entry_points(bloom_cuda.SOURCE)
    names = {"pplp_bf_insert", "pplp_bf_insert_sub_count", "pplp_bf_insert_sub_scatter",
             "pplp_bf_insert_sub_apply", "pplp_bf_insert_count", "pplp_bf_insert_scatter",
             "pplp_bf_insert_apply", "pplp_bf_probe", "pplp_bf_probe_floor"}
    assert set(c_side) - {"pplp_cuda_error_string"} == names == set(lib.functions)
    steps = [len(c_side[f"pplp_bf_insert_{k}"]) for k in ("count", "scatter", "apply")]
    assert steps == [20, 21, 4]
    sub = [c_side[f"pplp_bf_insert_sub_{k}"] for k in ("count", "scatter", "apply")]
    assert [len(k) for k in sub] == [18, 19, 7]
    assert sub[2] == ["p", "i", "p", "p", "i", "i", "p"]
    assert c_side["pplp_bf_probe_floor"] == ["i", "i", "p"] and len(c_side["pplp_bf_probe"]) == 15


def test_modmath_entry_point_and_op_codes():
    """``csrc/modmath64.cu`` exports one entry point, the op code, the
    output, ``modmath_cuda.MAX_OPERANDS`` operand pointers, the layout and
    the stream; its op codes (``enum Op``) name the kernels in
    ``modmath_cuda.OPS``' order, each op taking as many operands there as
    the wrapper passes, and its limits (operands, dimensions, the 32-bit
    index's numel) are the wrapper's."""
    lib = _Library()
    modmath_cuda._declare(lib)
    c_side = _entry_points(modmath_cuda.SOURCE)
    assert set(c_side) - {"pplp_cuda_error_string"} == {"pplp_m62_elementwise"} == set(
        lib.functions)
    assert c_side["pplp_m62_elementwise"] == ["i"] + ["p"] * (modmath_cuda.MAX_OPERANDS + 3)
    text = modmath_cuda.SOURCE.read_text()
    enum = re.search(r"enum Op \{([^}]*)\}", text).group(1)
    codes = [c.strip() for c in enum.split(",") if c.strip()]
    assert codes[-1] == "kOpCount" and len(codes) - 1 == len(modmath_cuda.OPS)
    kernels = dict(re.findall(r"^PPLP_M62_KERNEL\((\w+), (\w+)\)$", text, re.M))
    by_code = {code: f"m62_{name}" for name, code in kernels.items()}
    assert [by_code[c] for c in codes[:-1]] == [k for k, _ in modmath_cuda.OPS.values()]
    counts = re.search(r"kOperands\[kOpCount\] = \{([^}]*)\}", text).group(1)
    assert [int(c) for c in counts.split(",")] == [
        len(operands) for _, operands in modmath_cuda.OPS.values()]
    assert f"kMaxOperands = {modmath_cuda.MAX_OPERANDS};" in text
    assert f"kMaxDims = {modmath_cuda.MAX_DIMS};" in text
    blocks = re.search(r"kMaxBlocks = (\d+) \* (\d+);", text).groups()
    threads = re.search(r"kThreads = (\d+);", text).group(1)
    assert "kMaxNumel = (int64_t{1} << 32) - kMaxBlocks * kThreads;" in text
    assert modmath_cuda.MAX_NUMEL == (1 << 32) - int(blocks[0]) * int(blocks[1]) * int(threads)
