"""The ctypes declarations of the kernel wrappers against the C entry points
of ``pplp_tpu_torch/csrc/*.cu``: every declared entry point exists, with as
many arguments, pointers where the C side takes pointers, and every entry
point of the C side is declared. A mismatch would
show only as a failed call on the card; this test needs neither nvcc nor a
card."""

import ctypes
import re

import pytest

from pplp_tpu_torch.ops import behz64_cuda, behz_cuda, dgk_cuda, mulmod_chain, ntt_cuda

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


@pytest.mark.parametrize("wrapper", [ntt_cuda, behz_cuda, behz64_cuda, mulmod_chain, dgk_cuda],
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
