"""Hex codec + bit-length helpers (a copy of ``pplp_tpu.utils.hexcodec``).

Behavioral equivalents of ``uint64_to_hex_string`` / ``hex_string_to_uint``
(``pplp:include/examples.h:228-237``, thin wrappers over
``seal::util``) and ``get_bitlen`` (``pplp:include/util.h:32-38``).
"""

from __future__ import annotations

__all__ = ["uint64_to_hex_string", "hex_string_to_uint", "get_bitlen"]


def uint64_to_hex_string(value: int) -> str:
    """Uppercase hex, no leading zeros ("0" for zero) — SEAL's format."""
    return format(int(value) & 0xFFFFFFFFFFFFFFFF, "X")


def hex_string_to_uint(hex_str: str) -> int:
    if not hex_str:
        return 0
    return int(hex_str, 16) & 0xFFFFFFFFFFFFFFFF


def get_bitlen(x: int) -> int:
    """Bit length with the reference's convention that 0 has length 1."""
    return max(1, int(x).bit_length())
