"""Host utilities: hex codec and bit length."""

from .hexcodec import get_bitlen, hex_string_to_uint, uint64_to_hex_string

__all__ = ["uint64_to_hex_string", "hex_string_to_uint", "get_bitlen"]
