"""Privacy primitives: Bloom filter, blinding, proximity key packing."""

from .bloom import BloomFilter, BloomParameters
from .blinding import Blinding, blind_distance_keys, pack_key

__all__ = ["BloomParameters", "BloomFilter", "Blinding", "pack_key",
           "blind_distance_keys"]
