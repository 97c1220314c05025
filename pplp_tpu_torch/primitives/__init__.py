"""Privacy primitives: Bloom filter, blinding, proximity key packing."""

from .bloom import BloomFilter, BloomParameters, CompressibleBloomFilter
from .blinding import Blinding, blind_distance_keys, pack_key

__all__ = ["BloomParameters", "BloomFilter", "CompressibleBloomFilter", "Blinding", "pack_key",
           "blind_distance_keys"]
