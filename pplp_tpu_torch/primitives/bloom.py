"""Bloom filter, bit-compatible with the reference's Partow-derived filter.

Counterpart of ``pplp_tpu.primitives.bloom``. The parameter optimization,
salt schedule, host AP hash, host probe and wire format are copied from it
verbatim; the batch insert (AP hash of u64 keys against every salt, index,
and the OR-scatter into the bit table), the batch probe (the same hash,
then a gather) and the bit packing for the wire run as torch ops on the
filter's device. The bit table is held unpacked, one
byte per bit, as the reference holds it: at r = 4096 and fpp 1e-12 that is
about 965 MB on the device.

All hashing is 32-bit unsigned arithmetic done in int64: every value is
masked to 32 bits after a shift, add, multiply or complement.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.modmath import mul32

__all__ = ["BloomParameters", "BloomFilter", "CompressibleBloomFilter", "pack_bits", "probe"]

BITS_PER_CHAR = 8

# Partow's public predefined salt table (bloomfilter.h:468-490).
_PREDEF_SALT = [
    0xAAAAAAAA, 0x55555555, 0x33333333, 0xCCCCCCCC, 0x66666666, 0x99999999,
    0xB5B5B5B5, 0x4B4B4B4B, 0xAA55AA55, 0x55335533, 0x33CC33CC, 0xCC66CC66,
    0x66996699, 0x99B599B5, 0xB54BB54B, 0x4BAA4BAA, 0xAA33AA33, 0x55CC55CC,
    0x33663366, 0xCC99CC99, 0x66B566B5, 0x994B994B, 0xB5AAB5AA, 0xAAAAAA33,
    0x555555CC, 0x33333366, 0xCCCCCC99, 0x666666B5, 0x9999994B, 0xB5B5B5AA,
    0xFFFFFFFF, 0xFFFF0000, 0xB823D5EB, 0xC1191CDF, 0xF623AEB3, 0xDB58499F,
    0xC8D42E70, 0xB173F616, 0xA91A5967, 0xDA427D63, 0xB1E8A2EA, 0xF6C0D155,
    0x4909FEA3, 0xA68CC6A7, 0xC395E782, 0xA26057EB, 0x0CD5DA28, 0x467C5492,
    0xF15E6982, 0x61C6FAD3, 0x9615E352, 0x6E9E355A, 0x689B563E, 0x0C9831A8,
    0x6753C18B, 0xA622689B, 0x8CA63C47, 0x42CC2884, 0x8E89919B, 0x6EDBD7D3,
    0x15B6796C, 0x1D6FDFE4, 0x63FF9092, 0xE7401432, 0xEFFE9412, 0xAEAEDF79,
    0x9F245A31, 0x83C136FC, 0xC3DA4A8C, 0xA5112C8C, 0x5271F491, 0x9A948DAB,
    0xCEE59A8D, 0xB5F525AB, 0x59D13217, 0x24E7C331, 0x697C2103, 0x84B0A460,
    0x86156DA9, 0xAEF2AC68, 0x23243DA5, 0x3F649643, 0x5FA495A8, 0x67710DF8,
    0x9A6C499E, 0xDCFB0227, 0x46A43433, 0x1832B07A, 0xC46AFF3C, 0xB9C8FFF0,
    0xC9500467, 0x34431BDF, 0xB652432B, 0xE367F12B, 0x427F4C1B, 0x224C006E,
    0x2E7E5A89, 0x96F99AA5, 0x0BEB452A, 0x2FD87C39, 0x74B2E1FB, 0x222EFD24,
    0xF357F60C, 0x440FCB1E, 0x8BBE030F, 0x6704DC29, 0x1144D12F, 0x948B1355,
    0x6D8FD7E9, 0x1C11A014, 0xADD1592F, 0xFB3C712E, 0xFC77642F, 0xF9C4CE8C,
    0x31312FB9, 0x08B0DD79, 0x318FA6E7, 0xC040D23D, 0xC0589AA7, 0x0CA5C075,
    0xF874B172, 0x0CF914D5, 0x784D3280, 0x4E8CFEBC, 0xC569F575, 0xCDB2A091,
    0x2CC016B4, 0x5C5F4421,
]

_M32 = 0xFFFFFFFF
_HDR = struct.Struct("<IQQQQd")  # packed bf_hdr (bloomfilter.h:218-225)


@dataclass
class BloomParameters:
    """Mirror of ``bloom_parameters`` with identical optimization math.

    ``index_mode`` selects how a hash maps to a bit index:
      * "reference" — exactly Partow/pplp: ``hash % table_size``. For the
        protocol's shifted keys ((bd << w_len) | w) the AP hash is affine in
        the key, its low w_len bits are constant, and since table_size shares
        a power-of-two factor with the key stride each salt can only reach a
        tiny fraction of slots — the reference silently runs with a massively
        inflated false-positive rate.
      * "mixed" (sound default for this framework's protocols) — applies a
        32-bit avalanche finalizer (murmur3 fmix32) to the hash before
        indexing, restoring uniformity. Wire format is unchanged; both roles
        must agree on the mode (protocol config carries it).
    """

    projected_element_count: int = 10000
    false_positive_probability: float = 1.0 / 10000
    random_seed: int = 0xA5A5A5A55A5A5A5A
    minimum_size: int = 1
    maximum_size: int = (1 << 64) - 1
    minimum_number_of_hashes: int = 1
    maximum_number_of_hashes: int = (1 << 32) - 1
    index_mode: str = "reference"
    number_of_hashes: int = field(default=0, init=False)
    table_size: int = field(default=0, init=False)

    def compute_optimal_parameters(self) -> bool:
        if (
            self.projected_element_count == 0
            or self.false_positive_probability < 0.0
            or self.random_seed in (0, (1 << 64) - 1)
        ):
            return False
        min_m = math.inf
        min_k = 0.0
        k = 1.0
        while k < 1000.0:
            numerator = -k * self.projected_element_count
            denominator = math.log(
                1.0 - self.false_positive_probability ** (1.0 / k)
            )
            curr_m = numerator / denominator
            if curr_m < min_m:
                min_m = curr_m
                min_k = k
            k += 1.0
        self.number_of_hashes = int(min_k)
        self.table_size = int(min_m)
        rem = self.table_size % BITS_PER_CHAR
        if rem:
            self.table_size += BITS_PER_CHAR - rem
        self.number_of_hashes = min(
            max(self.number_of_hashes, self.minimum_number_of_hashes),
            self.maximum_number_of_hashes,
        )
        self.table_size = min(max(self.table_size, self.minimum_size), self.maximum_size)
        return True


def _hash_ap_bytes(data: bytes, h: int) -> int:
    """Reference AP hash over a byte string (host scalar path)."""
    i = 0
    loop = 0
    remaining = len(data)
    while remaining >= 8:
        i1 = int.from_bytes(data[i : i + 4], "little")
        i2 = int.from_bytes(data[i + 4 : i + 8], "little")
        h ^= ((h << 7) & _M32) ^ ((i1 * (h >> 3)) & _M32) ^ (
            (~(((h << 11) & _M32) + (i2 ^ (h >> 5)))) & _M32
        )
        h &= _M32
        i += 8
        remaining -= 8
    if remaining >= 4:
        v = int.from_bytes(data[i : i + 4], "little")
        if loop & 1:
            h ^= ((h << 7) & _M32) ^ ((v * (h >> 3)) & _M32)
        else:
            h ^= (~(((h << 11) & _M32) + (v ^ (h >> 5)))) & _M32
        h &= _M32
        loop += 1
        i += 4
        remaining -= 4
    if remaining >= 2:
        v = int.from_bytes(data[i : i + 2], "little")
        if loop & 1:
            h ^= ((h << 7) & _M32) ^ ((v * (h >> 3)) & _M32)
        else:
            h ^= (~(((h << 11) & _M32) + (v ^ (h >> 5)))) & _M32
        h &= _M32
        loop += 1
        i += 2
        remaining -= 2
    if remaining:
        h = (h + ((data[i] ^ ((h * 0xA5A5A5A5) & _M32)) + loop)) & _M32
    return h


def _fmix32_int(h: int) -> int:
    """murmur3 32-bit finalizer (host scalar)."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _fmix32_vec(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)[0]
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)[0]
    return h ^ (h >> 16)


def _hash_ap_u64_vec(klo: torch.Tensor, khi: torch.Tensor,
                     salts: torch.Tensor) -> torch.Tensor:
    """AP hash of 8-byte little-endian keys: salts [S] x keys [K] -> [S, K].

    One 8-byte iteration of the reference chain with i1 = low word and
    i2 = high word; every term is masked back to 32 bits."""
    h = salts[:, None]
    i1 = klo[None, :]
    i2 = khi[None, :]
    a = (h << 7) & _M32
    b = (i1 * (h >> 3)) & _M32  # < 2^61 before the mask
    c = ~(((h << 11) & _M32) + (i2 ^ (h >> 5))) & _M32
    return h ^ (a ^ b ^ c)


def _indices(klo, khi, salts, sizes: tuple, mixed: bool) -> torch.Tensor:
    """Bit indices [S, K]: the hash reduced by each size of the chain in
    turn (one size for a plain filter, the historical sizes of a compressed
    one)."""
    h = _hash_ap_u64_vec(klo, khi, salts)
    if mixed:
        h = _fmix32_vec(h)
    for s in sizes:
        h = h % s
    return h


def probe(bits, klo, khi, salts, table_size: int, mixed: bool) -> torch.Tensor:
    """Membership of u64 keys as (lo, hi) word tensors [K] in the unpacked
    bit table ``bits``: the AP hash against every salt, then one gather ->
    bool [K]."""
    return (bits[_indices(klo, khi, salts, (table_size,), mixed)] != 0).all(dim=0)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Little-endian packbits of a 0/1 uint8 tensor (np.packbits order),
    on the tensor's device."""
    pad = (-bits.shape[0]) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros(pad)])
    b = bits.view(-1, 8)
    out = b[:, 0].clone()
    for k in range(1, 8):
        out |= b[:, k] << k
    return out


class BloomFilter:
    """Bit-compatible Bloom filter; batch inserts run on ``device``."""

    # Keys per hash/scatter pass (bounds the [salts, keys] index temporaries).
    _INSERT_CHUNK = 1 << 20

    def __init__(self, params: BloomParameters | None = None, device="cpu"):
        self.device = torch.device(device)
        self._device_bits = None  # unpacked uint8 [table_size] on device
        self._host_dirty = False
        if params is None:
            self.salt_count = 0
            self.table_size = 0
            self.projected_element_count = 0
            self.inserted_element_count = 0
            self.random_seed = 0
            self.desired_fpp = 0.0
            self.salts = np.zeros(0, np.uint32)
            self.bit_table = np.zeros(0, np.uint8)
            self.index_mode = "reference"
            return
        assert params.table_size, "call compute_optimal_parameters() first"
        self.projected_element_count = params.projected_element_count
        self.inserted_element_count = 0
        self.random_seed = (params.random_seed * 0xA5A5A5A5 + 1) % (1 << 64)
        self.desired_fpp = params.false_positive_probability
        self.salt_count = params.number_of_hashes
        self.table_size = params.table_size
        self.index_mode = params.index_mode
        self.salts = self._generate_unique_salt()
        self.bit_table = np.zeros(self.table_size // BITS_PER_CHAR, np.uint8)

    # -- salt schedule (bloomfilter.h:459-525) --------------------------

    def _generate_unique_salt(self) -> np.ndarray:
        if self.salt_count > len(_PREDEF_SALT):
            raise NotImplementedError(
                "salt_count > 128 requires libc rand() replication; the "
                "reference never exceeds 128 (fpp >= 1e-38)"
            )
        salts = [int(s) for s in _PREDEF_SALT[: self.salt_count]]
        seed32 = self.random_seed & _M32
        for i in range(len(salts)):
            # Sequential in-place mixing — later entries see mixed neighbors.
            salts[i] = (salts[i] * salts[(i + 3) % len(salts)] + seed32) & _M32
        return np.asarray(salts, np.uint32)

    # -- host scalar paths (exact reference semantics) ------------------

    def _sizes(self) -> tuple:
        """The moduli a hash is reduced by, in order."""
        return (self.table_size,)

    def _host_indices(self, data: bytes):
        for s in self.salts:
            h = _hash_ap_bytes(data, int(s))
            if self.index_mode == "mixed":
                h = _fmix32_int(h)
            for size in self._sizes():
                h %= size
            yield h

    def insert_bytes(self, data: bytes):
        self._sync_host()
        for bit_index in self._host_indices(data):
            self.bit_table[bit_index // 8] |= 1 << (bit_index % 8)
        self.inserted_element_count += 1
        self._device_bits = None

    def insert_u64(self, key: int):
        self.insert_bytes(int(key).to_bytes(8, "little"))

    def contains_bytes(self, data: bytes) -> bool:
        self._sync_host()
        return all(
            self.bit_table[b // 8] & (1 << (b % 8)) for b in self._host_indices(data)
        )

    def contains_u64(self, key: int) -> bool:
        return self.contains_bytes(int(key).to_bytes(8, "little"))

    # -- device batch paths ---------------------------------------------

    @property
    def bits_device(self) -> torch.Tensor:
        """The unpacked bit table on ``device`` (created on first use)."""
        if self._device_bits is None:
            if self.inserted_element_count == 0 and not self.bit_table.any():
                self._device_bits = torch.zeros(
                    self.table_size, dtype=torch.uint8, device=self.device)
            else:
                bits = np.unpackbits(self.bit_table, bitorder="little")
                self._device_bits = torch.as_tensor(bits, device=self.device)
        return self._device_bits

    def _salts_device(self) -> torch.Tensor:
        return torch.as_tensor(self.salts.astype(np.int64), device=self.device)

    def insert_u64_batch(self, klo, khi, count: int | None = None):
        """Insert u64 keys given as int64 (lo, hi) word tensors [K].

        ``count`` is how many leading keys are fresh (a padded chunk repeats
        valid keys); it only affects ``inserted_element_count``. The bit
        table is updated in place, one pass per ``_INSERT_CHUNK`` keys."""
        assert self.table_size < (1 << 32), "device path needs u32 indices"
        klo = torch.as_tensor(klo, device=self.device).reshape(-1)
        khi = torch.as_tensor(khi, device=self.device).reshape(-1)
        bits = self.bits_device
        salts = self._salts_device()
        mixed = self.index_mode == "mixed"
        for start in range(0, klo.shape[0], self._INSERT_CHUNK):
            stop = start + self._INSERT_CHUNK
            idx = _indices(klo[start:stop], khi[start:stop], salts, self._sizes(), mixed)
            bits.index_fill_(0, idx.reshape(-1), 1)
        self.inserted_element_count += klo.shape[0] if count is None else int(count)
        self._host_dirty = True

    def contains_u64_batch(self, klo, khi) -> torch.Tensor:
        """Membership of u64 keys given as int64 (lo, hi) word tensors [K]:
        one gather on the unpacked table over all salts -> bool [K]."""
        klo = torch.as_tensor(klo, device=self.device).reshape(-1)
        khi = torch.as_tensor(khi, device=self.device).reshape(-1)
        idx = _indices(klo, khi, self._salts_device(), self._sizes(), self.index_mode == "mixed")
        return (self.bits_device[idx] != 0).all(dim=0)

    def _sync_host(self):
        if self._device_bits is not None and self._host_dirty:
            # Pack on the device: 8x fewer bytes cross to the host.
            self.bit_table = pack_bits(self._device_bits).cpu().numpy()
            self._host_dirty = False

    def _compatible(self, other) -> bool:
        return (
            self.salt_count == other.salt_count
            and self.table_size == other.table_size
            and self.random_seed == other.random_seed
        )

    # -- set algebra (bloomfilter.h:410-444) ----------------------------

    def _combine(self, other, op):
        if self._compatible(other):
            self._sync_host()
            other._sync_host()
            op(self.bit_table, other.bit_table, out=self.bit_table)
            self._device_bits = None
        return self

    def __iand__(self, other):
        return self._combine(other, np.bitwise_and)

    def __ior__(self, other):
        return self._combine(other, np.bitwise_or)

    def __ixor__(self, other):
        return self._combine(other, np.bitwise_xor)

    def clear(self):
        self._sync_host()
        self.bit_table[:] = 0
        self.inserted_element_count = 0
        self._device_bits = None

    def effective_fpp(self) -> float:
        k = len(self.salts)
        return (1.0 - math.exp(-1.0 * k * self.inserted_element_count / self.table_size)) ** k

    # -- wire format (bloomfilter.h:218-278) ----------------------------

    def compute_serialization_size(self) -> int:
        return _HDR.size + 4 * len(self.salts) + self.table_size // 8

    def _header_bytes(self) -> bytes:
        return _HDR.pack(
            self.salt_count,
            self.table_size,
            self.projected_element_count,
            self.inserted_element_count,
            self.random_seed,
            self.desired_fpp,
        ) + self.salts.tobytes()

    def serialize(self) -> bytes:
        self._sync_host()
        return self._header_bytes() + self.bit_table.tobytes()

    def iter_serialized(self, chunk_bytes: int = 16 << 20):
        """``serialize()``'s bytes in pieces: the header, then the packed
        table in slices of ``chunk_bytes``. A table changed on the device is
        packed there once and copied to the host one slice at a time, so a
        consumer (a socket) can send a slice while the next one is copied;
        the host table is refreshed on the way, so a later ``serialize()``
        costs no copy."""
        yield self._header_bytes()
        if self._device_bits is None or not self._host_dirty:
            table = self.bit_table.tobytes()
            for off in range(0, len(table), chunk_bytes):
                yield table[off:off + chunk_bytes]
            return
        packed = pack_bits(self._device_bits)
        host_rows = []
        for off in range(0, packed.shape[0], chunk_bytes):
            row = packed[off:off + chunk_bytes].cpu().numpy()
            host_rows.append(row)
            yield row.tobytes()
        self.bit_table = np.concatenate(host_rows) if host_rows else self.bit_table
        self._host_dirty = False

    @classmethod
    def deserialize(cls, buf: bytes, index_mode: str = "reference",
                    device="cpu") -> "BloomFilter":
        bf = cls(device=device)
        bf.index_mode = index_mode
        (
            bf.salt_count,
            bf.table_size,
            bf.projected_element_count,
            bf.inserted_element_count,
            bf.random_seed,
            bf.desired_fpp,
        ) = _HDR.unpack_from(buf, 0)
        off = _HDR.size
        bf.salts = np.frombuffer(buf, np.uint32, bf.salt_count, off).copy()
        off += 4 * bf.salt_count
        bf.bit_table = np.frombuffer(buf, np.uint8, bf.table_size // 8, off).copy()
        return bf

    def __eq__(self, other):
        if not isinstance(other, BloomFilter):
            return NotImplemented
        self._sync_host()
        other._sync_host()
        return (
            self._compatible(other)
            and self.inserted_element_count == other.inserted_element_count
            and (self.bit_table == other.bit_table).all()
        )


class CompressibleBloomFilter(BloomFilter):
    """Partow's ``compressible_bloom_filter`` (bloomfilter.h:613-688): the
    bit table can shrink after construction; an index is reduced by every
    historical size in turn, so earlier insertions keep resolving.

    ``compress(percentage)`` folds the table (OR of the wrapped bits) to
    (100 - percentage)% of its current size, byte-aligned, and returns False,
    leaving the filter unchanged, for an out-of-range or degenerate request.
    The wire format is the base one, then a u16 count and the u64 sizes."""

    def __init__(self, params: BloomParameters | None = None, device="cpu"):
        super().__init__(params, device)
        self.size_list = [self.table_size] if self.table_size else []

    def _sizes(self) -> tuple:
        return tuple(self.size_list)

    def _size_tail(self) -> bytes:
        return struct.pack("<H", len(self.size_list)) + b"".join(
            struct.pack("<Q", size) for size in self.size_list)

    def serialize(self) -> bytes:
        return super().serialize() + self._size_tail()

    @classmethod
    def deserialize(cls, buf: bytes, index_mode: str = "reference",
                    device="cpu") -> "CompressibleBloomFilter":
        bf = super().deserialize(buf, index_mode, device)
        off = _HDR.size + 4 * bf.salt_count + bf.table_size // 8
        (n_sizes,) = struct.unpack_from("<H", buf, off)
        bf.size_list = list(struct.unpack_from(f"<{n_sizes}Q", buf, off + 2))
        if not bf.size_list or bf.size_list[-1] != bf.table_size:
            raise ValueError("the size chain does not end at the table size")
        return bf

    def compute_serialization_size(self) -> int:
        return super().compute_serialization_size() + 2 + 8 * len(self.size_list)

    def iter_serialized(self, chunk_bytes: int = 16 << 20):
        yield from super().iter_serialized(chunk_bytes)
        yield self._size_tail()

    def compress(self, percentage: float) -> bool:
        if not 0.0 < percentage < 100.0:
            return False
        self._sync_host()
        original = self.table_size
        new_size = int(original * (1.0 - percentage / 100.0))
        new_size -= new_size % BITS_PER_CHAR
        if new_size < BITS_PER_CHAR or new_size >= original:
            return False
        bits = np.unpackbits(self.bit_table, bitorder="little")[:original]
        folded = np.zeros(new_size, np.uint8)
        np.bitwise_or.at(folded, np.arange(original) % new_size, bits)
        self.bit_table = np.packbits(folded, bitorder="little")
        self.table_size = new_size
        self.size_list.append(new_size)
        self._device_bits = None
        return True
