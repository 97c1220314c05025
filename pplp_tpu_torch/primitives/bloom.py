"""Bloom filter, bit-compatible with the reference's Partow-derived filter.

Counterpart of ``pplp_tpu.primitives.bloom``. The parameter optimization,
salt schedule, host AP hash, host probe and wire format are copied from it
verbatim. The batch insert (AP hash of u64 keys against every salt, index,
OR into the bit table) and the batch probe run on the filter's device:

* on a CUDA device the table is packed, ``ceil(table_size / 32)`` u32
  words (an int32 tensor), and every insert and probe runs the
  hand-written kernels ``csrc/bloom.cu`` (``ops/bloom_cuda.py``: a probe
  is one launch, an insert one launch into a table that fits in L2 and
  three a chunk of keys into a larger one). On a
  little-endian host the words' bytes are the wire's packed table, so
  serializing copies them as they are, in one copy from the card. At r =
  8192 and fpp 1e-12 the table is 482.4 MB on the card;
* the plain version, which a CPU filter runs, holds the table unpacked, one
  byte per bit, as the reference does: ``_indices`` (the hash as int64 torch
  ops), ``index_fill_``, a gather, and ``pack_bits`` for the wire. A CPU
  filter built with ``packed=True`` keeps words and runs the plain version
  on them (the tests hold the word-table methods so).

Nothing on a CUDA device falls back to the plain version. All hashing is
32-bit unsigned arithmetic; in the plain version it is done in int64, every
value masked to 32 bits after a shift, add, multiply or complement.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import bloom_cuda
from ..ops.modmath import mul32
from ..utils.profiling import span
from .blinding import blind_distance_keys, blinded_keys, distance_keys

__all__ = ["BloomParameters", "BloomFilter", "CompressibleBloomFilter", "pack_bits", "insert",
           "probe", "insert_plain", "probe_plain"]

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


_INSERT_CHUNK = 1 << 20  # keys a plain pass hashes (bounds the [salts, keys] indices)


def insert_plain(bits, klo, khi, salts, sizes: tuple, mixed: bool):
    """The plain insert: the bits of u64 keys, int64 (lo, hi) word tensors
    [K], set in the unpacked table ``bits``, one ``index_fill_`` per
    ``_INSERT_CHUNK`` keys."""
    chunk = _INSERT_CHUNK
    for start in range(0, klo.shape[0], chunk):
        idx = _indices(klo[start:start + chunk], khi[start:start + chunk], salts, sizes, mixed)
        bits.index_fill_(0, idx.reshape(-1), 1)


def probe_plain(bits, klo, khi, salts, sizes: tuple, mixed: bool) -> torch.Tensor:
    """The plain probe: membership of u64 keys as (lo, hi) word tensors [K]
    in the unpacked table ``bits``, one gather over all salts -> bool [K]."""
    return (bits[_indices(klo, khi, salts, sizes, mixed)] != 0).all(dim=0)


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


def unpack_words(words: torch.Tensor, table_size: int) -> torch.Tensor:
    """The unpacked table (uint8 0/1 [table_size]) of packed u32 words."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts) & 1).to(torch.uint8).reshape(-1)[:table_size]


def words_of_bytes(packed: np.ndarray, device) -> torch.Tensor:
    """A packed table's bytes (np.packbits order) -> a new tensor of its u32
    words (int32) on ``device``, the last word zero-padded."""
    host = np.zeros(bloom_cuda.words_for(8 * packed.shape[0]) * 4, np.uint8)
    host[:packed.shape[0]] = packed
    return torch.from_numpy(host.view(np.int32)).to(device)


def _chain(sizes) -> tuple:
    return (int(sizes),) if isinstance(sizes, int) else tuple(sizes)


def _plain_table(table: torch.Tensor, table_size: int) -> torch.Tensor:
    if table.device.type != "cpu":
        raise ValueError(f"no Bloom filter path for a table on {table.device}")
    return table if table.dtype == torch.uint8 else unpack_words(table, table_size)


_BLINDED_CHUNK = 1 << 16  # keys a plain pass makes of a blinded range


def insert(table, salts, sizes, mixed: bool, *, keys=None, blinded=None):
    """Set the bits of u64 keys in a filter's device table, in place.

    ``keys=(lo, hi)``: int64 word tensors [K]; ``blinded=(s, r, w, w_len,
    start, count)``: the keys ((s (di + r) mod 2^64) << w_len) | w for di in
    [start, start + count), s and r below 2^32. ``sizes``: the size chain, or
    the table size. A table on a CUDA device is packed and goes to the
    insert kernels (``bloom_cuda.insert_cuda``: the direct kernel for a
    table that fits in L2, else the partitioned ones); on the CPU the plain
    version runs, on the unpacked table or on the words unpacked and packed
    again."""
    sizes = _chain(sizes)
    with span("bloom.insert") as rec:
        if table.is_cuda:
            plan = bloom_cuda.insert_cuda(table, salts, sizes, mixed, keys=keys, blinded=blinded)
            rec.set(route=plan.route, chunks=plan.chunks, keys=plan.count)
            return
        bits = _plain_table(table, sizes[-1])
        if keys is not None:
            insert_plain(bits, *keys, salts, sizes, mixed)
            rec.set(route="plain", chunks=1, keys=keys[0].numel())
        else:
            s, r, w, w_len, start, count = blinded
            steps = torch.arange(_BLINDED_CHUNK, dtype=torch.int64)
            for lo in range(start, start + count, _BLINDED_CHUNK):
                di = (steps + lo)[:start + count - lo]
                insert_plain(bits, *distance_keys(di, s, r, w, w_len), salts, sizes, mixed)
            rec.set(route="plain", chunks=-(-count // _BLINDED_CHUNK), keys=count)
        if bits is not table:
            table.copy_(words_of_bytes(pack_bits(bits).numpy(), "cpu"))


def probe(table, salts, sizes, mixed: bool, *, keys=None,
          blind_distances=None) -> torch.Tensor:
    """Membership of u64 keys in a filter's device table -> bool.

    ``keys=(lo, hi)``: int64 word tensors [K] -> [K];
    ``blind_distances=(bd, w, w_len)``: the keys (bd << w_len) | w of blind
    distances bd < 2^32 (any shape; 0 < w_len < 32) -> bool shaped like bd.
    A table on a CUDA device goes to the ``bf_probe`` kernel (one launch,
    which reads bd in place when it is contiguous); on the CPU the plain
    version gathers from the unpacked table."""
    sizes = _chain(sizes)
    if blind_distances is not None:
        bd, w, w_len = blind_distances
        if table.is_cuda:
            return bloom_cuda.probe_cuda(table, salts, sizes, mixed,
                                         blind_distances=(bd.contiguous(), w, w_len))
        klo, khi = blinded_keys(bd.reshape(-1), w, w_len)
        return probe_plain(_plain_table(table, sizes[-1]), klo, khi, salts, sizes,
                           mixed).reshape(bd.shape)
    if table.is_cuda:
        return bloom_cuda.probe_cuda(table, salts, sizes, mixed, keys=keys)
    return probe_plain(_plain_table(table, sizes[-1]), *keys, salts, sizes, mixed)


class BloomFilter:
    """Bit-compatible Bloom filter; batch inserts and probes run on ``device``.

    The host copy ``bit_table`` (packed bytes, the wire's) and the device
    table (``bits_device``) are kept in step lazily: a device write marks the
    host copy stale, a host write drops the device table. ``packed`` (the
    default on a CUDA device, where it is required) keeps the device table as
    u32 words; else it is one byte per bit.

    ``bit_table`` may be read-only: a view of the message that the filter
    was read from or written into (``deserialize``, ``table_into``). A host
    write copies it first (``_writable_table``), so such a message never
    changes. The table leaves the device by one copy (``_fetch``) into
    page-locked memory from PyTorch's caching host allocator
    (``host_buffer``), either into a host table of the filter's own
    (``_sync_host``) or into its place in a message (``table_into``)."""

    def __init__(self, params: BloomParameters | None = None, *, device,
                 packed: bool | None = None):
        self.device = torch.device(device)
        self.packed = self.device.type == "cuda" if packed is None else bool(packed)
        if self.device.type == "cuda" and not self.packed:
            raise ValueError("a filter on a CUDA device keeps a packed table")
        self._table = None  # the device table, made on first use
        self._salts = None  # the salts as int64 on ``device``, made on first use
        self._host_dirty = False  # the device table is newer than bit_table
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
        if self.packed:  # an empty table of words, so nothing reads the host copy
            self._table = torch.zeros(bloom_cuda.words_for(self.table_size), dtype=torch.int32,
                                      device=self.device)

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
        self._writable_table()
        for bit_index in self._host_indices(data):
            self.bit_table[bit_index // 8] |= 1 << (bit_index % 8)
        self.inserted_element_count += 1
        self._table = None

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
        """The filter's table on ``device``, the one that every device insert
        and probe takes: u32 words (an int32 tensor) when packed, else one
        byte per bit. Made from the host copy on first use."""
        if self._table is None:
            if self.packed:
                self._table = words_of_bytes(self.bit_table, self.device)
            elif self.inserted_element_count == 0 and not self.bit_table.any():
                self._table = torch.zeros(self.table_size, dtype=torch.uint8, device=self.device)
            else:
                bits = np.unpackbits(self.bit_table, bitorder="little")
                self._table = torch.as_tensor(bits, device=self.device)
        return self._table

    def _salts_device(self) -> torch.Tensor:
        if self._salts is None:
            self._salts = torch.as_tensor(self.salts.astype(np.int64), device=self.device)
        return self._salts

    def _keys(self, k) -> torch.Tensor:
        return torch.as_tensor(k, device=self.device).reshape(-1).to(torch.int64).contiguous()

    def insert_u64_batch(self, klo, khi, count: int | None = None):
        """Insert u64 keys given as int64 (lo, hi) word tensors [K].

        ``count`` is how many leading keys are fresh (a padded chunk repeats
        valid keys); it only affects ``inserted_element_count``. The device
        table is updated in place (``insert``)."""
        assert self.table_size < (1 << 32), "device path needs u32 indices"
        klo, khi = self._keys(klo), self._keys(khi)
        insert(self.bits_device, self._salts_device(), self._sizes(), self.index_mode == "mixed",
               keys=(klo, khi))
        self.inserted_element_count += klo.shape[0] if count is None else int(count)
        self._host_dirty = True

    def insert_blind_distances(self, blinding, sq_radius: int):
        """Insert the server's keys ((s (di + r) mod 2^64) << w_len) | w for
        di < ``sq_radius`` (``blinding``: a ``Blinding``). A packed table
        makes the keys inside the insert kernels, one insert for all of them;
        an unpacked one takes ``blind_distance_keys``'s chunks, as the
        reference does. ``inserted_element_count`` grows by ``sq_radius``
        either way, as the reference's does."""
        if not self.packed:
            for klo, khi, count in blind_distance_keys(blinding, sq_radius, self.device):
                self.insert_u64_batch(klo, khi, count=count)
            return
        assert self.table_size < (1 << 32), "device path needs u32 indices"
        insert(self.bits_device, self._salts_device(), self._sizes(), self.index_mode == "mixed",
               blinded=(blinding.s, blinding.r, blinding.w, blinding.w_len, 0, sq_radius))
        self.inserted_element_count += sq_radius
        self._host_dirty = True

    def contains_u64_batch(self, klo, khi) -> torch.Tensor:
        """Membership of u64 keys given as int64 (lo, hi) word tensors [K]
        -> bool [K] (``probe``)."""
        return probe(self.bits_device, self._salts_device(), self._sizes(),
                     self.index_mode == "mixed", keys=(self._keys(klo), self._keys(khi)))

    def _packed_device(self) -> torch.Tensor:
        """The wire's packed table bytes, on ``device``: the words' own
        bytes, or the unpacked table packed."""
        if self.packed:
            return self._table.view(torch.uint8)[:self.table_size // BITS_PER_CHAR]
        return pack_bits(self._table)

    def host_buffer(self, nbytes: int) -> np.ndarray:
        """``nbytes`` of host memory (uint8) for the filter's bytes: for a
        filter on a CUDA device page-locked, from PyTorch's caching host
        allocator, so the table's copy needs no staging and a freed block
        serves the next message without pinning or page faults again; plain
        memory elsewhere."""
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda").numpy()

    def _fetch(self, packed: torch.Tensor, out: np.ndarray):
        """One copy of the packed table bytes ``packed`` (``_packed_device``)
        into host memory ``out``."""
        dst = torch.from_numpy(out)
        with span("bloom.table_to_host", bytes=out.shape[0],
                  pinned=int(packed.is_cuda and dst.is_pinned())):
            dst.copy_(packed)

    def _sync_host(self):
        if self._table is not None and self._host_dirty:
            host = self.host_buffer(self.table_size // BITS_PER_CHAR)
            self._fetch(self._packed_device(), host)
            self.bit_table = host
            self._host_dirty = False

    def _writable_table(self):
        """Make ``bit_table`` writable before a host write in place: a table
        read in a message's place is copied first, so the message stays as
        it was sent or received."""
        if not self.bit_table.flags.writeable:
            self.bit_table = self.bit_table.copy()

    def _compatible(self, other) -> bool:
        return (
            self.salt_count == other.salt_count
            and self.table_size == other.table_size
            and self.random_seed == other.random_seed
        )

    # -- set algebra (bloomfilter.h:410-444) ----------------------------

    def _combine(self, other, op: str):
        """``op`` (a bitwise operation's name in numpy and torch) of the two
        tables, into this one: on the words of a packed filter, else on the
        host copies."""
        if not self._compatible(other):
            return self
        if self.packed:
            words = self.bits_device
            if other.packed and other._table is not None and other._table.device == words.device:
                theirs = other._table
            else:
                other._sync_host()
                theirs = words_of_bytes(other.bit_table, words.device)
            getattr(torch, op)(words, theirs, out=words)
            self._host_dirty = True
        else:
            self._sync_host()
            self._writable_table()
            other._sync_host()
            getattr(np, op)(self.bit_table, other.bit_table, out=self.bit_table)
            self._table = None
        return self

    def __iand__(self, other):
        return self._combine(other, "bitwise_and")

    def __ior__(self, other):
        return self._combine(other, "bitwise_or")

    def __ixor__(self, other):
        return self._combine(other, "bitwise_xor")

    def clear(self):
        self.bit_table = np.zeros(self.table_size // BITS_PER_CHAR, np.uint8)
        if self.packed and self._table is not None:
            self._table.zero_()
        else:
            self._table = None
        self._host_dirty = False
        self.inserted_element_count = 0

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

    def _tail(self) -> bytes:
        """What the wire format puts after the table (a compressible
        filter's size chain)."""
        return b""

    def serialize(self) -> bytes:
        self._sync_host()
        return b"".join((self._header_bytes(), self.bit_table, self._tail()))

    def frame_into(self, out: np.ndarray) -> np.ndarray:
        """Write ``serialize()``'s header and tail into ``out`` (uint8 host
        memory of ``compute_serialization_size()`` bytes) and return the
        table's place in it, for ``table_into``."""
        header, tail = self._header_bytes(), self._tail()
        end = len(header) + self.table_size // BITS_PER_CHAR
        out[:len(header)] = np.frombuffer(header, np.uint8)
        out[end:] = np.frombuffer(tail, np.uint8)
        return out[len(header):end]

    def table_into(self, out: np.ndarray):
        """Fill ``out`` (``table_size // 8`` bytes of host memory, a
        message's table place from ``frame_into``) with the packed table:
        one device-to-host copy when the device table is newer, else a copy
        of the host table. ``bit_table`` then reads ``out`` in place,
        read-only."""
        if self._table is not None and self._host_dirty:
            self._fetch(self._packed_device(), out)
        else:
            out[:] = self.bit_table
        out.flags.writeable = False
        self.bit_table = out
        self._host_dirty = False

    @classmethod
    def deserialize(cls, buf, index_mode: str = "reference", *,
                    device, packed: bool | None = None) -> "BloomFilter":
        """The filter that ``buf`` (any buffer: bytes, a memoryview)
        serializes. Its ``bit_table`` reads the table in ``buf`` in place,
        read-only (``_writable_table`` copies it before a host write)."""
        with span("bloom.deserialize", bytes=len(buf)) as rec:
            bf = cls(device=device, packed=packed)
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
            table = np.frombuffer(buf, np.uint8, bf.table_size // 8, off)
            table.flags.writeable = False
            bf.bit_table = table
            rec.set(copied=0)  # the table's bytes copied: none, it is read in place
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

    def __init__(self, params: BloomParameters | None = None, *, device,
                 packed: bool | None = None):
        super().__init__(params, device=device, packed=packed)
        self.size_list = [self.table_size] if self.table_size else []

    def _sizes(self) -> tuple:
        return tuple(self.size_list)

    def _tail(self) -> bytes:
        return struct.pack("<H", len(self.size_list)) + b"".join(
            struct.pack("<Q", size) for size in self.size_list)

    @classmethod
    def deserialize(cls, buf: bytes, index_mode: str = "reference", *,
                    device, packed: bool | None = None) -> "CompressibleBloomFilter":
        bf = super().deserialize(buf, index_mode, device=device, packed=packed)
        off = _HDR.size + 4 * bf.salt_count + bf.table_size // 8
        (n_sizes,) = struct.unpack_from("<H", buf, off)
        bf.size_list = list(struct.unpack_from(f"<{n_sizes}Q", buf, off + 2))
        if not bf.size_list or bf.size_list[-1] != bf.table_size:
            raise ValueError("the size chain does not end at the table size")
        return bf

    def compute_serialization_size(self) -> int:
        return super().compute_serialization_size() + 2 + 8 * len(self.size_list)

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
        self._table = None  # reloaded from the folded host copy on next use
        return True
