"""Plain Bloom filter of the reference protocol, frozen for the benchmark.

Written from Partow's ``bloomfilter.hpp`` as the reference protocol
(github.com/phanen/pplp) uses it: the optimal (k, m) search, the
predefined salt table mixed with the seed, one 8-byte round of the AP
hash per key, and the packed wire format ``<IQQQQd`` + salts + table.
``index_mode="mixed"`` adds murmur3's fmix32 before the reduction, as the
protocol configuration selects. Plain PyTorch on any device, int64
tensors holding 32-bit values; no product reaches 2^63 (a 32-bit
constant is multiplied in 16-bit halves).
"""

from __future__ import annotations

import math
import struct

import torch

M32 = 0xFFFFFFFF

PREDEF_SALT = (
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
)

HEADER = struct.Struct("<IQQQQd")
KEYS_A_PASS = 1 << 20


def optimal_parameters(elements: int, fpp: float) -> tuple[int, int]:
    """(hashes, table bits): the k in [1, 1000) with the least m, m rounded
    up to whole bytes."""
    best_m, best_k = math.inf, 0
    k = 1.0
    while k < 1000.0:
        m = -k * elements / math.log(1.0 - fpp ** (1.0 / k))
        if m < best_m:
            best_m, best_k = m, k
        k += 1.0
    bits = int(best_m)
    bits += (-bits) % 8
    return max(int(best_k), 1), bits


def salts_for(count: int, seed: int) -> list[int]:
    """The predefined salts, each mixed in turn with a later neighbour and
    the filter's 32-bit seed."""
    salts = list(PREDEF_SALT[:count])
    for i in range(count):
        salts[i] = (salts[i] * salts[(i + 3) % count] + (seed & M32)) & M32
    return salts


def _times_const(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 32-bit h and a 32-bit constant c."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _times_const(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _times_const(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bit_indices(lo: torch.Tensor, hi: torch.Tensor, salts: torch.Tensor, table_bits: int,
                mixed: bool) -> torch.Tensor:
    """[salts, keys] bit indices of 64-bit keys given as 32-bit words."""
    h = salts[:, None]
    a = (h << 7) & M32
    b = (lo[None, :] * (h >> 3)) & M32
    c = (~(((h << 11) & M32) + (hi[None, :] ^ (h >> 5)))) & M32
    h = h ^ (a ^ b ^ c)
    if mixed:
        h = _fmix32(h)
    return h % table_bits


class PlainBloom:
    """An unpacked table, one byte a bit, on ``device``."""

    def __init__(self, elements: int, fpp: float, seed: int, mixed: bool, device):
        self.elements, self.fpp, self.mixed = elements, fpp, mixed
        self.hashes, self.table_bits = optimal_parameters(elements, fpp)
        if self.hashes > len(PREDEF_SALT):
            raise ValueError(f"{self.hashes} hashes: more than the predefined salts")
        self.seed = (seed * 0xA5A5A5A5 + 1) % (1 << 64)
        self.salt_values = salts_for(self.hashes, self.seed)
        self.salts = torch.tensor(self.salt_values, dtype=torch.int64, device=device)
        self.bits = torch.zeros(self.table_bits, dtype=torch.uint8, device=device)
        self.inserted = 0

    def insert(self, lo: torch.Tensor, hi: torch.Tensor):
        for i in range(0, lo.shape[0], KEYS_A_PASS):
            idx = bit_indices(lo[i:i + KEYS_A_PASS], hi[i:i + KEYS_A_PASS], self.salts,
                              self.table_bits, self.mixed)
            self.bits.index_fill_(0, idx.reshape(-1), 1)
        self.inserted += lo.shape[0]

    def probe(self, lo: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(member, salts tested): membership of each key, and how many
        salts a probe that stops at the first clear bit tests."""
        member, tested = [], []
        for i in range(0, lo.shape[0], KEYS_A_PASS):
            idx = bit_indices(lo[i:i + KEYS_A_PASS], hi[i:i + KEYS_A_PASS], self.salts,
                              self.table_bits, self.mixed)
            got = self.bits[idx] != 0  # [salts, keys]
            member.append(got.all(dim=0))
            clear = ~got
            first = torch.where(clear.any(dim=0), clear.to(torch.int8).argmax(dim=0),
                                self.hashes - 1)
            tested.append(first + 1)
        return torch.cat(member), torch.cat(tested)

    def packed(self) -> bytes:
        """The table as the wire packs it: bit i in byte i // 8, bit i % 8."""
        b = self.bits.view(-1, 8).to(torch.int32)
        weights = (1 << torch.arange(8, dtype=torch.int32, device=b.device))
        return (b * weights).sum(dim=1).to(torch.uint8).cpu().numpy().tobytes()

    def serialize(self) -> bytes:
        head = HEADER.pack(self.hashes, self.table_bits, self.elements, self.inserted,
                           self.seed, self.fpp)
        return head + struct.pack(f"<{self.hashes}I", *self.salt_values) + self.packed()
