"""Blinding values (r, s, w) and blinded-distance key packing.

Counterpart of ``pplp_tpu.primitives.blinding``; ``Blinding`` and
``pack_key`` are copied from it. The server draws r, s and w; for every
candidate squared distance di < radius^2 it inserts
key = ((s*(di+r) mod 2^64) << bitlen(w)) | w into the Bloom filter, and the
client later probes ((blind_distance << bitlen(w)) | w).

``blind_distance_keys`` produces those keys on the device, chunk for chunk
as the reference does. s*(di+r) reaches 2^65, so it is formed from 32-bit
words (``mul32``) and kept modulo 2^64 as two words.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import torch

from ..ops.modmath import M32, mul32
from ..utils.hexcodec import get_bitlen

__all__ = ["Blinding", "pack_key", "blind_distance_keys"]

_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class Blinding:
    r: int  # 4 random bytes
    s: int  # 4 random bytes
    w: int  # 2 random bytes

    @property
    def w_len(self) -> int:
        return get_bitlen(self.w)

    @staticmethod
    def sample(rng: "secrets | None" = None) -> "Blinding":
        """Fresh blinding values (crypto RNG, like seal::random_bytes)."""
        return Blinding(
            r=secrets.randbits(32), s=secrets.randbits(32), w=secrets.randbits(16)
        )

    @staticmethod
    def deterministic(seed: int) -> "Blinding":
        """Reproducible blinding for tests/benchmarks (determinism hook)."""
        x = (seed * 0x9E3779B97F4A7C15 + 1) & _M64
        return Blinding(r=x & 0xFFFFFFFF, s=(x >> 16) & 0xFFFFFFFF, w=(x >> 48) & 0xFFFF)

    @staticmethod
    def for_protocol(
        t_bits: int,
        sq_radius: int,
        seed: int | None = None,
        max_s_bits: int | None = None,
    ) -> "Blinding":
        """Blinding bounded so s*(d^2 + r) < t for every near-range d^2.

        The reference draws full 32-bit s and r (demo.cc:115-118) but probes
        the Bloom filter with the mod-t blind distance while inserting mod-2^64
        keys (the "modulus mismatch hazard", SURVEY.md §4) — with random
        32-bit draws s*(d^2+r) usually exceeds t = 2^56 and near-detection
        silently fails. This constructor keeps the protocol sound: r gets up
        to 20 bits and s fills the headroom below t.
        """
        base = Blinding.deterministic(seed) if seed is not None else Blinding.sample()
        r_bits = min(20, max(8, t_bits // 2 - get_bitlen(sq_radius)))
        r = base.r & ((1 << r_bits) - 1)
        span_bits = get_bitlen(max(sq_radius - 1, 0) + (1 << r_bits))
        s_bits = max(1, t_bits - span_bits - 1)
        if max_s_bits is not None:
            # Noise-budget cap: the homomorphic result carries noise about
            # s * coord * nu_fresh, which must stay below Delta/2 (see
            # ProximityServer._noise_aware_s_bits).
            s_bits = max(1, min(s_bits, max_s_bits))
        s = base.s & ((1 << s_bits) - 1)
        return Blinding(r=r, s=s | 1, w=base.w)  # s odd => nonzero


def pack_key(bd: int, w: int, w_len: int) -> int:
    """((bd << w_len) | w) mod 2^64 — the BF key format."""
    return ((int(bd) << w_len) | w) & _M64


def blind_distance_keys(blinding: Blinding, sq_radius: int, device,
                        chunk: int = 1 << 20):
    """Yield (klo, khi, count) for di in [0, sq_radius), in fixed-size chunks.

    bd = s * (di + r) mod 2^64; key = (bd << w_len) | w, as int64 tensors of
    32-bit words on ``device``. Every chunk has the reference's size (at most
    2^16); the tail of the last one repeats its last valid key (an OR-scatter
    insert is idempotent), and ``count`` is how many leading keys are fresh.
    """
    chunk = min(chunk, 1 << 16)
    s, w, w_len = blinding.s, blinding.w, blinding.w_len
    r_lo = blinding.r & M32
    steps = torch.arange(chunk, dtype=torch.int64, device=device)
    for start in range(0, sq_radius, chunk):
        di = torch.clamp(steps + start, max=sq_radius - 1)
        add = di + r_lo  # di + r as a 33-bit value
        bd_lo, bd_hi = mul32(add & M32, s)
        bd_hi = (bd_hi + s * (add >> 32)) & M32
        # w_len = bitlen(w) >= 1, so the spill shift is at most 31.
        klo = ((bd_lo << w_len) | w) & M32
        khi = ((bd_hi << w_len) | (bd_lo >> (32 - w_len))) & M32
        yield klo, khi, min(chunk, sq_radius - start)
