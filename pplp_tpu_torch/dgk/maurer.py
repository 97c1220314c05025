"""Maurer's algorithm for provable primes (reference C15,
``src/test/dgk/src/maurer.{h,cc}``: recursive generation with Pocklington
certificates and trial-division prefiltering).

All host-side Python ints; randomness comes from an explicit ``random.Random``
so keygen is reproducible given a seed (the reference seeds GMP's PRNG from
gettimeofday — SURVEY.md §4 notes that as a quirk, not a behavior to keep).

Copy of ``pplp_tpu.dgk.maurer``: the same seed gives the same primes.
"""

from __future__ import annotations

import math
import random

__all__ = ["maurer", "prime_prod", "trial_division_ok", "SMALL_PRIMES"]


def _sieve(limit: int) -> list[int]:
    flags = bytearray([1]) * (limit + 1)
    flags[0:2] = b"\x00\x00"
    for i in range(2, int(limit**0.5) + 1):
        if flags[i]:
            flags[i * i :: i] = b"\x00" * len(flags[i * i :: i])
    return [i for i, f in enumerate(flags) if f]


SMALL_PRIMES = _sieve(1 << 16)
_SMALL_SET = set(SMALL_PRIMES)


def trial_division_ok(n: int, bound: int = 1 << 16) -> bool:
    for p in SMALL_PRIMES:
        if p * p > n or p >= bound:
            return True
        if n % p == 0:
            return n == p
    return True


def prime_prod(bits: int) -> int:
    """Product of the smallest primes totalling ~``bits`` bits
    (``maurer.cc:758``: the gdsa sieve modulus)."""
    prod = 1
    for p in SMALL_PRIMES:
        if prod.bit_length() >= bits:
            break
        prod *= p
    return prod


def _pocklington(p: int, q: int, rng: random.Random) -> bool:
    """Provable primality of p given prime q | p-1 with q^2 > p."""
    for _ in range(64):
        a = rng.randrange(2, p - 1)
        if pow(a, p - 1, p) != 1:
            return False
        d = math.gcd(pow(a, (p - 1) // q, p) - 1, p)
        if d == 1:
            return True
        if d != p:
            return False
    return False


def maurer(k: int, rng: random.Random | None = None) -> int:
    """Random provable k-bit prime (Maurer's recursive method)."""
    rng = rng or random.Random()
    if k <= 20:
        # Small enough: trial division up to sqrt is a proof.
        while True:
            n = rng.randrange(1 << (k - 1), 1 << k) | 1
            if n < 4:
                return 3 if k >= 2 else 2
            if all(n % p for p in SMALL_PRIMES if p * p <= n):
                return n
    # Relative size 1/2 keeps q^2 > p so Pocklington certifies.
    q = maurer((k + 1) // 2 + 1, rng)
    lo = (1 << (k - 1)) // (2 * q)
    while True:
        R = rng.randrange(lo + 1, 2 * lo + 1)
        p = 2 * R * q + 1
        if p.bit_length() != k:
            continue
        if not trial_division_ok(p, 1 << 12):
            continue
        if pow(2, p - 1, p) != 1:  # cheap Fermat prefilter
            continue
        if _pocklington(p, q, rng):
            return p
