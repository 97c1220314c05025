"""DSA-style prime search: p = r*q + 1 with q | p-1 (reference C16,
``src/test/dgk/src/gdsa.cc:55-98``) using the multiplicative c-walk over a
small-prime product so every candidate is automatically coprime to all small
primes.

Copy of ``pplp_tpu.dgk.gdsa`` on the port's own ``ops.primes.is_prime``.
"""

from __future__ import annotations

import math
import random

from ..ops.primes import is_prime
from .maurer import prime_prod

__all__ = ["gdsa_prime", "get_invertible_num"]


def get_invertible_num(mod: int, rng: random.Random) -> int:
    while True:
        v = rng.randrange(1, mod)
        if math.gcd(v, mod) == 1:
            return v


def gdsa_prime(q: int, numbits: int, rng: random.Random) -> int:
    """Prime p of ~numbits bits with q | p-1."""
    q_size = q.bit_length()
    pprod = prime_prod(numbits - q_size)
    q_inv = pow(q, -1, pprod)
    q_min = pprod - q_inv  # -q^{-1} mod pprod
    a = get_invertible_num(pprod, rng)
    c = get_invertible_num(pprod, rng)
    while True:
        r = (q_min + c) % pprod
        p = r * q + 1
        c = (a * c) % pprod
        if p.bit_length() < numbits - 1:
            continue
        if is_prime(p):
            return p
