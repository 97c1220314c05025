"""Pohlig–Hellman discrete log in smooth-order groups (reference C17,
``src/test/dgk/src/ph.{h,cc}``: baby-step/giant-step + CRT; the alternative
DGK decryption path that avoids the u-entry table).

Self-tested the way the reference is (``ph.h:88-96`` test_* functions):
see ``tests/test_dgk.py``.

Copy of ``pplp_tpu.dgk.ph``.
"""

from __future__ import annotations

import math

__all__ = ["factorize", "bsgs", "pohlig_hellman", "crt_solve"]


def factorize(m: int) -> dict[int, int]:
    """Prime factorization by trial division (orders here are smooth)."""
    out: dict[int, int] = {}
    d = 2
    while d * d <= m:
        while m % d == 0:
            out[d] = out.get(d, 0) + 1
            m //= d
        d += 1 if d == 2 else 2
    if m > 1:
        out[m] = out.get(m, 0) + 1
    return out


def bsgs(g: int, h: int, p: int, order: int) -> int:
    """x with g^x = h (mod p), 0 <= x < order. Baby-step giant-step."""
    m = math.isqrt(order - 1) + 1
    table = {}
    e = 1
    for j in range(m):
        table.setdefault(e, j)
        e = e * g % p
    factor = pow(g, -m, p)
    gamma = h % p
    for i in range(m):
        if gamma in table:
            return (i * m + table[gamma]) % order
        gamma = gamma * factor % p
    raise ValueError("dlog not found (h not in <g>?)")


def crt_solve(residues: list[int], moduli: list[int]) -> int:
    """x = r_i mod m_i (pairwise coprime) -> x mod prod(m_i)
    (``solve_congruences`` equivalent)."""
    M = 1
    for m in moduli:
        M *= m
    x = 0
    for r, m in zip(residues, moduli):
        Mi = M // m
        x += r * Mi * pow(Mi, -1, m)
    return x % M


def pohlig_hellman(g: int, h: int, p: int, order: int) -> int:
    """dlog of h base g where g has smooth ``order`` in Z_p^*."""
    residues, moduli = [], []
    for q, e in factorize(order).items():
        qe = q**e
        g_i = pow(g, order // qe, p)
        h_i = pow(h, order // qe, p)
        # Lift digit by digit through the q-adic expansion.
        x = 0
        g_base = pow(g_i, qe // q, p)  # order q
        for j in range(e):
            h_j = pow(h_i * pow(g_i, -x, p) % p, qe // (q ** (j + 1)), p)
            d = bsgs(g_base, h_j, p, q)
            x += d * (q**j)
        residues.append(x)
        moduli.append(qe)
    return crt_solve(residues, moduli)
