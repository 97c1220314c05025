"""Modular arithmetic mod q < 2^30 on int64 tensors (the ``m31`` profile).

Counterpart of ``pplp_tpu.ops.modmath.m31``. A residue is an int64 tensor
holding a value below 2^32; ``q`` and the Shoup companions broadcast
against it. Every result equals the reference's u32 result on the same
residues.

int64 is exact for what m31 needs with one exception: a Shoup estimate
``w_shoup * x`` with both operands below 2^32 reaches 2^64. ``mulhi32``
forms that high word from 16-bit halves of the first operand, so no
intermediate passes 2^49.

The 16-bit comba products and multi-limb helpers of the reference exist
because the TPU has no 64-bit multiplier; they are not needed here.
"""

from __future__ import annotations

import torch

__all__ = ["M32", "mul32", "mulhi32", "shoup_ints", "m31"]

M32 = 0xFFFFFFFF
_U16 = 0xFFFF


def mul32(a, b):
    """Full product of two values below 2^32 as (lo, hi) 32-bit words."""
    p0 = (a & _U16) * b  # < 2^48
    p1 = (a >> 16) * b  # < 2^48
    mid = p0 + ((p1 & _U16) << 16)  # < 2^49
    return mid & M32, (mid >> 32) + (p1 >> 16)


def mulhi32(a, b):
    """High 32 bits of the product of two values below 2^32."""
    return mul32(a, b)[1]


def shoup_ints(vals, qs):
    """Host constants: (w mod q, floor((w mod q) * 2^32 / q)) per modulus q,
    as two lists of Python ints."""
    w = [int(v) % q for v, q in zip(vals, qs)]
    return w, [(v << 32) // q for v, q in zip(w, qs)]


class m31:
    """Vector ops mod q < 2^30. Results are canonical in [0, q) unless the
    name says lazy."""

    @staticmethod
    def add(x, y, q):
        s = x + y
        return s - torch.where(s >= q, q, 0)

    @staticmethod
    def sub(x, y, q):
        return torch.where(x >= y, x - y, x + q - y)

    @staticmethod
    def neg(x, q):
        return torch.where(x == 0, x, q - x)

    @staticmethod
    def csub(x, q):
        """Map [0, 2q) -> [0, q)."""
        return x - torch.where(x >= q, q, 0)

    @staticmethod
    def csub2q(x, two_q):
        """Map [0, 4q) -> [0, 2q) (Harvey lazy normalization step)."""
        return x - torch.where(x >= two_q, two_q, 0)

    @staticmethod
    def lazy_add(x, y):
        """Raw add without reduction (caller keeps the sum below 2^32)."""
        return x + y

    @staticmethod
    def lazy_sub2q(x, y, two_q):
        """x - y + 2q without reduction (x, y < 2q -> result < 4q)."""
        return x + two_q - y

    @staticmethod
    def mulmod_shoup_lazy(x, w, w_shoup, q):
        """x * w mod q in [0, 2q), w_shoup = floor(w * 2^32 / q).

        Valid for any x < 2^32 (Harvey butterflies feed x < 4q). The
        difference is exact: its true value lies in [0, 2q)."""
        return w * x - mulhi32(w_shoup, x) * q

    @staticmethod
    def mulmod_shoup(x, w, w_shoup, q):
        """x * w mod q, canonical."""
        return m31.csub(m31.mulmod_shoup_lazy(x, w, w_shoup, q), q)

    @staticmethod
    def reduce64(lo, hi, q):
        """(hi * 2^32 + lo) mod q for 32-bit words lo, hi.

        (hi mod q) * (2^32 mod q) < 2^60, so every step is exact in int64."""
        return ((hi % q) * ((1 << 32) % q) + lo) % q

    @staticmethod
    def mulmod(x, y, q):
        """General x * y mod q for x, y < 2^32 (both operands variable)."""
        return ((x % q) * (y % q)) % q

    @staticmethod
    def shoup_precompute(w, q):
        """floor(w * 2^32 / q) for w in [0, q)."""
        return torch.div(w << 32, q, rounding_mode="floor")
