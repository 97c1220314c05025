"""Modular arithmetic on int64 tensors: ``m31`` (q < 2^30) and ``m62``
(2^32 <= q < 2^62).

Counterpart of ``pplp_tpu.ops.modmath``. A residue is one int64 tensor in
both profiles (the reference holds an m62 residue as a (lo, hi) u32 pair);
``q`` and the Shoup companions broadcast against it. Every canonical result
equals the reference's on the same residues.

m31: int64 is exact for what it needs with one exception: a Shoup estimate
``w_shoup * x`` with both operands below 2^32 reaches 2^64. ``mulhi32``
forms that high word from 16-bit halves of the first operand, so no
intermediate passes 2^49.

m62: a 64 x 64-bit product needs 128 bits. It is built from 32-bit words,
each 32 x 32-bit product from ``mul32``'s 16-bit halves, so no intermediate
wraps int64. A Shoup companion floor(w * 2^64 / q) can reach 2^64 - 1; it is
stored as the int64 with the same bit pattern and read back as two words.
2q < 2^63 fits int64 but 4q does not, so code on these tensors keeps every
residue below 2q (only the CUDA kernel, in u64, runs Harvey-lazy to 4q).
"""

from __future__ import annotations

import torch

__all__ = ["M32", "mul32", "mulhi32", "shoup_ints", "as_int64_bits", "m31", "m62"]

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


def shoup_ints(vals, qs, bits: int = 32):
    """Host constants: (w mod q, floor((w mod q) * 2^bits / q)) per modulus
    q, as two lists of Python ints. ``bits`` is the profile's
    ``shoup_bits``: 64-bit companions come as int64 bit patterns."""
    w = [int(v) % q for v, q in zip(vals, qs)]
    return w, [as_int64_bits((v << bits) // q) for v, q in zip(w, qs)]


def as_int64_bits(v: int) -> int:
    """A value below 2^64 as the int64 with the same bit pattern."""
    return v - (1 << 64) if v >= 1 << 63 else v


class m31:
    """Vector ops mod q < 2^30. Results are canonical in [0, q) unless the
    name says lazy."""

    shoup_bits = 32  # Shoup companions floor(w * 2^32 / q)
    uniform_words = 2  # 32-bit words per uniform residue draw

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
    def reduce_words(z, q):
        """z mod q for a 64-bit z given as 32-bit words (lo, hi)."""
        return m31.reduce64(z[0], z[1], q)

    @staticmethod
    def mulmod(x, y, q):
        """General x * y mod q for x, y < 2^32 (both operands variable)."""
        return ((x % q) * (y % q)) % q

    @staticmethod
    def shoup_precompute(w, q):
        """floor(w * 2^32 / q) for w in [0, q)."""
        return torch.div(w << 32, q, rounding_mode="floor")


# ---------------------------------------------------------------------------
# m62: 2^32 <= q < 2^62, one int64 per residue.
# ---------------------------------------------------------------------------


def _words(x):
    """A 64-bit pattern (int64 tensor or non-negative int) -> (lo, hi) words."""
    return x & M32, (x >> 32) & M32


def _join(lo, hi):
    """(lo, hi) 32-bit words -> the int64 holding the same 64 bits."""
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def _mullo32(a, b):
    """(a * b) mod 2^32 for a, b < 2^32."""
    return ((a & _U16) * b + ((((a >> 16) * b) & _U16) << 16)) & M32


def _mul_words(a, b) -> list:
    """Exact product of little-endian 32-bit word lists -> len(a)+len(b) words.

    Each column sums at most 2 * min(len(a), len(b)) words below 2^32."""
    cols = [0] * (len(a) + len(b))
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            lo, hi = mul32(ai, bj)
            cols[i + j] = cols[i + j] + lo
            cols[i + j + 1] = cols[i + j + 1] + hi
    out, carry = [], 0
    for c in cols:
        v = c + carry
        out.append(v & M32)
        carry = v >> 32
    return out


def _lo64(a, b):
    """(a * b) mod 2^64 of word pairs a, b, as a word pair."""
    lo, hi = mul32(a[0], b[0])
    return lo, (hi + _mullo32(a[0], b[1]) + _mullo32(a[1], b[0])) & M32


def _sub_to_int(a, b):
    """(a - b) mod 2^64 of word pairs, for a true difference in [0, 2^63)."""
    d0 = a[0] - b[0]
    borrow = (d0 < 0).to(torch.int64) if torch.is_tensor(d0) else int(d0 < 0)
    d1 = (a[1] - b[1] - borrow) & M32
    return d1 * (1 << 32) + (d0 & M32)


def _mulhi64(x, y):
    """floor(x * y / 2^64) for 0 <= x < 2^63 and y any 64-bit pattern.

    x1 < 2^31 keeps x1 * y0 and x1 * y1 below 2^63; the x0 products go
    through ``mul32``. The result is below x, so no partial sum wraps."""
    x0, x1 = x & M32, x >> 32
    y0, y1 = _words(y)
    lo01, hi01 = mul32(x0, y1)
    p10 = x1 * y0
    mid = (p10 & M32) + lo01 + mulhi32(x0, y0)
    return x1 * y1 + (p10 >> 32) + hi01 + (mid >> 32)


class m62:
    """Vector ops mod 2^32 <= q < 2^62 on int64 residues. Results are
    canonical in [0, q) unless the name says lazy; no input or result may
    reach 2^63.

    An instance binds ``ratio`` = floor(2^128 / q) as three 32-bit words
    (r0, r1, r2), each broadcasting against the residues (``NttTables.mu_b``),
    so ``reduce_words``, ``mulmod`` and ``shoup_precompute`` take the same
    arguments as m31's; the other ops need no ratio."""

    shoup_bits = 64  # Shoup companions floor(w * 2^64 / q), int64 bit patterns
    uniform_words = 4  # a 128-bit value per uniform residue draw

    def __init__(self, ratio):
        self.ratio = ratio

    @staticmethod
    def add(x, y, q):
        s = x + y  # < 2q < 2^63
        return s - torch.where(s >= q, q, 0)

    @staticmethod
    def sub(x, y, q):
        d = x - y
        return d + torch.where(d < 0, q, 0)

    @staticmethod
    def neg(x, q):
        return torch.where(x == 0, x, q - x)

    @staticmethod
    def csub(x, q):
        """Map [0, 2q) -> [0, q)."""
        return x - torch.where(x >= q, q, 0)

    @staticmethod
    def csub2q(x, two_q):
        """Map [0, min(4q, 2^63)) -> [0, 2q)."""
        return x - torch.where(x >= two_q, two_q, 0)

    @staticmethod
    def lazy_add(x, y):
        """Raw add without reduction (caller keeps the sum below 2^63)."""
        return x + y

    @staticmethod
    def lazy_sub2q(x, y, two_q):
        """x - y + 2q without reduction (x, y < 2q; caller keeps it below 2^63)."""
        return (x - y) + two_q

    @staticmethod
    def mulmod_shoup_lazy(x, w, w_shoup, q):
        """x * w mod q in [0, 2q) for 0 <= x < 2^63, w < q, and
        w_shoup = floor(w * 2^64 / q) as an int64 bit pattern.

        r = (w x - hi64(w_shoup x) q) mod 2^64; its true value lies in
        [0, 2q), so the low 64 bits of both products are enough."""
        est = _mulhi64(x, w_shoup)
        return _sub_to_int(_lo64(_words(x), _words(w)), _lo64(_words(est), _words(q)))

    @staticmethod
    def mulmod_shoup(x, w, w_shoup, q):
        """x * w mod q, canonical."""
        return m62.csub(m62.mulmod_shoup_lazy(x, w, w_shoup, q), q)

    def reduce128(self, z, q):
        """z mod q for a 128-bit z given as four 32-bit words (z0..z3).

        est = floor(z * ratio / 2^128) is floor(z / q) or one less, so
        z - est q lies in [0, 2q): one conditional subtract."""
        prod = _mul_words(list(z), list(self.ratio))  # 7 words
        r = _sub_to_int((z[0], z[1]), _lo64((prod[4], prod[5]), _words(q)))
        return m62.csub(r, q)

    def reduce_words(self, z, q):
        """z mod q for z given as up to four little-endian 32-bit words."""
        return self.reduce128(tuple(z) + (0,) * (4 - len(z)), q)

    def mulmod(self, x, y, q):
        """General x * y mod q (both operands variable, below 2^63)."""
        return self.reduce128(_mul_words(_words(x), _words(y)), q)

    def shoup_precompute(self, w, q):
        """floor(w * 2^64 / q) for w in [0, q), as an int64 bit pattern.

        With z = w 2^64, est = floor(z * ratio / 2^128) = floor(w ratio / 2^64)
        is the quotient or one less (the ``reduce128`` bound), so one
        correction step makes it exact."""
        prod = _mul_words(list(_words(w)), list(self.ratio))
        e0, e1 = prod[2], prod[3]
        r = _sub_to_int((0, 0), _lo64((e0, e1), _words(q)))  # w 2^64 - est q
        e0 = e0 + (r >= q).to(torch.int64)
        e1 = (e1 + (e0 >> 32)) & M32
        return _join(e0 & M32, e1)
