"""Batched multi-precision Montgomery arithmetic mod an odd n: the plain
PyTorch version of the DGK back-end's exponentiations.

Counterpart of ``pplp_tpu.dgk.modexp`` in its layout: a number is a row of
D 16-bit digits, little-endian, in an int64 tensor [B, D] (this torch has
no ``>>``, ``<`` or ``%`` on uint32), D = ceil(bits(n) / 16) + 1 and
R = 2^(16 D). Every value, the Montgomery-domain ones included, therefore
equals the JAX package's.

The product is not the reference's CIOS scan, one digit step at a time
(``D`` x ~12 array operations, ~1,500 launches at k = 2048): it forms the
whole of REDC at once, about a hundred tensor operations whatever D is:

    T = a b                      (column sums of digit products, < 2^45)
    m = (T mod R) (-n^-1) mod R
    U = (T + m n) / R < 2n,      then U - n where U >= n.

``_carry`` turns column sums into digits: four passes of shifting each
column's carry up by one leave every column at most 2^16, and the last
carries (0 or 1) run through columns of 0xFFFF by a carry look-ahead
(``cummax`` over the columns that stop a carry).

On a CUDA tensor the DGK back-end sends every product and exponentiation
to the hand-written kernel (``ops/dgk_cuda.py``, ``csrc/dgk_mont.cu``); this
module is that kernel's plain version and the CPU path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["MontgomeryCtx", "to_digits", "from_digits", "exp_to_bits", "DIGIT_BITS"]

DIGIT_BITS = 16
MASK = (1 << DIGIT_BITS) - 1
_CARRY_PASSES = 4  # columns below 2^62 -> at most 2^16 after four passes


def to_digits(values, D: int, device=None) -> torch.Tensor:
    """Python ints (each below 2^(16 D)) -> [B, D] int64 of 16-bit digits."""
    vals = [int(v) for v in np.atleast_1d(np.asarray(values, dtype=object))]
    buf = b"".join(v.to_bytes(2 * D, "little") for v in vals)
    digs = np.frombuffer(buf, "<u2").reshape(len(vals), D).astype(np.int64)
    return torch.from_numpy(digs).to(device or "cpu")


def from_digits(digs) -> list[int]:
    """[B, D] 16-bit digits (a tensor or array) -> Python ints."""
    if torch.is_tensor(digs):
        digs = digs.detach().cpu().numpy()
    rows = np.ascontiguousarray(np.asarray(digs).astype("<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in rows.reshape(-1, rows.shape[-1])]


def exp_to_bits(exps, E: int) -> torch.Tensor:
    """Python ints -> [B, E] int64 of 0/1, little-endian (bits past E dropped)."""
    vals = [int(v) & ((1 << E) - 1) for v in np.atleast_1d(np.asarray(exps, dtype=object))]
    nbytes = (E + 7) // 8
    raw = np.frombuffer(b"".join(v.to_bytes(nbytes, "little") for v in vals), np.uint8)
    bits = np.unpackbits(raw.reshape(len(vals), nbytes), axis=1, bitorder="little")[:, :E]
    return torch.from_numpy(bits.astype(np.int64))


def _carry(t: torch.Tensor):
    """Non-negative int64 column sums [..., C] (< 2^62) -> (16-bit digits
    [..., C] of the same value mod 2^(16 C), the carry out of the top)."""
    top = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
    for _ in range(_CARRY_PASSES):
        c = t >> DIGIT_BITS
        t = t & MASK
        t[..., 1:] += c[..., :-1]
        top += c[..., -1]
    # Columns are now <= 2^16: a column generates a carry at 2^16 and passes
    # one on at 0xFFFF. A column's carry in is what the nearest column below
    # it that does not pass carries on generates.
    gen = t > MASK
    stop = gen | (t != MASK)
    cols = torch.arange(t.shape[-1], device=t.device).expand_as(t)
    last = torch.cummax(torch.where(stop, cols, -1), dim=-1).values
    below = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)
    cin = torch.gather(gen, -1, below.clamp(min=0)) & (below >= 0)
    t = t + cin
    return t & MASK, top + (t[..., -1] >> DIGIT_BITS)


@dataclass(frozen=True, eq=False)
class MontgomeryCtx:
    """Montgomery arithmetic mod an odd n, digit base 2^16, R = 2^(16 D)."""

    n_int: int
    D: int
    n: torch.Tensor         # [D] digits
    r2: torch.Tensor        # [D]: R^2 mod n (the to_mont multiplier)
    one_mont: torch.Tensor  # [D]: R mod n
    n_neg_inv: torch.Tensor  # [D]: -n^-1 mod R (REDC's multiplier)
    n_comp: torch.Tensor    # [D]: R - n (subtracting n is adding this mod R)
    unit: torch.Tensor      # [D]: 1 (the from_mont multiplier)
    conv_index: torch.Tensor  # [D * D]: i + j of digit product (i, j)

    @staticmethod
    def build(n: int, *, device) -> "MontgomeryCtx":
        assert n % 2 == 1
        D = (n.bit_length() + DIGIT_BITS - 1) // DIGIT_BITS + 1
        R = 1 << (DIGIT_BITS * D)
        dev = torch.device(device)

        def digits(v):
            return to_digits([v], D, dev)[0]

        ij = torch.arange(D)
        return MontgomeryCtx(
            n_int=n, D=D, n=digits(n), r2=digits(R * R % n), one_mont=digits(R % n),
            n_neg_inv=digits((-pow(n, -1, R)) % R), n_comp=digits(R - n), unit=digits(1),
            conv_index=(ij[:, None] + ij[None, :]).reshape(-1).to(dev),
        )

    @property
    def device(self) -> torch.device:
        return self.n.device

    def _conv(self, a, b):
        """Column sums of the digit products: [..., D] x [..., D] -> [..., 2D]
        (each column below D 2^32)."""
        prod = a.unsqueeze(-1) * b.unsqueeze(-2)
        prod = prod.reshape(prod.shape[:-2] + (-1,))
        out = torch.zeros(prod.shape[:-1] + (2 * self.D,), dtype=torch.int64, device=prod.device)
        return out.scatter_add_(-1, self.conv_index.expand_as(prod), prod)

    def mont_mul(self, a, b):
        """Montgomery product a b R^-1 mod n: [B or 1, D] x [B or 1, D] ->
        [B, D]. Inputs below n; the output is canonical, in [0, n)."""
        D = self.D
        t, _ = _carry(self._conv(a, b))
        m, _ = _carry(self._conv(t[..., :D], self.n_neg_inv)[..., :D])
        u, _ = _carry(t + self._conv(m, self.n))
        res = u[..., D:]  # (T + m n) / R < 2n
        diff, ge = _carry(res + self.n_comp)  # res - n + R: carries out iff res >= n
        return torch.where((ge > 0).unsqueeze(-1), diff, res)

    def to_mont(self, a):
        return self.mont_mul(a, self.r2)

    def from_mont(self, a):
        return self.mont_mul(a, self.unit)

    def powmod(self, base, exp_bits):
        """base^exp mod n, batched.

        base: [B or 1, D] digits (standard domain); exp_bits: [B, E] of 0/1,
        little-endian. Returns [B, D] in the standard domain."""
        exp_bits = exp_bits.to(self.device)
        base_m = self.to_mont(base)
        acc = self.one_mont.expand(exp_bits.shape[0], self.D)
        for i in range(exp_bits.shape[-1]):
            acc = torch.where((exp_bits[:, i] != 0).unsqueeze(-1), self.mont_mul(acc, base_m), acc)
            if i + 1 < exp_bits.shape[-1]:
                base_m = self.mont_mul(base_m, base_m)
        return self.from_mont(acc)

    def powmod_shared_exp_mont(self, base_m, exp: int):
        """base^exp for Montgomery-domain bases and one Python-int exponent
        (left to right: a square per bit, a product per set bit after the
        top one); the result stays in the Montgomery domain."""
        assert exp >= 0
        if exp == 0:
            return self.one_mont.expand(base_m.shape)
        acc = base_m
        for bit in bin(exp)[3:]:
            acc = self.mont_mul(acc, acc)
            if bit == "1":
                acc = self.mont_mul(acc, base_m)
        return acc

    def powmod_shared_exp(self, base, exp: int):
        """base^exp mod n for per-lane bases and one shared Python-int
        exponent (standard domain in and out)."""
        return self.from_mont(self.powmod_shared_exp_mont(self.to_mont(base), exp))

    def mulmod(self, a, b):
        """a b mod n for digit arrays (standard domain)."""
        return self.mont_mul(self.to_mont(a), b)
