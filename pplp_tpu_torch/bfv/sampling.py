"""RLWE sampling from ``torch.Generator`` random words.

Counterpart of ``pplp_tpu.bfv.sampling``. Each sampler draws uniform 32-bit
words and hands them to its ``*_from_bits`` form, which applies the
reference's exact mapping from words to samples: given the words that
``jax.random.bits`` drew for a key, ``uniform_rq_from_bits`` and the others
return what the reference sampler returns for that key. The port does not
reproduce threefry itself; tests inject the same words into both.

Shapes of the words: uniform ``[*batch, 2, L, n]`` on m31 and
``[*batch, 4, L, n]`` on m62 (a 128-bit value reduced mod q_i, as the
reference draws it), ternary ``[*batch, n]``, CBD ``[*batch, 2, n]``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["uniform_rq", "ternary_poly", "cbd_poly", "uniform_rq_from_bits",
           "ternary_poly_from_bits", "cbd_poly_from_bits", "lift_small", "lift_signed",
           "words"]

_CBD_MASK = (1 << 21) - 1  # CBD(21): sigma = sqrt(21/2) ~ 3.24


def words(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit words (int64) of ``shape``: what every sampler draws."""
    return torch.randint(0, 1 << 32, tuple(shape), generator=generator,
                         device=device, dtype=torch.int64)


def _as_words(bits, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(bits, dtype=np.int64), device=device)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def lift_small(mag: torch.Tensor, is_neg: torch.Tensor, ctx) -> torch.Tensor:
    """Lift |x| < 2^30 with sign into every RNS limb: [*batch, L, n]."""
    pos = mag.unsqueeze(-2).expand(mag.shape[:-1] + (ctx.L, ctx.n))
    return torch.where(is_neg.unsqueeze(-2), ctx.prof.neg(pos, ctx.q2), pos)


def lift_signed(values, ctx) -> torch.Tensor:
    """Host signed integers [*batch, n] (|x| < 2^30) -> residues on device."""
    v = torch.as_tensor(np.asarray(values, dtype=np.int64), device=ctx.device)
    return lift_small(v.abs(), v < 0, ctx)


def uniform_rq_from_bits(bits, ctx) -> torch.Tensor:
    """Uniform element of R_q from words [*batch, 2, L, n] (m31: (hi:lo)
    mod q_i) or [*batch, 4, L, n] (m62: the 128-bit value mod q_i)."""
    b = bits if torch.is_tensor(bits) else _as_words(bits, ctx.device)
    p = ctx.prof
    return p.reduce_words(tuple(b[..., i, :, :] for i in range(p.uniform_words)), ctx.q2)


def ternary_poly_from_bits(bits, ctx) -> torch.Tensor:
    """Ternary {-1, 0, 1} polynomial from words [*batch, n]: w % 3, 2 -> -1."""
    b = bits if torch.is_tensor(bits) else _as_words(bits, ctx.device)
    r = b % 3
    return lift_small(torch.where(r == 2, 1, r), r == 2, ctx)


def cbd_poly_from_bits(bits, ctx) -> torch.Tensor:
    """CBD(21) noise from words [*batch, 2, n]: popcount(a) - popcount(b)."""
    b = bits if torch.is_tensor(bits) else _as_words(bits, ctx.device)
    counts = _popcount32(b & _CBD_MASK)  # both words' in one pass
    a, c = counts[..., 0, :], counts[..., 1, :]
    return lift_small((a - c).abs(), a < c, ctx)


def uniform_rq(generator: torch.Generator, ctx, batch=()) -> torch.Tensor:
    """Uniform element of R_q: independent residues [*batch, L, n]."""
    return uniform_rq_from_bits(
        words(generator, tuple(batch) + (ctx.prof.uniform_words, ctx.L, ctx.n),
               ctx.device), ctx)


def ternary_poly(generator: torch.Generator, ctx, batch=()) -> torch.Tensor:
    """Uniform ternary polynomial, lifted to all limbs."""
    return ternary_poly_from_bits(
        words(generator, tuple(batch) + (ctx.n,), ctx.device), ctx)


def cbd_poly(generator: torch.Generator, ctx, batch=()) -> torch.Tensor:
    """Centered binomial noise CBD(21), lifted to all limbs."""
    return cbd_poly_from_bits(
        words(generator, tuple(batch) + (2, ctx.n), ctx.device), ctx)
