"""Public-key BFV encryption.

c0 = pk0*u + e0 + round(q*m/t),  c1 = pk1*u + e1   (u ternary, e CBD noise)

Counterpart of ``pplp_tpu.bfv.encryptor``. The pk products run in the NTT
domain with Shoup companions; the message scaling is ``scale_plain``.
"""

from __future__ import annotations

import torch

from ..ops import ntt
from . import sampling
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import PublicKey
from .plaintext import Plaintext

__all__ = ["Encryptor"]


class Encryptor:
    def __init__(self, ctx: BFVContext, pk: PublicKey):
        self.ctx = ctx
        self.pk = pk

    def encrypt_pairs(self, m_lo, m_hi, generator: torch.Generator) -> Ciphertext:
        """Encrypt host plaintext coefficient pairs (u32 lo/hi, [..., n]) mod t;
        a leading batch of messages encrypts in one pass."""
        ctx = self.ctx
        batch = tuple(m_lo.shape[:-1])
        u = sampling.ternary_poly(generator, ctx, batch)
        e0 = sampling.cbd_poly(generator, ctx, batch)
        e1 = sampling.cbd_poly(generator, ctx, batch)
        return self.assemble(m_lo, m_hi, u, e0, e1)

    def encrypt_pairs_from_bits(self, m_lo, m_hi, u_bits, e0_bits, e1_bits) -> Ciphertext:
        """``encrypt_pairs`` with the samplers' words injected (ternary words
        [..., n], CBD words [..., 2, n]): given the words the reference's
        ``encrypt_pairs`` drew, the same ciphertext."""
        ctx = self.ctx
        return self.assemble(m_lo, m_hi, sampling.ternary_poly_from_bits(u_bits, ctx),
                             sampling.cbd_poly_from_bits(e0_bits, ctx),
                             sampling.cbd_poly_from_bits(e1_bits, ctx))

    def encrypt_with_randomness(self, plain: Plaintext, u, e0, e1) -> Ciphertext:
        """Encrypt with injected coefficient-domain residues u, e0, e1
        [L, n] (the known-answer hook)."""
        plain.validate_for(self.ctx)
        m_lo, m_hi = plain.pair_u32(self.ctx.n)
        return self.assemble(m_lo, m_hi, u, e0, e1)

    def assemble(self, m_lo, m_hi, u, e0, e1) -> Ciphertext:
        ctx, pk = self.ctx, self.pk
        p, q2 = ctx.prof, ctx.q2
        u_ntt = ntt.forward(u, ctx.tables)
        prods = torch.stack([
            p.mulmod_shoup(u_ntt, pk.pk0_ntt, pk.pk0_shoup, q2),
            p.mulmod_shoup(u_ntt, pk.pk1_ntt, pk.pk1_shoup, q2),
        ])
        c0, c1 = ntt.inverse(prods, ctx.tables)
        scaled_m = ctx.scale_plain(m_lo, m_hi)
        c0 = p.add(p.add(c0, e0, q2), scaled_m, q2)
        c1 = p.add(c1, e1, q2)
        return Ciphertext(polys=(c0, c1), domain="coeff")

    def encrypt(self, plain: Plaintext, generator: torch.Generator) -> Ciphertext:
        plain.validate_for(self.ctx)
        m_lo, m_hi = plain.pair_u32(self.ctx.n)
        return self.encrypt_pairs(m_lo, m_hi, generator)
