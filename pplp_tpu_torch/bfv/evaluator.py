"""Homomorphic evaluation: add/sub/negate, plain add/sub/multiply, ct x ct
multiply and relinearization, NTT-domain chaining, modulus switching.

Counterpart of ``pplp_tpu.bfv.evaluator``. Every op is exact modular ring
arithmetic and the NTT is a ring isomorphism, so a chained expression can
transform each operand once, combine in the spectrum and transform back
once, bit-identical to the op-by-op coefficient-domain chain.

Every op runs on both residue profiles (through ``ctx.prof``).
``multiply``, ``relinearize`` and ``multiply_relinearize`` run the BEHZ
multiply with RNS-gadget keys (``bfv.behz``): on a CUDA context through the
hand-written kernels of its profile (``bfv.behz_fused.FusedMultiplier``),
on a CPU context through the plain version. ``relinearize`` with
special-prime keys goes to ``keyswitch.sp_relinearize``.
"""

from __future__ import annotations

import torch

from ..ops import ntt
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import SecretKey, shoup
from .plaintext import Plaintext
from .rescale import make_divide_round_last

__all__ = ["Evaluator", "mod_switch_to_next", "restrict_secret_key"]


class Evaluator:
    def __init__(self, ctx: BFVContext):
        self.ctx = ctx
        self._fused = None  # FusedMultiplier of the last keys used

    # -- ct (+|-) ct ----------------------------------------------------

    def _zip(self, a: Ciphertext, b: Ciphertext, subtract: bool) -> Ciphertext:
        assert a.domain == b.domain
        p, q2 = self.ctx.prof, self.ctx.q2
        fn = p.sub if subtract else p.add
        polys = []
        for i in range(max(a.size, b.size)):
            if i >= a.size:
                polys.append(p.neg(b.polys[i], q2) if subtract else b.polys[i])
            elif i >= b.size:
                polys.append(a.polys[i])
            else:
                polys.append(fn(a.polys[i], b.polys[i], q2))
        return Ciphertext(tuple(polys), a.domain)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._zip(a, b, subtract=False)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._zip(a, b, subtract=True)

    def negate(self, a: Ciphertext) -> Ciphertext:
        p, q2 = self.ctx.prof, self.ctx.q2
        return Ciphertext(tuple(p.neg(c, q2) for c in a.polys), a.domain)

    def add_many(self, cts) -> Ciphertext:
        """Tree sum of ciphertexts, pairwise level by level (the reference's
        order, so sizes and domains combine as there)."""
        cts = list(cts)
        if not cts:
            raise ValueError("add_many of no ciphertexts")
        while len(cts) > 1:
            cts = [self.add(cts[i], cts[i + 1]) if i + 1 < len(cts) else cts[i]
                   for i in range(0, len(cts), 2)]
        return cts[0]

    # -- ct * ct ----------------------------------------------------------

    def _multiplier(self, keys=None):
        from .behz_fused import FusedMultiplier

        if self._fused is None or self._fused.rlk is not keys:
            self._fused = FusedMultiplier(self.ctx, keys)
        return self._fused

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """BEHZ full-RNS multiply (size-3 result; relinearize to shrink)."""
        fused = self._fused if self._fused is not None else self._multiplier()
        return fused.multiply(a, b)

    def relinearize(self, ct: Ciphertext, keys) -> Ciphertext:
        """Size 3 -> size 2, dispatched on the key type: RNS-gadget keys
        (``behz.KSwitchKeys``) or special-prime ones (``keyswitch.SPKeys``)."""
        from .keyswitch import SPKeys, sp_relinearize

        if isinstance(keys, SPKeys):
            return sp_relinearize(self.ctx, ct, keys)
        return self._multiplier(keys).relinearize(ct)

    def multiply_relinearize(self, a: Ciphertext, b: Ciphertext, keys) -> Ciphertext:
        """``relinearize(multiply(a, b), keys)``."""
        return self._multiplier(keys).multiply_relinearize(a, b)

    # -- ct (+) plain ---------------------------------------------------

    def _plain_pairs(self, plain):
        if isinstance(plain, Plaintext):
            return plain.pair_u32(self.ctx.n)
        return plain  # already host (lo, hi) arrays

    def _plain_term(self, a: Ciphertext, plain, fn) -> Ciphertext:
        """fn(c0, round(q m / t)) with the other components unchanged."""
        if a.domain != "coeff":
            raise ValueError("plain add/sub takes a coefficient-domain ciphertext")
        term = self.ctx.scale_plain(*self._plain_pairs(plain))
        return Ciphertext((fn(a.polys[0], term, self.ctx.q2),) + a.polys[1:], a.domain)

    def add_plain(self, a: Ciphertext, plain) -> Ciphertext:
        return self._plain_term(a, plain, self.ctx.prof.add)

    def sub_plain(self, a: Ciphertext, plain) -> Ciphertext:
        return self._plain_term(a, plain, self.ctx.prof.sub)

    # -- ct * plain -----------------------------------------------------

    def multiply_plain(self, a: Ciphertext, plain) -> Ciphertext:
        """a * m for an unscaled plaintext polynomial (centered lift)."""
        m_ntt, m_shoup = self.plain_spectrum(plain)
        return self.from_ntt(self.multiply_plain_ntt(self.to_ntt(a), (m_ntt, m_shoup)))

    def plain_spectrum(self, plain):
        """Plaintext -> (m_ntt, m_shoup); a leading batch transforms at once."""
        ctx = self.ctx
        m_rq = ctx.lift_plain_centered(*self._plain_pairs(plain))
        m_ntt = ntt.forward(m_rq, ctx.tables)
        return m_ntt, shoup(ctx, m_ntt)

    def to_ntt(self, a: Ciphertext) -> Ciphertext:
        """Transform all components in one stacked NTT."""
        assert a.domain == "coeff"
        spec = ntt.forward(torch.stack(a.polys), self.ctx.tables)
        return Ciphertext(tuple(spec.unbind(0)), "ntt")

    def from_ntt(self, a: Ciphertext) -> Ciphertext:
        assert a.domain == "ntt"
        coeff = ntt.inverse(torch.stack(a.polys), self.ctx.tables)
        return Ciphertext(tuple(coeff.unbind(0)), "coeff")

    def multiply_plain_ntt(self, a: Ciphertext, spectrum) -> Ciphertext:
        """Pointwise ct * plain with both already in the NTT domain."""
        assert a.domain == "ntt"
        m_ntt, m_shoup = spectrum
        p, q2 = self.ctx.prof, self.ctx.q2
        return Ciphertext(
            tuple(p.mulmod_shoup(c, m_ntt, m_shoup, q2) for c in a.polys), "ntt")


def mod_switch_to_next(ctx: BFVContext, ct: Ciphertext):
    """Drop the last prime of the chain: x -> round(x / q_last) per component.

    Returns (the smaller context, the switched ciphertext); decrypt with the
    secret key restricted to the head limbs (``restrict_secret_key``)."""
    if ctx.L < 2:
        raise ValueError("nothing left to switch: the chain has one prime")
    if ct.domain != "coeff":
        raise ValueError("mod_switch_to_next takes a coefficient-domain ciphertext")
    new_ctx = BFVContext.build(
        ctx.parms.with_coeff_modulus(ctx.parms.coeff_modulus[:-1]), ctx.device)
    one_poly = make_divide_round_last(new_ctx, ctx.moduli[-1].value, ctx.L)
    return new_ctx, Ciphertext(tuple(one_poly(p) for p in ct.polys), "coeff")


def restrict_secret_key(ctx_small: BFVContext, sk):
    """Project a secret key onto a context with fewer (head) limbs; the
    Shoup companions are recomputed over the smaller chain (``keys.shoup``,
    64-bit on m62)."""
    s = sk.s_ntt[..., : ctx_small.L, :]
    return SecretKey(s_ntt=s, s_shoup=shoup(ctx_small, s))
