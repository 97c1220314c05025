"""BFV decryption: x = c0 + c1*s (+ c2*s^2 ...) mod q, m = round(t*x/q) mod t.

Counterpart of ``pplp_tpu.bfv.decryptor``. The products with the powers of
s run on the device in the NTT domain; CRT composition and rounding run on
the host over Python ints. A size-3 ciphertext (a product before
relinearization) decrypts with s^2.
"""

from __future__ import annotations

from ..ops import ntt
from ..ops.modmath import m31
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import SecretKey, shoup
from .plaintext import Plaintext

__all__ = ["Decryptor"]


class Decryptor:
    def __init__(self, ctx: BFVContext, sk: SecretKey):
        self.ctx = ctx
        self.sk = sk

    def ct_value_rns(self, a: Ciphertext):
        """Residues of x = sum_i c_i * s^i mod q, [..., L, n] on the device."""
        ctx = self.ctx
        if a.domain != "coeff":
            raise ValueError("decrypt takes a coefficient-domain ciphertext")
        q2 = ctx.q2
        s_pow, s_pow_shoup = self.sk.s_ntt, self.sk.s_shoup
        acc = None
        for i, c in enumerate(a.polys[1:]):
            if i:
                s_pow = m31.mulmod_shoup(s_pow, self.sk.s_ntt, self.sk.s_shoup, q2)
                s_pow_shoup = shoup(ctx, s_pow)
            term = m31.mulmod_shoup(ntt.forward(c, ctx.tables), s_pow, s_pow_shoup, q2)
            acc = term if acc is None else m31.add(acc, term, q2)
        return m31.add(a.polys[0], ntt.inverse(acc, ctx.tables), q2)

    def decrypt(self, a: Ciphertext) -> Plaintext:
        residues = self.ct_value_rns(a).cpu().numpy()
        return Plaintext(self.ctx.decode_plain_from_ct_value(residues))
