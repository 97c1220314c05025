"""BFV decryption: x = c0 + c1*s mod q, m = round(t*x/q) mod t.

Counterpart of ``pplp_tpu.bfv.decryptor`` for size-2 ciphertexts (the
protocol never multiplies ciphertexts). The product with s runs on the
device in the NTT domain; CRT composition and rounding run on the host over
Python ints.
"""

from __future__ import annotations

from ..ops import ntt
from ..ops.modmath import m31
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import SecretKey
from .plaintext import Plaintext

__all__ = ["Decryptor"]


class Decryptor:
    def __init__(self, ctx: BFVContext, sk: SecretKey):
        self.ctx = ctx
        self.sk = sk

    def ct_value_rns(self, a: Ciphertext):
        """Residues of x = c0 + c1 * s mod q, [..., L, n] on the device."""
        ctx = self.ctx
        assert a.domain == "coeff"
        if a.size != 2:
            raise NotImplementedError("only size-2 ciphertexts decrypt here")
        q2 = ctx.q2
        c_ntt = ntt.forward(a.polys[1], ctx.tables)
        term = m31.mulmod_shoup(c_ntt, self.sk.s_ntt, self.sk.s_shoup, q2)
        return m31.add(a.polys[0], ntt.inverse(term, ctx.tables), q2)

    def decrypt(self, a: Ciphertext) -> Plaintext:
        residues = self.ct_value_rns(a).cpu().numpy()
        return Plaintext(self.ctx.decode_plain_from_ct_value(residues))
