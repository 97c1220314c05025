"""BFV decryption: x = c0 + c1*s (+ c2*s^2 ...) mod q, m = round(t*x/q) mod t.

Counterpart of ``pplp_tpu.bfv.decryptor``. The products with the powers of
s run on the device in the NTT domain; CRT composition and rounding run on
the host over Python ints. A size-3 ciphertext (a product before
relinearization) decrypts with s^2. ``invariant_noise_budget`` reads the
noise left on the host, as the reference does.
"""

from __future__ import annotations

from ..ops import ntt
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
        p, q2 = ctx.prof, ctx.q2
        s_pow, s_pow_shoup = self.sk.s_ntt, self.sk.s_shoup
        acc = None
        for i, c in enumerate(a.polys[1:]):
            if i:
                s_pow = p.mulmod_shoup(s_pow, self.sk.s_ntt, self.sk.s_shoup, q2)
                s_pow_shoup = shoup(ctx, s_pow)
            term = p.mulmod_shoup(ntt.forward(c, ctx.tables), s_pow, s_pow_shoup, q2)
            acc = term if acc is None else p.add(acc, term, q2)
        return p.add(a.polys[0], ntt.inverse(acc, ctx.tables), q2)

    def decrypt(self, a: Ciphertext) -> Plaintext:
        residues = self.ct_value_rns(a).cpu().numpy()
        return Plaintext(self.ctx.decode_plain_from_ct_value(residues))

    def invariant_noise_budget(self, a: Ciphertext) -> int:
        """Bits of noise budget left (SEAL's invariant_noise_budget
        analogue); 0 means decryption is no longer guaranteed. Computed on
        the host from the centered residual x - round(q m / t)."""
        ctx = self.ctx
        xs = ctx.crt_compose(self.ct_value_rns(a).cpu().numpy())
        q, t = ctx.q, ctx.t
        worst = 1
        for x in xs:
            m = ((x * t + q // 2) // q) % t
            e = (x - (q * m + t // 2) // t) % q
            worst = max(worst, min(e, q - e))
        # invariant noise v ~ t e / q; budget = -log2(2|v|) = log2(q / (2 t e)).
        return max(0, (q // (2 * t * worst)).bit_length() - 1)
