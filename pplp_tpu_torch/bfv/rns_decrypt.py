"""Device decode of BFV decryption (BEHZ t-gamma scale-and-round).

Counterpart of ``pplp_tpu.bfv.rns_decrypt``. Given x = (c0 + c1 s) mod q as
RNS residues [..., L, n], computes m = round(t x / q) mod t on the device,
in place of the host CRT composition, for t < 2^30:

  y_i = | gamma t x_i (q/q_i)^-1 |_{q_i}                    (Shoup product)
  s_m = | sum_i y_i c_m[i] |_m,  c_m[i] = |-(q/q_i) q^-1|_m,  m in {t, gamma}
  m   = | (s_t - centered(s_gamma)) gamma^-1 |_t

gamma is a prime near 2^29, far above 2L, which makes the correction exact
for any decryptable ciphertext. Both residue profiles.

int64 bounds: every term is reduced to [0, m) before its product, so each
product y_i c_m[i] < 2^60 is exact, and each is reduced again before the
sum over the limbs, which then stays below L 2^30.
"""

from __future__ import annotations

import functools

import torch

from ..ops.modmath import as_int64_bits
from ..ops.primes import is_prime
from .context import BFVContext

__all__ = ["RnsDecoder", "get_decoder"]


def _find_gamma(ctx: BFVContext) -> int:
    g = (1 << 29) - 1
    banned = {m.value for m in ctx.moduli} | {ctx.t}
    while True:
        if is_prime(g) and g not in banned and ctx.q % g != 0:
            return g
        g -= 2


class RnsDecoder:
    def __init__(self, ctx: BFVContext):
        if ctx.t >= 1 << 30:
            raise NotImplementedError("device decode supports t < 2^30; use the host path")
        self.ctx = ctx
        t, q = ctx.t, ctx.q
        self.gamma = gamma = _find_gamma(ctx)
        qm = [m.value for m in ctx.moduli]
        shoup_bits = ctx.prof.shoup_bits

        def col(vals):
            return torch.tensor([[v] for v in vals], dtype=torch.int64, device=ctx.device)

        # y multiplier per limb: |gamma t qhat_i^-1|_{q_i}, with its companion.
        vals = [(gamma * t * pow(q // qi, -1, qi)) % qi for qi in qm]
        self.ymul = (col(vals), col([as_int64_bits((v << shoup_bits) // qi)
                                     for v, qi in zip(vals, qm)]))

        # Conversion constants folded with -q^-1 per target.
        def conv_col(m):
            neg_qinv = pow(-q, -1, m)
            return col([((q // qi) * neg_qinv) % m for qi in qm])

        self.c_t = conv_col(t)
        self.c_g = conv_col(gamma)
        self.inv_gamma = pow(gamma % t, -1, t)

    def _accum_mod(self, y: torch.Tensor, conv: torch.Tensor, m: int) -> torch.Tensor:
        """sum_i y[..., i, :] conv[i] mod m -> [..., n]."""
        return (((y % m) * conv) % m).sum(dim=-2) % m

    def decode_mod_t(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., L, n] residues of (c0 + c1 s) mod q -> m mod t [..., n]."""
        ctx = self.ctx
        t, gamma = ctx.t, self.gamma
        y = ctx.prof.mulmod_shoup(x, *self.ymul, ctx.q2)
        s_t = self._accum_mod(y, self.c_t, t)
        s_g = self._accum_mod(y, self.c_g, gamma)
        # centered(s_gamma): subtract gamma when s_g > gamma / 2, so in mod-t
        # terms s_t - s_hat_g = s_t - s_g (+ gamma if centered negative).
        d = (s_t - s_g % t) % t
        d = torch.where(s_g > gamma // 2, (d + gamma % t) % t, d)
        return d * self.inv_gamma % t


@functools.lru_cache(maxsize=8)
def get_decoder(ctx: BFVContext) -> RnsDecoder:
    return RnsDecoder(ctx)
