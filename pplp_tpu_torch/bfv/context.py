"""BFV context: NTT tables plus the RNS scaling constants, on one device.

Counterpart of ``pplp_tpu.bfv.context``. Encryption encodes a plaintext
coefficient m as round(q*m/t) mod each q_i:

    round(q*m/t) = Delta*m + fix,  fix = floor(((q mod t)*m + (t+1)//2) / t).

With t up to 2^56, (q mod t)*m reaches 2^112, so ``fix`` is computed exactly
with host Python ints over the plaintext before it moves to the device;
plaintexts are host data here. ``fix`` <= m, so it fits 64 bits.

Both residue profiles: ``prof`` is the tables' arithmetic (``m31``, or
``m62`` bound to the chain's ratio words); on m62 the Shoup companion of
Delta is 64-bit (an int64 bit pattern) and 64-bit values reduce through
``m62.reduce128``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ntt
from ..ops.modmath import M32, as_int64_bits
from ..ops.primes import Modulus
from .params import EncryptionParameters

__all__ = ["BFVContext"]


def _host_u64(m_lo, m_hi) -> np.ndarray:
    """(lo, hi) u32 host arrays -> uint64 array."""
    lo = np.asarray(m_lo, dtype=np.uint64)
    hi = np.asarray(m_hi, dtype=np.uint64)
    return lo | (hi << np.uint64(32))


@dataclass(frozen=True, eq=False)
class BFVContext:
    parms: EncryptionParameters
    tables: ntt.NttTables
    t: int
    q: int
    delta: int
    q_mod_t: int
    delta_mod_q: torch.Tensor  # [L, 1]
    delta_shoup: torch.Tensor  # [L, 1]
    t_mod_q: torch.Tensor      # [L, 1]
    # Host CRT recomposition: x = sum_i ((x_i * qhat_inv_i) mod q_i) * qhat_i mod q
    qhat: tuple
    qhat_inv: tuple

    @property
    def n(self) -> int:
        return self.parms.poly_modulus_degree

    @property
    def L(self) -> int:
        return len(self.parms.coeff_modulus)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    @property
    def prof(self):
        return self.tables.prof

    @property
    def moduli(self):
        return self.tables.moduli

    @property
    def q2(self) -> torch.Tensor:
        """q shaped [L, 1] for [..., L, n] residues."""
        return self.tables.q_b(1)

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def build(parms: EncryptionParameters, device) -> "BFVContext":
        """Context for ``parms`` on ``device`` (cached, as the reference's is:
        both roles of a run, and repeated runs, share one)."""
        err = parms.validate()
        if err:
            raise ValueError(f"invalid encryption parameters: {err}")
        moduli = [Modulus(q) for q in parms.coeff_modulus]
        tables = ntt.build_tables(moduli, parms.poly_modulus_degree, device)
        t = parms.plain_modulus
        q = 1
        for m in moduli:
            q *= m.value
        delta = q // t

        def per_limb(fn) -> torch.Tensor:
            """One constant per limb, shaped [L, 1]."""
            vals = [[fn(m)] for m in moduli]
            return torch.tensor(vals, dtype=torch.int64, device=tables.device)

        qhat = tuple(q // m.value for m in moduli)
        shoup_bits = tables.prof.shoup_bits
        return BFVContext(
            parms=parms,
            tables=tables,
            t=t,
            q=q,
            delta=delta,
            q_mod_t=q % t,
            delta_mod_q=per_limb(lambda m: delta % m.value),
            delta_shoup=per_limb(
                lambda m: as_int64_bits(m.shoup(delta % m.value, shoup_bits))),
            t_mod_q=per_limb(lambda m: t % m.value),
            qhat=qhat,
            qhat_inv=tuple(pow(h % m.value, -1, m.value) for h, m in zip(qhat, moduli)),
        )

    # ------------------------------------------------------------------
    # Plaintext handling: host plaintext -> device residues
    # ------------------------------------------------------------------

    def reduce_u64_to_rns(self, m_lo, m_hi) -> torch.Tensor:
        """Host (lo, hi) u32 words of 64-bit values [..., n] -> residues
        [..., L, n] on the device."""
        lo, hi = (torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)
                  .unsqueeze(-2) for a in (m_lo, m_hi))
        return self.prof.reduce_words((lo, hi), self.q2)

    def scale_plain(self, m_lo, m_hi) -> torch.Tensor:
        """round(q*m/t) mod q_i for host plaintext coefficient pairs [..., n]."""
        m = _host_u64(m_lo, m_hi)
        fix = (m.astype(object) * self.q_mod_t + (self.t + 1) // 2) // self.t
        fix = fix.astype(np.uint64)  # fix <= m < 2^64
        fix_rns = self.reduce_u64_to_rns(fix & np.uint64(M32), fix >> np.uint64(32))
        m_rns = self.reduce_u64_to_rns(m_lo, m_hi)
        p, q2 = self.prof, self.q2
        dm = p.mulmod_shoup(m_rns, self.delta_mod_q, self.delta_shoup, q2)
        return p.add(dm, fix_rns, q2)

    def lift_plain_centered(self, m_lo, m_hi) -> torch.Tensor:
        """Centered lift of plaintext coefficients into R_q (multiply_plain).

        Coefficients >= (t+1)/2 stand for negatives: lift to m - t mod q_i.
        """
        m = _host_u64(m_lo, m_hi)
        m_rns = self.reduce_u64_to_rns(m_lo, m_hi)
        is_upper = torch.as_tensor(m >= np.uint64((self.t + 1) // 2),
                                   device=self.device).unsqueeze(-2)
        shifted = self.prof.sub(m_rns, self.t_mod_q, self.q2)
        return torch.where(is_upper, shifted, m_rns)

    # ------------------------------------------------------------------
    # Host CRT composition (decryption)
    # ------------------------------------------------------------------

    def crt_compose(self, residues: np.ndarray) -> list[int]:
        """residues: host integer array [L, n] -> Python ints [n] in [0, q)."""
        res = np.asarray(residues).astype(object)
        acc = np.zeros(res.shape[1], dtype=object)
        for i, m in enumerate(self.moduli):
            acc = acc + (res[i] * self.qhat_inv[i] % m.value) * self.qhat[i]
        return [int(v) % self.q for v in acc]

    def decode_plain_from_ct_value(self, residues: np.ndarray) -> list[int]:
        """[L, n] residues of x = (c0 + c1 s) mod q -> round(t*x/q) mod t."""
        t, q = self.t, self.q
        return [((x * t + q // 2) // q) % t for x in self.crt_compose(residues)]
