"""Batch encoder: CRT slot packing for a prime t = 1 mod 2n (SEAL's
``BatchEncoder``).

Counterpart of ``pplp_tpu.bfv.batch_encoder``. A plaintext polynomial mod a
prime t = 1 mod 2n is n slots of Z_t through the negacyclic NTT over t
itself: encode is the inverse NTT of the slot vector, decode the forward
NTT. The transforms run on a one-prime table [t] (m31: t < 2^30, whatever
the ciphertext chain's profile), through ``ntt.forward``/``inverse``: the
u32 kernel on a CUDA context.

Slots follow SEAL's 2 x (n/2) matrix: row-0 slot j evaluates the plaintext
at psi^(3^j mod 2n), row-1 slot j at psi^(-3^j mod 2n), so
``galois.rotate_rows`` rotates each row and ``rotate_columns`` swaps them.
``encode_rows``/``decode_rows`` take a leading batch of slot vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ntt
from ..ops.primes import Modulus, is_prime
from .context import BFVContext
from .plaintext import Plaintext

__all__ = ["BatchEncoder"]


class BatchEncoder:
    def __init__(self, ctx: BFVContext):
        t, n = ctx.t, ctx.n
        if t >= (1 << 30):
            raise NotImplementedError("batching here needs t < 2^30")
        if not is_prime(t) or (t - 1) % (2 * n) != 0:
            raise ValueError(
                "plain_modulus must be a prime = 1 mod 2n for batching "
                "(cf. SEAL qualifiers.using_batching)"
            )
        self.ctx = ctx
        self.slot_count = n
        self._tb = ntt.build_tables([Modulus(t)], n, ctx.device)
        self._perm = self._orbit_permutation(n)
        self._perm_dev = torch.as_tensor(self._perm, device=self._tb.device)

    @staticmethod
    def _orbit_permutation(n: int) -> np.ndarray:
        """perm[j] = spectrum position of slot j (SEAL's matrix layout).

        The port's forward NTT puts the evaluation at psi^(2k+1) at position
        brv(k). Row-0 slot j sits at exponent 3^j mod 2n, row-1 at 2n - 3^j.
        """
        logn = n.bit_length() - 1

        def brv(k):
            r = 0
            for _ in range(logn):
                r = (r << 1) | (k & 1)
                k >>= 1
            return r

        m = 2 * n
        perm = np.zeros(n, np.int64)
        e = 1  # 3^j mod 2n
        for j in range(n // 2):
            perm[j] = brv(((e - 1) // 2) % n)
            perm[n // 2 + j] = brv(((m - e - 1) // 2) % n)
            e = (e * 3) % m
        return perm

    def encode_rows(self, values) -> np.ndarray:
        """Slot vectors [..., <= n] (integers, reduced mod t) -> plaintext
        coefficients [..., n] (int64 on the host)."""
        n, t = self.slot_count, self.ctx.t
        vals = np.asarray(values, dtype=np.uint64)
        slots = np.zeros(vals.shape[:-1] + (n,), np.int64)
        slots[..., : vals.shape[-1]] = (vals % np.uint64(t)).astype(np.int64)
        spec = torch.zeros(slots.shape, dtype=torch.int64, device=self._tb.device)
        spec[..., self._perm_dev] = torch.as_tensor(slots, device=self._tb.device)
        return ntt.inverse(spec.unsqueeze(-2), self._tb).squeeze(-2).cpu().numpy()

    def decode_rows(self, coeffs) -> np.ndarray:
        """Plaintext coefficients [..., n] (below t) -> slot values [..., n]."""
        x = torch.as_tensor(np.asarray(coeffs, dtype=np.int64), device=self._tb.device)
        spec = ntt.forward(x.unsqueeze(-2).contiguous(), self._tb).squeeze(-2)
        return spec[..., self._perm_dev].cpu().numpy()

    def encode(self, values) -> Plaintext:
        """Integers [<= n] -> the plaintext whose slots hold them."""
        return Plaintext([int(c) for c in self.encode_rows(values)])

    def decode(self, plain: Plaintext) -> list[int]:
        coeffs = np.zeros(self.slot_count, np.int64)
        src = plain.coeffs[: self.slot_count]
        coeffs[: len(src)] = src
        return [int(v) for v in self.decode_rows(coeffs)]
