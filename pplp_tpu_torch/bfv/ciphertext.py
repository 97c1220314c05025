"""Ciphertext container: a tuple of R_q polynomials as RNS residue tensors.

Counterpart of ``pplp_tpu.bfv.ciphertext`` (a plain dataclass here, not a
pytree). Polynomials live in the coefficient domain by default; ``domain``
lets evaluators keep NTT forms without extra transforms.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Ciphertext"]


@dataclass
class Ciphertext:
    polys: tuple  # k int64 tensors, each [..., L, n]
    domain: str = "coeff"  # "coeff" | "ntt"

    @property
    def size(self) -> int:
        return len(self.polys)
