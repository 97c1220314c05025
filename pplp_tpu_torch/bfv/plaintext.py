"""Plaintext polynomials mod t with SEAL-style hex-poly string I/O.

The reference builds all plaintexts from hex strings
(``Plaintext(uint64_to_hex_string(u))``, ``pplp:src/demo.cc:134``)
and reads results back via ``Plaintext::to_string()``; this class reproduces
that string format (uppercase hex, "Ax^i + ... + B" with zero terms omitted).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["Plaintext"]

_TERM_RE = re.compile(r"^([0-9A-Fa-f]+)(?:x\^?([0-9]+))?$")


class Plaintext:
    """Coefficient vector mod t, host-resident (numpy object ints)."""

    def __init__(self, data="0", n: int | None = None):
        if isinstance(data, str):
            coeffs = self._parse(data)
        else:
            coeffs = [int(c) for c in np.asarray(data, dtype=object).ravel()]
        if n is not None:
            assert len(coeffs) <= n, "plaintext longer than poly degree"
            coeffs = coeffs + [0] * (n - len(coeffs))
        self.coeffs = coeffs

    @staticmethod
    def _parse(s: str) -> list[int]:
        s = s.replace(" ", "")
        if not s:
            return [0]
        terms = s.split("+")
        parsed = []
        deg_max = 0
        for term in terms:
            mt = _TERM_RE.match(term)
            if not mt:
                raise ValueError(f"bad plaintext term {term!r}")
            coeff = int(mt.group(1), 16)
            power = int(mt.group(2)) if mt.group(2) is not None else 0
            parsed.append((power, coeff))
            deg_max = max(deg_max, power)
        out = [0] * (deg_max + 1)
        for power, coeff in parsed:
            out[power] = coeff
        return out

    def significant_coeff_count(self) -> int:
        for i in range(len(self.coeffs) - 1, -1, -1):
            if self.coeffs[i]:
                return i + 1
        return 0

    def to_string(self) -> str:
        """SEAL-compatible hex-poly rendering."""
        sig = self.significant_coeff_count()
        if sig == 0:
            return "0"
        parts = []
        for i in range(sig - 1, -1, -1):
            c = self.coeffs[i]
            if not c:
                continue
            h = format(c, "X")
            parts.append(h if i == 0 else f"{h}x^{i}")
        return " + ".join(parts)

    def validate_for(self, ctx) -> None:
        """SEAL parity: Encryptor::encrypt rejects plaintexts whose
        coefficients are not reduced mod the plain modulus (is_valid_for,
        used implicitly by every encrypt in pplp:src/demo.cc).
        A silent mod-t wrap would decrypt to a different value than the
        caller encoded — fail loudly instead."""
        t = ctx.parms.plain_modulus
        bad = [c for c in self.coeffs if not 0 <= c < t]
        if bad:
            raise ValueError(
                f"plaintext coefficient {bad[0]:#x} is not reduced modulo "
                f"the plain modulus t={t:#x}; reduce before encrypting"
            )

    def pair_u32(self, n: int):
        """(lo, hi) uint32 arrays of length n (coeffs must be < 2^64)."""
        arr = np.zeros(n, dtype=np.uint64)
        for i, c in enumerate(self.coeffs[:n]):
            arr[i] = c
        return (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32), (
            arr >> np.uint64(32)
        ).astype(np.uint32)

    def __eq__(self, other):
        if not isinstance(other, Plaintext):
            return NotImplemented
        a, b = self.coeffs, other.coeffs
        la, lb = self.significant_coeff_count(), other.significant_coeff_count()
        return la == lb and a[:la] == b[:lb]

    def __repr__(self):
        return f"Plaintext({self.to_string()!r})"
