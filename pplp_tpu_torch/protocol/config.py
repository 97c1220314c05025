"""Protocol configuration with the reference's parameter names and defaults.

Copy of ``pplp_tpu.protocol.config``, with the same fields and defaults.

Flag surface mirrors ``pplp:src/demo.cc:23-47`` and
``src/client.cc:26-50`` / ``src/server.cc``: coordinates < 2^27 (which bounds
d^2 < 2^55 below t = 2^56), radius in [1, 8192], plain_modulus_bits <= 56,
poly_modulus_degree exponent in [12, 15].
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bfv import EncryptionParameters

__all__ = ["ProtocolConfig"]

COORD_MAX = 1 << 27


@dataclass(frozen=True)
class ProtocolConfig:
    xa: int = 1234
    ya: int = 1212
    xb: int = 1000
    yb: int = 1000
    radius: int = 128
    plain_modulus_bits: int = 56
    poly_modulus_degree_bits: int = 13
    false_positive_probability: float = 1e-12  # demo.cc:109 (C/S use 1e-4)
    bf_seed: int = 0xA5A5A5A5
    profile: str = "seal"  # "seal" (SEAL-4.1-style chain) | "tpu" (<2^30 primes)
    seed: int | None = None  # None -> fresh crypto randomness
    # Bound blinding so s*(d^2+r) < t (sound near-detection). False reproduces
    # the reference's raw 32-bit draws including its overflow hazard.
    safe_blinding: bool = True
    # "mixed" hardens Bloom indexing against the reference's degenerate
    # shifted-key hashing (see primitives.bloom.BloomParameters); "reference"
    # reproduces Partow/pplp indexing bit-exactly.
    bf_index_mode: str = "mixed"

    def __post_init__(self):
        assert 0 <= self.xa < COORD_MAX and 0 <= self.ya < COORD_MAX
        assert 0 <= self.xb < COORD_MAX and 0 <= self.yb < COORD_MAX
        assert 1 <= self.radius <= 8192
        assert 1 <= self.plain_modulus_bits <= 56
        assert 12 <= self.poly_modulus_degree_bits <= 15

    @property
    def poly_modulus_degree(self) -> int:
        return 1 << self.poly_modulus_degree_bits

    @property
    def plain_modulus(self) -> int:
        return 1 << self.plain_modulus_bits

    @property
    def sq_radius(self) -> int:
        return self.radius * self.radius

    def encryption_parameters(self) -> EncryptionParameters:
        return EncryptionParameters.bfv(
            self.poly_modulus_degree, self.plain_modulus, profile=self.profile
        )
