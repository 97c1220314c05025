"""The benchmark's yardstick: the card's peaks, the least work each measured
piece needs, and the statistics its metrics take.

A roofline bound is the larger of the bytes the work must move once over
the memory's peak rate and the 32-bit multiplies it must issue over the
integer peak. Both are counted from the inputs' shapes, never from the
kernels that happen to run, so a bound stays valid when a later change
fuses or replaces kernels.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM 80GB data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# 132 SMs x 64 32-bit integer multiplies a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x the
# 1.98 GHz top SM clock: derived from published per-SM figures, not
# measured.
INT32_MULS_PER_S = 132 * 64 * 1.98e9
# A modular product by a precomputed constant (Shoup) or a Barrett
# reduction: the low product, the high product of the quotient estimate,
# and the quotient times the modulus.
MULS_PER_MODPRODUCT = 3
# A Bloom index: the AP hash round 1, murmur3's fmix32 2, the reduction by
# the table size (a multiply-high and a multiply) 2.
MULS_PER_SALT = 5
# A residue of a prime below 2^30, as few bytes as any design can hold it in.
RESIDUE_BYTES = 4

BASIS = (f"bytes over {HBM_BYTES_PER_S:.4g} B/s (H100 SXM HBM3, data sheet); 32-bit multiplies "
         f"over {INT32_MULS_PER_S:.5g}/s = 132 SMs x 64 a clock x 1.98 GHz (published per-SM "
         f"figures, not measured); {MULS_PER_MODPRODUCT} multiplies a modular product, "
         f"{MULS_PER_SALT} a Bloom index; {RESIDUE_BYTES} B a residue")


def bound(nbytes: float, muls: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / INT32_MULS_PER_S
    return {"bytes": nbytes, "muls": muls, "seconds": max(t_bytes, t_ops),
            "side": "bytes" if t_bytes >= t_ops else "ops"}


def bloom_insert(keys: int, salts: int, table_bits: int) -> dict:
    """The filter's insert: the table written once; every key hashed once
    per salt. The keys are made on the card from (s, r, w): nothing else is
    read."""
    return bound(table_bits / 8, keys * salts * MULS_PER_SALT)


def ntt_products(polys: int, n: int) -> int:
    """Butterflies of ``polys`` negacyclic transforms of size n: one
    modular product each."""
    return polys * (n // 2) * (n.bit_length() - 1)


def packed_step(rows: int, limbs: int, n: int, table_bits: int, salts: int,
                salts_tested: float) -> dict:
    """One step of coefficient-packed checks: six ciphertext polynomials,
    three plaintext spectra, the key spectrum and the two additive terms
    read once, the filter read once, a verdict byte a check written once;
    six forward transforms and one inverse, seven products a residue by the
    plaintext and key spectra, the decode's L + 2L + 1 products a
    coefficient, and the probe's salts up to each key's first clear bit."""
    residues = rows * limbs * n
    nbytes = (6 * residues + 6 * limbs * n) * RESIDUE_BYTES + table_bits / 8 + 4 * salts \
        + rows * n
    products = ntt_products(7 * rows * limbs, n) + 7 * residues + rows * n * (3 * limbs + 1)
    return bound(nbytes, products * MULS_PER_MODPRODUCT + salts_tested * MULS_PER_SALT)


def quantile(values, q: float) -> float:
    """The q-quantile of all values, interpolated between order statistics
    (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return cuts[round(q * 100) - 1]
