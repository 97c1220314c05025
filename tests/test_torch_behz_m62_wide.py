"""The port's m62 base conversions past 2^128 and the u64 route's operation
counts (tolerance 0: exact integer arithmetic).

* A fast base conversion whose sums pass 2^128 (40 source primes and 4
  destination primes, all of 62 bits): the plain version sums it in parts
  (``_Conversion.terms`` < 40), the reference in 160 bits
  (``pplp_tpu.bfv.behz._accum_reduce``); both equal the exact sums.
  Inside ``RnsMultiplier`` every product has a factor below 2^60 (the B_sk
  primes), so a sum of up to 64 terms is one part; the widest chain the u64
  kernels take (L = 40 primes of 62 bits, sums up to 2^127.3) is held
  against the plain steps in ``tests/test_torch_cuda.py``
  (``test_seal_at_the_limb_bound``).
* The u64 route's operation counts (``measure_multiply.kernel_counts64``).
"""

import jax.numpy as jnp
import numpy as np
import torch

from pplp_tpu.bfv import behz as rbehz
from pplp_tpu.ops import ntt as rntt
from pplp_tpu.ops.primes import Modulus as RModulus
from pplp_tpu_torch import measure_multiply
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.ops import ntt
from pplp_tpu_torch.ops.primes import Modulus, get_primes

N = 64
_M32 = 0xFFFFFFFF


def _unpair(p) -> np.ndarray:
    lo, hi = (np.asarray(a).astype(np.uint64) for a in p)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def _pair(a: np.ndarray):
    a = np.asarray(a, dtype=np.int64)
    return jnp.asarray((a & _M32).astype(np.uint32)), jnp.asarray((a >> 32).astype(np.uint32))


def _canonical(rng, shape, moduli):
    """Random residues [..., len(moduli), N]; the first coefficients of every
    limb at q - 1, the largest canonical residue."""
    qs = np.asarray(moduli, np.int64)[:, None]
    x = rng.integers(0, 1 << 62, size=shape + (len(moduli), N)) % qs
    x[..., :3] = qs - 1
    return x


def test_conversion_past_2_128_is_summed_in_parts():
    """sum_i y_i |prod(src) / src_i|_d over 40 primes of 62 bits: each
    product reaches 2^124, the sum passes 2^128, so the port's exact 128-bit
    sum is taken in parts and added mod the destination."""
    primes = get_primes(62, 44, N)
    src, dst = list(primes[:40]), list(primes[40:])
    conv = behz._conv_ints([Modulus(p) for p in src], [Modulus(p) for p in dst])
    tables = ntt.build_tables([Modulus(p) for p in dst], N, "cpu")
    dst_col = torch.tensor([[p] for p in dst], dtype=torch.int64)
    c = behz._Conversion.build(conv, [Modulus(p) for p in src], dst_col, tables.prof, "cpu")
    assert c.terms < len(src)  # more than one part
    y = _canonical(np.random.default_rng(20), (2,), src)
    sums = [[[sum(int(y[b, i, j]) * conv[d][i] for i in range(len(src))) for j in range(N)]
             for d in range(len(dst))] for b in range(2)]
    assert max(max(max(row) for row in s) for s in sums) >> 128  # the sums pass 2^128
    got = c(torch.from_numpy(y)).numpy()
    exact = [[[v % dst[d] for v in row] for d, row in enumerate(s)] for s in sums]
    assert (got == np.asarray(exact, np.int64)).all()
    basis = rbehz._Basis(tuple(RModulus(p) for p in dst),
                         rntt.build_tables([RModulus(p) for p in dst], N))
    assert (got == _unpair(rbehz._accum_reduce(_pair(y), conv, basis))).all()


def test_u64_route_counts_what_the_functions_need():
    """A 64 x 64 -> 128-bit product is 4 partial products; the reduction of
    a 128-bit value by floor(2^128 / q) = rh 2^64 + r0 with rh < 2^32 is
    2 + 4 + 2 + 3. The conversions count one reduction per output (their
    folded constants). On the seal chain n = 4096 at batch 256, width 1,
    to_bsk and floor_sk are then bound by their bytes, and the call's work
    is the sum of its phases'."""
    mm = measure_multiply
    assert (mm.U64_MAC_MULS, mm.U64_REDUCE128_MULS, mm.U64_REDUCE64_MULS) == (4, 11, 9)
    assert mm.U64_MULMOD_MULS == 15 and mm.U64_PRODUCT_MULS == 10
    counts = mm.kernel_counts64(4096, 3, 5, 3, 256)
    assert counts["behz64_to_bsk"]["bound_by"] == "bytes"
    assert counts["behz64_floor_sk"]["bound_by"] == "bytes"
    e = 256 * 4096
    assert counts["behz64_floor_sk"]["mulmods"] * mm.U64_PRODUCT_MULS == 3 * e * (
        3 * 10 + 4 * (4 * 4 + 11) + (8 * 4 + 11) + 3 * (5 * 4 + 11))
    call = mm.call_counts64(4096, 3, 5, 3, 256)
    assert call["mulmods"] == sum(c["mulmods"] for c in counts.values())
    assert counts["behz64_tensor"]["mulmods"] * mm.U64_PRODUCT_MULS == e * 8 * 3 * 15
