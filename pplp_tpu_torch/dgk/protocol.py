"""DGK end-to-end proximity benchmark (reference C18,
``src/test/dgk/src/Tests/main.cc:75-298``): the full blind-distance + Bloom
filter protocol under DGK for radius 16..4096, per-stage ms timings to
``dgk_measure.csv`` (exact reference schema), plus the keygen/enc/dec smoke
test (``dgk_example``).

Math (all messages mod u): c1 = Enc(u_A)·h^r1, c2 = Enc(-2xa)·h^r2,
c3 = Enc(-2ya)·h^r3; server computes c1·c2^xb·c3^yb raised to s, times
Enc(s·z), Enc(s·r) => Dec = s·(d^2 + r) mod u. BF keys ((s(r+di) mod u)<<l)|w
— the DGK variant reduces mod u (no overflow hazard).

Port of ``pplp_tpu.dgk.protocol``: the single check keeps the reference's
host ``pow`` calls; the Bloom filter is the port's ``BloomFilter`` on
``device`` (``cuda`` unless the caller asks for another), its r^2 keys
inserted in one batch as 32-bit halves in int64.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..primitives import BloomFilter, BloomParameters
from ..utils.csvwriter import CSVWriter
from .dgk import DGKPrivateKey, DGKPublicKey, dgk_decrypt, dgk_encrypt, dgk_gen_keys, dgk_random_num

__all__ = ["dgk_example", "pplp_dgk", "dgk_sweep_main", "DGK_CSV_COLUMNS"]

DGK_CSV_COLUMNS = [
    "radius ",  # (sic) trailing space as in main.cc:256
    "d_AkGen", "d_ApreClac", "d_Aenc", "d_Adec", "d_BsetBF", "d_BencCr",
    "d_BencCz", "d_BhomoCalc", "d_A1", "d_A2", "d_A3", "d_B1", "d_B2",
    "d_B3", "d_Atotal", "d_Btotal",
]


def dgk_example(k=512, t=80, l=10, seed=0) -> bool:
    """Keygen/encrypt/decrypt round-trip smoke test (main.cc:37-73)."""
    rng = random.Random(seed + 1)
    priv, pub = dgk_gen_keys(k, t, l, seed=seed)
    for _ in range(8):
        m = rng.randrange(0, pub.u)
        r = dgk_random_num(2 * t, rng)
        if dgk_decrypt(priv, dgk_encrypt(pub, m, r)) != m:
            return False
    return True


@dataclass
class DGKStageTimings:
    d_AkGen: float
    d_ApreClac: float  # (sic) reference's spelling
    d_Aenc: float
    d_Adec: float
    d_BsetBF: float
    d_BencCr: float
    d_BencCz: float
    d_BhomoCalc: float
    is_near: bool

    def stage_rows(self):
        d_A1, d_A2, d_A3 = self.d_AkGen, self.d_ApreClac, self.d_Aenc + self.d_Adec
        d_B1, d_B2 = 0.0, self.d_BsetBF + self.d_BencCr
        d_B3 = self.d_BencCz + self.d_BhomoCalc
        return [
            self.d_AkGen, self.d_ApreClac, self.d_Aenc, self.d_Adec,
            self.d_BsetBF, self.d_BencCr, self.d_BencCz, self.d_BhomoCalc,
            d_A1, d_A2, d_A3, d_B1, d_B2, d_B3,
            d_A1 + d_A2 + d_A3, d_B1 + d_B2 + d_B3,
        ]


def pplp_dgk(
    radius: int,
    xa=123123, ya=123456, xb=123321, yb=123654,  # main.cc:76-79 defaults
    k=2048, t=320, l=16, seed: int | None = None,
    keys: tuple[DGKPrivateKey, DGKPublicKey] | None = None,
    bf_index_mode: str = "mixed",
    device="cuda",
) -> DGKStageTimings:
    rng = random.Random(seed)
    sq_radius = radius * radius
    ns = time.perf_counter_ns
    device = torch.device(device)

    # A -- keygen
    t0 = ns()
    if keys is None:
        priv, pub = dgk_gen_keys(k, t, l, seed=seed)
    else:
        priv, pub = keys
    d_AkGen = ns() - t0

    # A -- precompute h^r blinding factors
    t0 = ns()
    r1, r2, r3 = (dgk_random_num(int(2.5 * t), rng) for _ in range(3))
    t1, t2, t3 = (pow(pub.h, r, pub.n) for r in (r1, r2, r3))
    d_ApreCalc = ns() - t0

    # B -- Bloom filter over blinded distances (mod u — sound variant)
    t0 = ns()
    p = BloomParameters(
        projected_element_count=sq_radius,
        false_positive_probability=1e-4,
        random_seed=0xA5A5A5A5,
        index_mode=bf_index_mode,
    )
    p.compute_optimal_parameters()
    bf = BloomFilter(p, device=device)
    r_bl = dgk_random_num(l, rng)
    s_bl = dgk_random_num(l, rng)
    w_bl = dgk_random_num(l, rng)
    u = pub.u
    di = np.arange(sq_radius, dtype=np.uint64)
    keys_u64 = ((((np.uint64(s_bl) * (di + np.uint64(r_bl))) % np.uint64(u)) << np.uint64(l))
                | np.uint64(w_bl))
    bf.insert_u64_batch(
        torch.from_numpy((keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.int64)).to(device),
        torch.from_numpy((keys_u64 >> np.uint64(32)).astype(np.int64)).to(device),
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    d_BsetBF = ns() - t0

    # B -- Enc(s*r)
    t0 = ns()
    cr = dgk_encrypt(pub, (r_bl * s_bl) % u, r_bl)
    d_BencCr = ns() - t0

    # A -- encrypt u_A, -2xa, -2ya (inverses), blinded by h^r
    t0 = ns()
    uu = xa * xa + ya * ya
    c1 = pow(pub.g, uu, pub.n) * t1 % pub.n
    c2 = pow(pow(pub.g, xa << 1, pub.n), -1, pub.n) * t2 % pub.n
    c3 = pow(pow(pub.g, ya << 1, pub.n), -1, pub.n) * t3 % pub.n
    d_Aenc = ns() - t0

    # B -- Enc(s*z)
    t0 = ns()
    z = xb * xb + yb * yb
    cz = dgk_encrypt(pub, (z * s_bl) % u, dgk_random_num(l, rng))
    d_BencCz = ns() - t0

    # B -- homomorphic blind distance
    t0 = ns()
    c2 = pow(c2, xb, pub.n)
    c3 = pow(c3, yb, pub.n)
    c1 = c1 * c2 % pub.n * c3 % pub.n
    c1 = pow(c1, s_bl, pub.n)
    c1 = c1 * cz % pub.n * cr % pub.n
    d_BhomoCalc = ns() - t0

    # A -- decrypt + BF probe
    t0 = ns()
    bd = dgk_decrypt(priv, c1)
    key = ((bd << l) | w_bl) & ((1 << 64) - 1)
    is_near = bf.contains_u64(key)
    d_Adec = ns() - t0

    to_ms = 1e-6
    return DGKStageTimings(
        d_AkGen=d_AkGen * to_ms,
        d_ApreClac=d_ApreCalc * to_ms,
        d_Aenc=d_Aenc * to_ms,
        d_Adec=d_Adec * to_ms,
        d_BsetBF=d_BsetBF * to_ms,
        d_BencCr=d_BencCr * to_ms,
        d_BencCz=d_BencCz * to_ms,
        d_BhomoCalc=d_BhomoCalc * to_ms,
        is_near=is_near,
    )


def dgk_sweep_main(filename="./dgk_measure.csv", radii=None, seed=0, device="cuda",
                   **kw) -> int:
    """main.cc:300-317: sweep radius 16..4096 -> dgk_measure.csv."""
    radii = radii or [16 << i for i in range(9)]
    for i, radius in enumerate(radii):
        res = pplp_dgk(radius, seed=seed, device=device, **kw)
        csv = CSVWriter(",")
        if i == 0:
            csv.new_row().add_all(*DGK_CSV_COLUMNS)
        csv.new_row().add_all(radius, *res.stage_rows())
        csv.write_to_file(filename, append=i != 0)
        print(f"dgk radius={radius} {'near' if res.is_near else 'far'}")
    return 0
