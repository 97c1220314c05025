"""DGK keygen / encrypt / decrypt (reference C14,
``src/test/dgk/src/dgk.cc`` + ``dgk_keygen.cc``).

Construction (k=2048, t=320, l=16 in the reference benchmark):
  vp, vq : t-bit provable primes        u : l-bit provable prime
  p = 1 + u*vp*rp (k/2 bits),  q = 1 + u*vq*rq,   n = p*q
  h : element of order vp*vq   (random^(rp*rq*u))
  g : element of order u*vp*vq (random^(rp*rq))
  Enc(m; r) = g^m * h^r mod n;  Dec(c) = dlog_{g^vpq}(c^vpq) via table/PH.

The reference's decrypt scans a u-entry table linearly comparing limb 0 first
(``dgk.cc:62-74``); here the table is a hash map (O(1)) and the
Pohlig–Hellman path (``ph.py``) is the table-free alternative. The batched
device path is ``batched.DGKBatch``.

Copy of ``pplp_tpu.dgk.dgk``: the same seed gives the same keys, and
``save_dgk_keys`` the same bytes.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

from .gdsa import gdsa_prime
from .maurer import maurer

__all__ = [
    "DGKPublicKey",
    "DGKPrivateKey",
    "dgk_gen_keys",
    "dgk_encrypt",
    "dgk_decrypt",
    "dgk_random_num",
]


def dgk_random_num(bits: int, rng: random.Random) -> int:
    """bits-bit random number (``random.cc:39`` equivalent, explicit RNG)."""
    return rng.getrandbits(int(bits))


@dataclass
class DGKPublicKey:
    n: int
    g: int
    h: int
    u: int
    t: int


@dataclass
class DGKPrivateKey:
    n: int
    g: int
    u: int
    p: int
    q: int
    vp: int
    vq: int
    vpq: int
    # decryption table: (g^vpq)^m -> m
    rtab: dict = field(default_factory=dict, repr=False)

    def init_table(self):
        gv = pow(self.g, self.vpq, self.n)
        self.rtab = {}
        acc = 1
        for m in range(self.u):
            self.rtab[acc] = m
            acc = acc * gv % self.n
        return self


def _find_elm_ord_v(u, rp, rq, n, rng) -> int:
    """Element of order vp*vq: random^(rp*rq*u) (dgk_keygen.cc:154-176)."""
    e = rp * rq * u
    while True:
        r = dgk_random_num(n.bit_length() - 2, rng)
        rop = pow(r, e, n)
        if rop != 1 and math.gcd(rop, n) == 1:
            return rop


def _find_elm_ord_vu(u, vp, vq, rp, rq, n, rng) -> int:
    """Element of order u*vp*vq: random^(rp*rq), verified to have full order.

    (The reference's loop conditions compare r2, r3 against 2 and 3 instead
    of 1 — dgk_keygen.cc:204-206, a recorded bug; the order checks here are
    the intended ones.)
    """
    e = rp * rq
    while True:
        r = dgk_random_num(n.bit_length() - 2, rng)
        rop = pow(r, e, n)
        if rop == 1 or math.gcd(rop, n) != 1:
            continue
        if pow(rop, u * vp * vq, n) != 1:
            continue
        if pow(rop, vp * vq * u // vp, n) == 1:  # order divides uvq*vp/vp
            continue
        if pow(rop, u * vp * vq // vq, n) == 1:
            continue
        if pow(rop, u * vp * vq // u, n) == 1:
            continue
        return rop


def dgk_gen_keys(
    k: int = 2048, t: int = 320, l: int = 16, seed: int | None = None,
    init_table: bool = True,
) -> tuple[DGKPrivateKey, DGKPublicKey]:
    rng = random.Random(seed)
    vp = maurer(t, rng)
    vq = maurer(t, rng)
    u = maurer(l, rng)
    p = gdsa_prime(u * vp, k // 2, rng)
    q = gdsa_prime(u * vq, k // 2, rng)
    n = p * q
    rp = (p - 1) // (u * vp)
    rq = (q - 1) // (u * vq)
    h = _find_elm_ord_v(u, rp, rq, n, rng)
    g = _find_elm_ord_vu(u, vp, vq, rp, rq, n, rng)
    priv = DGKPrivateKey(n=n, g=g, u=u, p=p, q=q, vp=vp, vq=vq, vpq=vp * vq)
    if init_table:
        priv.init_table()
    pub = DGKPublicKey(n=n, g=g, h=h, u=u, t=t)
    return priv, pub


def save_dgk_keys(priv: DGKPrivateKey | None, pub: DGKPublicKey) -> bytes:
    """Stable JSON-hex key serialization (checkpoint format; the decrypt
    table is rebuilt on load rather than persisted)."""
    import json

    data = {"pub": {k: format(getattr(pub, k), "x") if k != "t" else pub.t
                    for k in ("n", "g", "h", "u", "t")}}
    if priv is not None:
        data["priv"] = {
            k: format(getattr(priv, k), "x")
            for k in ("n", "g", "u", "p", "q", "vp", "vq", "vpq")
        }
    return json.dumps(data).encode()


def load_dgk_keys(blob: bytes, init_table: bool = True):
    import json

    data = json.loads(blob.decode())
    pd = data["pub"]
    pub = DGKPublicKey(
        n=int(pd["n"], 16), g=int(pd["g"], 16), h=int(pd["h"], 16),
        u=int(pd["u"], 16), t=int(pd["t"]),
    )
    priv = None
    if "priv" in data:
        sd = data["priv"]
        priv = DGKPrivateKey(**{k: int(v, 16) for k, v in sd.items()})
        if init_table:
            priv.init_table()
    return priv, pub


def dgk_encrypt(pub: DGKPublicKey, m: int, r: int) -> int:
    """c = g^m * h^r mod n (dgk.cc:33-52)."""
    return pow(pub.g, m, pub.n) * pow(pub.h, r, pub.n) % pub.n


def dgk_decrypt(priv: DGKPrivateKey, c: int) -> int:
    """m = dlog of c^vpq in <g^vpq> (table path; dgk.cc:54-75)."""
    cv = pow(c, priv.vpq, priv.n)
    try:
        return priv.rtab[cv]
    except KeyError:
        raise ValueError("ciphertext decrypts outside the message space")
