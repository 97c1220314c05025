"""Plain reference of the proximity test, written from the protocol.

The server blinds the squared distance d^2 as bd = s (d^2 + r) mod t and
sends w || filter, where the filter holds the keys ((s (di + r) mod M) <<
bitlen(w)) | w of every di < radius^2 (M = 2^64 in the demo, as the
reference's ``./pplp`` inserts them; M = t in the batched pipeline, which
reduces the blind distance mod t first). The client's verdict is near iff
the key of the blind distance it decrypted is in the filter. Plain
PyTorch and Python integers on any device; nothing here comes from the
program under test.

``fpp_of`` is where a control weakens the configuration: it builds the
filter at the square root of the stated false-positive rate.
"""

from __future__ import annotations

import math
import struct

import torch

from .bloom import KEYS_A_PASS, M32, PlainBloom

M64 = (1 << 64) - 1


def fpp_of(stated: float, control: str | None) -> float:
    if control is None:
        return stated
    if control == "weak_filter":
        return math.sqrt(stated)
    raise ValueError(f"no control named {control!r}")


def key_words(bd: torch.Tensor, w: int):
    """((bd << bitlen(w)) | w) mod 2^64 as (lo, hi) 32-bit words, for
    0 <= bd < 2^63 and 0 < w < 2^31."""
    w_len = w.bit_length()
    lo = ((bd & ((1 << (32 - w_len)) - 1)) << w_len) | w
    hi = (bd >> (32 - w_len)) & M32
    return lo, hi


def server_filter(radius: int, s: int, r: int, w: int, modulus: int, fpp: float, seed: int,
                  mixed: bool, device) -> PlainBloom:
    """The server's filter: the keys of s (di + r) mod ``modulus``, di < r^2."""
    sq = radius * radius
    if s * (sq - 1 + r) >= 1 << 63:
        raise ValueError("s (r^2 + r) reaches 2^63: out of this reference's int64 range")
    bf = PlainBloom(sq, fpp, seed, mixed, device)
    for start in range(0, sq, KEYS_A_PASS):
        di = torch.arange(start, min(sq, start + KEYS_A_PASS), dtype=torch.int64, device=device)
        bd = s * (di + r)  # below 2^63, so already reduced mod 2^64
        bf.insert(*key_words(bd % modulus if modulus < 1 << 63 else bd, w))
    return bf


def blind_distance(d2: int, s: int, r: int, t: int) -> int:
    return s * (d2 + r) % t


def demo_test(test, radius: int, t: int, fpp: float, bf_seed: int, mixed: bool, device,
              wire: bool, control: str | None = None) -> dict:
    """What one demo test must give: the blind distance, the verdict and,
    with ``wire``, the w || filter message. Without the filter the verdict
    is d^2 < r^2, which the filter's own answer equals unless a far key is
    a false positive (at most the stated fpp)."""
    bd = blind_distance(test.d2, test.s, test.r, t)
    out = {"blind_distance": bd, "near": test.d2 < radius * radius}
    if wire:
        bf = server_filter(radius, test.s, test.r, test.w, 1 << 64,
                           fpp_of(fpp, control), bf_seed, mixed, device)
        member, _ = bf.probe(*key_words(torch.tensor([bd], device=device), test.w))
        out["near"] = bool(member[0])
        out["wire"] = struct.pack("<Q", test.w) + bf.serialize()
    return out


def packed_checks(xa, ya, xb: int, yb: int, radius: int, s: int, w: int, t: int, fpp: float,
                  bf_seed: int, mixed: bool, device, control: str | None = None,
                  bf: PlainBloom | None = None):
    """Verdicts of a batch of checks against a server at (xb, yb) whose
    blinding r is the radius (the batched deployment's filter), and the
    salts a first-clear-bit probe tests for each: (near bool [N], tested
    int [N], the filter)."""
    if bf is None:
        bf = server_filter(radius, s, radius, w, t, fpp_of(fpp, control), bf_seed, mixed,
                           device)
    x = torch.as_tensor(xa.astype("int64"), device=device) - xb
    y = torch.as_tensor(ya.astype("int64"), device=device) - yb
    bd = (s * (x * x + y * y + radius)) % t
    near, tested = bf.probe(*key_words(bd, w))
    return near, tested, bf
