"""The one generator of the benchmark's traffic, read from a mix's file.

A mix (``traffic/<name>.json``) holds parameters only: the radius, the
share of near checks, how far a far check lies (``far_radius_factor``: r
<= d < factor * r), the coordinate span, and for batched checks the rows a
step and the batches cycled. Everything is drawn from the run's seed; the
same seed gives the same tests and batches, and every seed the same sizes
and the same share of near checks, in another order and at other places.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Streams of one seed, kept apart.
_TESTS, _BATCHES, _KEYS = 1, 2, 3


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a seed (any integer, taken mod 2^64)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def offsets(g: np.random.Generator, near: np.ndarray, radius: int, far_factor: int):
    """Integer offsets (dx, dy) from the server: d^2 < r^2 where ``near``,
    r^2 <= d^2 < (far_factor r)^2 elsewhere, uniform over those lattice
    points."""
    count = near.shape[0]
    dx = np.zeros(count, np.int64)
    dy = np.zeros(count, np.int64)
    for want, lo2, hi in ((near, 0, radius), (~near, radius * radius, far_factor * radius)):
        idx = np.flatnonzero(want)
        filled = 0
        while filled < idx.shape[0]:
            need = idx.shape[0] - filled
            x = g.integers(-(hi - 1), hi, 2 * need + 64)
            y = g.integers(-(hi - 1), hi, 2 * need + 64)
            d2 = x * x + y * y
            ok = np.flatnonzero((d2 >= lo2) & (d2 < hi * hi))[:need]
            dx[idx[filled:filled + ok.shape[0]]] = x[ok]
            dy[idx[filled:filled + ok.shape[0]]] = y[ok]
            filled += ok.shape[0]
    return dx, dy


class Sample:
    """The units whose outputs a run keeps for the check: every ``every``-th,
    from one of the first three drawn from the seed."""

    def __init__(self, seed: int, every: int):
        self.every = every
        self.offset = int(rng(seed).integers(0, min(every, 3)))

    def __contains__(self, i: int) -> bool:
        return i >= self.offset and (i - self.offset) % self.every == 0


def near_mask(g: np.random.Generator, count: int, share: float) -> np.ndarray:
    """Exactly round(count * share) near entries, in a drawn order."""
    mask = np.zeros(count, bool)
    mask[:round(count * share)] = True
    return g.permutation(mask)


@dataclass(frozen=True)
class Test:
    """One proximity test: both parties' coordinates, the server's blinding
    (s, r, w) and the seed of the client's keys and encryption noise."""
    near: bool
    xa: int
    ya: int
    xb: int
    yb: int
    s: int
    r: int
    w: int
    key_seed: int

    @property
    def d2(self) -> int:
        return (self.xa - self.xb) ** 2 + (self.ya - self.yb) ** 2


def blinding_bits(t_bits: int, sq_radius: int) -> tuple[int, int]:
    """(bits of r, bits of s) such that s (d^2 + r) < t for every near d^2,
    the sound protocol's bound: r gets 8 to 20 bits, s the headroom left."""
    r_bits = min(20, max(8, t_bits // 2 - sq_radius.bit_length()))
    span_bits = (sq_radius - 1 + (1 << r_bits)).bit_length()
    return r_bits, max(1, t_bits - span_bits - 1)


class DemoTraffic:
    """Back-to-back single tests (a closed loop of one client). Test i is
    drawn from (seed, i) alone, so any prefix of the stream is the same for
    a seed; the near tests are spread evenly, ``near_share`` of every
    prefix to within one test."""

    def __init__(self, mix: dict, t_bits: int, seed: int):
        self.radius = int(mix["radius"])
        self.share = float(mix["near_share"])
        self.factor = int(mix["far_radius_factor"])
        self.span = int(mix["coordinate_span"])
        self.t_bits, self.seed = t_bits, int(seed)
        self.phase = rng(seed, _TESTS).random()
        self.r_bits, self.s_bits = blinding_bits(t_bits, self.radius * self.radius)
        if self.span <= 2 * self.factor * self.radius:
            raise ValueError("the coordinate span holds no server with room for a far client")

    def test(self, i: int) -> Test:
        near = int((i + 1) * self.share + self.phase) > int(i * self.share + self.phase)
        g = rng(self.seed, _TESTS, i)
        edge = self.factor * self.radius
        xb, yb = (int(v) for v in g.integers(edge, self.span - edge, 2))
        dx, dy = offsets(g, np.array([near]), self.radius, self.factor)
        return Test(
            near=near, xa=xb + int(dx[0]), ya=yb + int(dy[0]), xb=xb, yb=yb,
            s=int(g.integers(0, 1 << self.s_bits)) | 1, r=int(g.integers(0, 1 << self.r_bits)),
            w=int(g.integers(1, 1 << 16)), key_seed=int(g.integers(0, 1 << 62)))


class BatchTraffic:
    """``batches`` batches of ``rows * n`` coefficient-packed checks around
    a fixed server, cycled step after step."""

    def __init__(self, mix: dict, n: int, xb: int, yb: int, seed: int):
        self.radius = int(mix["radius"])
        self.rows, self.batches, self.n = int(mix["rows"]), int(mix["batches"]), n
        self.share = float(mix["near_share"])
        self.factor = int(mix["far_radius_factor"])
        self.xb, self.yb, self.seed = xb, yb, int(seed)
        if min(xb, yb) < self.factor * self.radius:
            raise ValueError("a far check would leave the plane: move the server or the radius")

    @property
    def checks(self) -> int:
        return self.rows * self.n

    def batch(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        """Client coordinates (xa, ya), uint64 [rows * n], of batch ``b``."""
        g = rng(self.seed, _BATCHES, b)
        near = near_mask(g, self.checks, self.share)
        dx, dy = offsets(g, near, self.radius, self.factor)
        return ((self.xb + dx).astype(np.uint64), (self.yb + dy).astype(np.uint64))

    def key_seed(self) -> int:
        return int(rng(self.seed, _KEYS).integers(0, 1 << 62))
