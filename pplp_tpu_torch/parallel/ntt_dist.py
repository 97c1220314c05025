"""Distributed negacyclic NTT: the coefficient/limb exchange over a mesh axis.

Counterpart of ``make_dist_ntt`` and ``pointwise_mul_dist``
(``pplp_tpu/parallel/ntt_dist.py``). The reference shards the coefficient
axis of its four-step engine (``ops/ntt4``) and runs one all-to-all inside
every transform, between the column passes. The port has no four-step
engine: its transforms are whole-row kernels (one row of n coefficients per
limb per block, ``csrc/ntt.cu``), so it distributes the same work over two
layouts of a [..., L, n] tensor among the S ranks of a ``coeff`` group:

* **C (coefficients)**: a rank holds every limb of its n/S coefficients
  (the block ``mesh.shard`` gives). The coefficient-wise steps run here.
* **R (rows)**: a rank holds whole rows of its share of the limbs
  (``limb_splits``: as even as L allows, so L need not divide by S). The
  transforms and the spectrum-pointwise products run here, on the rank's
  sub-table.

``to_rows`` and ``to_coeffs`` switch between them with one
``all_to_all_single``: a rank sends ((S - 1) / S) of its words, the same
bisection volume the reference moves per transform. ``forward`` takes a C
block [..., L_blk, n/S] to R spectra [..., L_r, n] in the port's spectrum
order (one exchange, then the rank's transform); ``inverse`` mirrors it.
The reference's ``coeff_view``/``flat_view`` (the four-step engine's 2-D
view of a row) have no counterpart: no rank ever holds part of a row in R.

A ``limb`` mesh axis shards the limbs first (``mesh.block``); the ``coeff``
group then splits the rank's limb block. The batch is whatever the caller
sharded (``batch_axis``, for ``shard``). Requires S | n.

Every exchange goes through ``_all_to_all``, which counts it in
``exchanges`` (calls, bytes this rank sent to others and, while timed,
seconds): ``reset_exchanges`` before a call, read them after it.

Transport (``mesh.transport``): gloo takes CUDA tensors as they are and
moves them through host memory itself (torch 2.11: ``all_to_all_single`` of
int32 and int64 CUDA tensors, uneven splits included), which is how ranks
that share one card exchange; an NCCL collective gets the data on the card.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..ops import ntt
from .mesh import block, shard, transport

__all__ = ["DistNtt", "make_dist_ntt", "pointwise_mul_dist", "limb_splits", "to_rows",
           "to_coeffs", "exchanges", "reset_exchanges"]


@dataclass
class Exchanges:
    """The exchanges since ``reset_exchanges``: how many, the bytes this
    rank sent to other ranks and, while ``timed``, their seconds on the host
    clock, the device synchronized before and after each (so a timed call
    runs slower than an untimed one)."""

    calls: int = 0
    bytes_sent: int = 0
    seconds: float = 0.0
    timed: bool = False


exchanges = Exchanges()


def reset_exchanges(timed: bool = False) -> None:
    exchanges.calls, exchanges.bytes_sent, exchanges.seconds = 0, 0, 0.0
    exchanges.timed = timed


def limb_splits(L: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of ``parts`` ranks' limbs: the first L mod parts
    ranks take one limb more."""
    base, extra = divmod(L, parts)
    out, lo = [], 0
    for j in range(parts):
        hi = lo + base + (j < extra)
        out.append((lo, hi))
        lo = hi
    return out


def _all_to_all(send: torch.Tensor, in_sizes, out_sizes, group) -> torch.Tensor:
    if group is None:  # one rank: the exchange is the identity
        return send
    exchanges.calls += 1
    exchanges.bytes_sent += (send.numel() - in_sizes[dist.get_rank(group)]) * send.element_size()
    if exchanges.timed and send.is_cuda:
        torch.cuda.synchronize(send.device)
    t0 = time.perf_counter()
    wire = transport(send, group)
    out = torch.empty(sum(out_sizes), dtype=wire.dtype, device=wire.device)
    dist.all_to_all_single(out, wire, list(out_sizes), list(in_sizes), group=group)
    out = out.to(send.device)
    if exchanges.timed:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        exchanges.seconds += time.perf_counter() - t0
    return out


def _own(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and 16-byte aligned, as the kernels take it."""
    return x if x.is_contiguous() and x.data_ptr() % 16 == 0 else x.clone(
        memory_format=torch.contiguous_format)


def to_rows(parts, splits, group, me: int) -> list[torch.Tensor]:
    """C -> R. ``parts``: C blocks [..., L_i, w] of one dtype, all of w
    coefficients; ``splits[i]``: part i's (lo, hi) limbs for each of the
    group's S ranks; ``me``: this rank's place in the group. Returns each
    part's rows [..., hi - lo, S w] of this rank's limbs, in one exchange."""
    S = len(splits[0])
    w = parts[0].shape[-1]
    flats = [x.reshape(math.prod(x.shape[:-2]), x.shape[-2], w) for x in parts]
    send = torch.cat([f[:, lo:hi, :].reshape(-1) for j in range(S)
                      for f, sp in zip(flats, splits) for lo, hi in [sp[j]]])
    in_sizes = [sum(f.shape[0] * (sp[j][1] - sp[j][0]) * w for f, sp in zip(flats, splits))
                for j in range(S)]
    mine = [f.shape[0] * (sp[me][1] - sp[me][0]) * w for f, sp in zip(flats, splits)]
    recv = _all_to_all(send, in_sizes, [sum(mine)] * S, group).view(S, sum(mine))
    out, at = [], 0
    for x, f, sp, size in zip(parts, flats, splits, mine):
        Lm = sp[me][1] - sp[me][0]
        piece = recv[:, at:at + size].reshape(S, f.shape[0], Lm, w).permute(1, 2, 0, 3)
        out.append(_own(piece.reshape(tuple(x.shape[:-2]) + (Lm, S * w))))
        at += size
    return out


def to_coeffs(parts, splits, group, me: int) -> list[torch.Tensor]:
    """R -> C, the inverse of ``to_rows``: rows [..., L_me_i, n] of this
    rank's limbs -> each part's C block [..., L_i, n/S], in one exchange."""
    S = len(splits[0])
    w = parts[0].shape[-1] // S
    lead = [math.prod(x.shape[:-2]) for x in parts]
    chunks = [x.reshape(P, x.shape[-2], S, w).permute(2, 0, 1, 3).reshape(S, -1)
              for x, P in zip(parts, lead)]
    send = torch.cat(chunks, dim=1).reshape(-1)
    out_sizes = [sum(P * (sp[j][1] - sp[j][0]) * w for P, sp in zip(lead, splits))
                 for j in range(S)]
    recv = _all_to_all(send, [send.numel() // S] * S, out_sizes, group)
    pieces = [[] for _ in parts]
    at = 0
    for j in range(S):
        for i, (P, sp) in enumerate(zip(lead, splits)):
            size = P * (sp[j][1] - sp[j][0]) * w
            pieces[i].append(recv[at:at + size].view(P, sp[j][1] - sp[j][0], w))
            at += size
    return [_own(torch.cat(p, dim=1).reshape(tuple(x.shape[:-2]) + (sp[-1][1], w)))
            for p, x, sp in zip(pieces, parts, splits)]


class DistNtt:
    """The forward and inverse negacyclic NTT of one chain over a mesh's
    ``coeff`` axis (see the module's docstring for the two layouts)."""

    def __init__(self, tables: ntt.NttTables, mesh, coeff_axis: str = "coeff",
                 batch_axis: str | None = None, limb_axis: str | None = None):
        S = mesh.size(coeff_axis)
        if tables.n % S:
            raise ValueError(f"{S} coefficient shards do not divide n = {tables.n}")
        self.mesh, self.S = mesh, S
        self.coeff_axis, self.batch_axis, self.limb_axis = coeff_axis, batch_axis, limb_axis
        self.group = mesh.group(coeff_axis)
        self.me = mesh.coord(coeff_axis)
        self.limb_block = block(tables.L, mesh.size(limb_axis), mesh.coord(limb_axis))
        self.splits = limb_splits(self.limb_block.stop - self.limb_block.start, S)
        lo, hi = self.splits[self.me]
        self.limbs = slice(self.limb_block.start + lo, self.limb_block.start + hi)
        self.coeffs = block(tables.n, S, self.me)
        # The rank's sub-table; None where it holds no limb in R.
        self.tables = tables.limbs(self.limbs) if hi > lo else None

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's C block of a whole [B, L, n] tensor."""
        return shard(x, self.mesh, (self.batch_axis, self.limb_axis, self.coeff_axis))

    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        return to_rows([x], [self.splits], self.group, self.me)[0]

    def to_coeffs(self, y: torch.Tensor) -> torch.Tensor:
        return to_coeffs([y], [self.splits], self.group, self.me)[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """C block [..., L_blk, n/S] -> R spectra [..., L_r, n]."""
        rows = self.to_rows(x)
        return rows if self.tables is None else ntt.forward(rows, self.tables)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        """R spectra [..., L_r, n] -> C block [..., L_blk, n/S]."""
        rows = y if self.tables is None else ntt.inverse(y, self.tables)
        return self.to_coeffs(rows)


def make_dist_ntt(tables: ntt.NttTables, mesh, coeff_axis: str = "coeff",
                  batch_axis: str | None = None, limb_axis: str | None = None) -> DistNtt:
    """The distributed transform of ``tables`` over ``mesh``: its
    ``forward`` and ``inverse``, and the rank's sub-table ``tables``."""
    return DistNtt(tables, mesh, coeff_axis, batch_axis, limb_axis)


def pointwise_mul_dist(a: torch.Tensor, b: torch.Tensor, dn: DistNtt) -> torch.Tensor:
    """Residue-wise product of R spectra with the rank's sub-table."""
    return a if dn.tables is None else ntt.pointwise_mul(a, b, dn.tables)
