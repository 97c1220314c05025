"""Mesh construction and ciphertext shardings over ``torch.distributed``.

Counterpart of ``pplp_tpu.parallel.mesh``. A ciphertext batch is laid out
[B, L, n] (batch, RNS limb, coefficient) and sharded over a 3-axis mesh
('dp', 'limb', 'coeff') of ranks, one process per rank. Rank r sits at
``np.arange(world).reshape(dp, limb, coeff)`` == r, the order of the
reference's ``np.asarray(devices).reshape(dp, limb, coeff)``.

A ``Mesh`` holds its shape, this rank's coordinates and one process group
per axis of size > 1 (the ranks that differ from this one in that axis
only), built with ``dist.new_group`` by every rank in the same order. A
mesh made without an initialized process group (or ``rank=`` given) has
no groups: it still answers which block a rank holds.

A sharded dimension of size N over k ranks gives coordinate c the block
[c * ceil(N / k), (c + 1) * ceil(N / k)) clipped to N, the blocks of
``jax.sharding.NamedSharding``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXES", "Mesh", "Sharding", "make_mesh", "factor_devices", "ct_spec",
           "ct_sharding", "block", "shard", "gather", "transport"]

AXES = ("dp", "limb", "coeff")


def factor_devices(n: int) -> tuple[int, int, int]:
    """Split n ranks into (dp, limb, coeff): 2-way dp and limb when
    available, the remaining factor to the coefficient axis (so >= 8 ranks
    exercise all three parallelism kinds)."""
    dp = 1
    if n % 2 == 0:
        dp, n = 2, n // 2
    limb = 1
    if n % 2 == 0:
        limb, n = 2, n // 2
    return dp, limb, n


@dataclass(eq=False)
class Mesh:
    """A (dp, limb, coeff) mesh of ranks seen from one rank."""

    shape: tuple[int, int, int]
    rank: int
    groups: dict = field(default_factory=dict, repr=False)

    @property
    def world(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int | None = None) -> tuple[int, int, int]:
        """(dp, limb, coeff) coordinates of ``rank`` (default this one)."""
        r = self.rank if rank is None else rank
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def size(self, axis: str | None) -> int:
        return 1 if axis is None else self.shape[AXES.index(axis)]

    def coord(self, axis: str | None, rank: int | None = None) -> int:
        return 0 if axis is None else self.coords(rank)[AXES.index(axis)]

    def group(self, axis: str | None):
        """This rank's process group along ``axis`` (None: a single rank)."""
        return None if axis is None else self.groups.get(axis)

    def axis_ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The ranks of ``rank``'s group along ``axis``, by coordinate."""
        c = list(self.coords(rank))
        i = AXES.index(axis)
        out = []
        for k in range(self.shape[i]):
            c[i] = k
            out.append(int(np.ravel_multi_index(c, self.shape)))
        return out


def make_mesh(world: int | None = None, dp: int | None = None, limb: int | None = None,
              coeff: int | None = None, *, rank: int | None = None) -> Mesh:
    """The mesh of ``world`` ranks (default: the process group's size).

    Axes left None come from ``factor_devices``. With an initialized
    process group (and no ``rank=``), every rank must call this in the same
    order: the axis groups are made collectively."""
    live = dist.is_available() and dist.is_initialized() and rank is None
    if world is None:
        world = dist.get_world_size() if live else 1
    if dp is None or limb is None or coeff is None:
        dp, limb, coeff = factor_devices(world)
    if dp * limb * coeff != world:
        raise ValueError(f"mesh axes {dp} x {limb} x {coeff} must use all {world} ranks")
    if live and world != dist.get_world_size():
        raise ValueError(f"a mesh of {world} ranks in a process group of "
                         f"{dist.get_world_size()}")
    mesh = Mesh((dp, limb, coeff), dist.get_rank() if live else (rank or 0))
    if not 0 <= mesh.rank < world:
        raise ValueError(f"rank {mesh.rank} outside a mesh of {world}")
    if live:
        for axis, size in zip(AXES, mesh.shape):
            if size == 1:
                continue
            # Every rank creates every group, in the same order.
            for line in sorted({tuple(mesh.axis_ranks(axis, r)) for r in range(world)}):
                g = dist.new_group(list(line))
                if mesh.rank in line:
                    mesh.groups[axis] = g
    return mesh


def ct_spec(batched: bool = True) -> tuple:
    """Mesh axis of each dimension of a [B, L, n] (or [L, n]) residue tensor."""
    return AXES if batched else AXES[1:]


def block(size: int, parts: int, coord: int) -> slice:
    """The ``coord``-th of ``parts`` blocks of a dimension of ``size``."""
    chunk = -(-size // parts)
    return slice(min(coord * chunk, size), min((coord + 1) * chunk, size))


@dataclass(frozen=True, eq=False)
class Sharding:
    """A mesh and the mesh axis (or None) of each tensor dimension."""

    mesh: Mesh
    spec: tuple

    def index(self, shape, rank: int | None = None) -> tuple[slice, ...]:
        """The block of a tensor of ``shape`` that ``rank`` holds."""
        if len(shape) != len(self.spec):
            raise ValueError(f"shape {tuple(shape)} against spec {self.spec}")
        return tuple(block(s, self.mesh.size(a), self.mesh.coord(a, rank))
                     for s, a in zip(shape, self.spec))

    def indices_map(self, shape) -> dict[int, tuple[slice, ...]]:
        """Every rank's block, as ``NamedSharding.devices_indices_map``."""
        return {r: self.index(shape, r) for r in range(self.mesh.world)}


def ct_sharding(mesh: Mesh, batched: bool = True) -> Sharding:
    return Sharding(mesh, ct_spec(batched))


def shard(x: torch.Tensor, mesh: Mesh, spec=None) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` (a contiguous copy);
    ``spec`` defaults to ``ct_spec`` for a 3- or 2-dimensional ``x``."""
    spec = ct_spec(x.dim() == 3) if spec is None else tuple(spec)
    return x[Sharding(mesh, spec).index(x.shape)].contiguous().clone()


def transport(x: torch.Tensor, group=None) -> torch.Tensor:
    """The tensor a collective of ``group`` (default: every rank) takes for
    ``x``: CUDA data for NCCL; for gloo, ``x`` where it lies (gloo moves a
    CUDA tensor through host memory itself, which is how ranks that share
    one card exchange)."""
    if not x.is_cuda and dist.get_backend(group) == "nccl":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def gather(x: torch.Tensor, mesh: Mesh, spec=None) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` (the inverse of
    ``shard``), on every rank. Blocks follow ``block``'s rule, so a block's
    offset along a dimension is its coordinate times the largest block."""
    spec = ct_spec(x.dim() == 3) if spec is None else tuple(spec)
    if mesh.world == 1:
        return x
    sizes = transport(torch.tensor(x.shape, dtype=torch.int64))
    shapes = [torch.empty_like(sizes) for _ in range(mesh.world)]
    dist.all_gather(shapes, sizes)
    shapes = [tuple(int(v) for v in s.tolist()) for s in shapes]
    top = [max(s[d] for s in shapes) for d in range(x.dim())]
    padded = x.new_zeros(top)
    padded[tuple(slice(0, s) for s in x.shape)] = x
    wire = transport(padded)
    parts = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(parts, wire)

    def at(r):
        return tuple(slice(mesh.coord(a, r) * top[d], mesh.coord(a, r) * top[d] + shapes[r][d])
                     for d, a in enumerate(spec))

    out = x.new_empty([max((at(r)[d].stop for r in range(mesh.world) if shapes[r][d]),
                           default=0) for d in range(x.dim())])
    for r, part in enumerate(parts):
        out[at(r)] = part[tuple(slice(0, s) for s in shapes[r])].to(x.device)
    return out
