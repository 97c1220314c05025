"""Multi-process setup on ``torch.distributed``.

Counterpart of ``pplp_tpu.parallel.distributed``. One protocol role's
compute can span several ranks, one process each; the role-to-role link
stays the framed TCP channel. Each process calls, before any collective:

    from pplp_tpu_torch.parallel.distributed import initialize_multihost, global_mesh
    initialize_multihost("tcp://10.0.0.1:29500", num_processes=4, process_id=<rank>,
                         backend="nccl")
    mesh = global_mesh()            # dp x limb x coeff over every rank

or, under ``torchrun``, ``initialize_multihost(backend="nccl")`` (its
environment names the store, the world size and the rank).

The backend is the caller's choice and is never changed behind its back:
``"nccl"`` when every rank has a card of its own (the rank's
``LOCAL_RANK``, else its process id modulo the cards present, becomes the
current device), ``"gloo"`` for ranks on the CPU and for ranks that share
one card (NCCL refuses two ranks on one device). Gloo moves a CUDA tensor
through host memory itself (``mesh.transport``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import factor_devices, make_mesh

__all__ = ["initialize_multihost", "global_mesh", "local_batch_slice", "BACKENDS"]

BACKENDS = ("nccl", "gloo")


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, *, backend: str,
                         timeout_s: float = 600.0):
    """``dist.init_process_group`` with an explicit store or torchrun's.

    ``coordinator``: a ``tcp://host:port`` or ``file://path`` address
    (``host:port`` alone means tcp), or None for the ``env://`` variables
    torchrun sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``timeout_s`` bounds every collective and the rendezvous."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator is None:
        init = "env://"
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device on every rank")
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def global_mesh(dp: int | None = None, limb: int | None = None, coeff: int | None = None):
    """The mesh over every rank of the process group."""
    world = dist.get_world_size()
    if dp is None or limb is None or coeff is None:
        dp, limb, coeff = factor_devices(world)
    return make_mesh(world, dp, limb, coeff)


def local_batch_slice(global_batch: int, mesh) -> slice:
    """The [start, stop) batch rows this process feeds into a batch split
    evenly over the processes (one process per rank)."""
    per = global_batch // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)
