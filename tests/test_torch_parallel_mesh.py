"""The port's mesh, shardings and multi-process launcher against the reference.

* ``factor_devices`` equals ``pplp_tpu.parallel.mesh.factor_devices`` for
  1..64 ranks;
* every rank's block of a [B, L, n] (and an [L, n]) tensor equals the
  block ``NamedSharding(make_mesh(...), ct_spec()).devices_indices_map``
  gives the device at the same place of the reference's 8-device mesh, for
  (dp, limb, coeff) = (2, 2, 2), (2, 1, 4), (1, 1, 8), (2, 4, 1);
* ``local_batch_slice`` as the reference computes it;
* in 4 gloo processes on the CPU (``parallel/multiproc_smoke.py``): each
  axis group holds the ranks its coordinates say (an all-reduce of the
  ranks), and ``gather`` inverts ``shard``;
* a rank that raises ends the launch with ``RankFailure`` well inside its
  timeout.

Exact comparisons throughout (index ranges and integers).
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from pplp_tpu.parallel import distributed as rdistributed
from pplp_tpu.parallel import mesh as rmesh
from pplp_tpu_torch.parallel import distributed, mesh
from pplp_tpu_torch.parallel.multiproc_smoke import RankFailure, launch

SHAPE = (4, 8, 64)  # [B, L, n]: every axis divides it at the meshes below
MESHES = [(2, 2, 2), (2, 1, 4), (1, 1, 8), (2, 4, 1)]


def _norm(index, shape):
    return [s.indices(size)[:2] for s, size in zip(index, shape)]


def test_factor_devices_matches_reference():
    for n in range(1, 65):
        assert mesh.factor_devices(n) == rmesh.factor_devices(n)


@pytest.mark.parametrize("axes", MESHES)
def test_blocks_match_named_sharding(axes):
    devices = jax.devices()
    assert len(devices) == 8, "conftest should force 8 CPU devices"
    jmesh = rmesh.make_mesh(devices, *axes)
    for batched, shape in ((True, SHAPE), (False, SHAPE[1:])):
        want = NamedSharding(jmesh, rmesh.ct_spec(batched)).devices_indices_map(shape)
        for r, dev in enumerate(devices):
            sh = mesh.ct_sharding(mesh.make_mesh(8, *axes, rank=r), batched)
            assert _norm(sh.index(shape), shape) == _norm(want[dev], shape)
        assert len(sh.indices_map(shape)) == 8


def test_uneven_blocks_clip_at_the_end():
    m = mesh.make_mesh(4, 1, 1, 4, rank=3)
    assert mesh.block(5, 4, 3) == slice(5, 5)  # chunks of 2: 2, 2, 1, 0
    assert mesh.ct_sharding(m).index((1, 3, 10))[2] == slice(9, 10)


def test_local_batch_slice():
    jm = rmesh.make_mesh(jax.devices(), 2, 2, 2)
    assert distributed.local_batch_slice(16, mesh.make_mesh(1)) == \
        rdistributed.local_batch_slice(16, jm)  # one process: every row
    for r in range(4):
        assert distributed.local_batch_slice(16, mesh.make_mesh(4, rank=r)) == \
            slice(4 * r, 4 * r + 4)


def test_mesh_refuses_axes_that_do_not_cover_the_ranks():
    with pytest.raises(ValueError, match="must use all"):
        mesh.make_mesh(8, 2, 2, 3, rank=0)
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize_multihost("tcp://127.0.0.1:1", 1, 0, backend="mpi")


def test_groups_and_gather_in_four_processes():
    # 5 rows: blocks of 3 and 2 at dp = 2, of 2, 2, 1 and 0 at dp = 4.
    x = torch.arange(5 * 6 * 64, dtype=torch.int64).reshape(5, 6, 64)
    axes = [(2, 1, 2), (1, 2, 2), (4, 1, 1), (1, 1, 4)]
    res = launch({"device": "cpu", "jobs": [{"kind": "mesh", "mesh": a, "x": x}
                                            for a in axes]}, 4, timeout_s=120)
    for j, a in enumerate(axes):
        grid = np.arange(4).reshape(a)
        for r, out in enumerate(res):
            got = out["results"][j]
            assert got["coords"] == [int(c) for c in np.argwhere(grid == r)[0]]
            assert got["gather_ok"] == [True, True]
            for axis, (summed, want) in got["sums"].items():
                assert summed == want
            assert set(got["sums"]) == {ax for ax, s in zip(mesh.AXES, a) if s > 1}


def test_a_failing_rank_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="planned failure"):
        launch({"device": "cpu", "jobs": [{"kind": "fail", "mesh": (1, 1, 2)}]}, 2,
               timeout_s=90)
    assert time.monotonic() - t0 < 60  # the waiting rank was killed, not timed out


def test_launch_runs_on_the_card_unless_asked(monkeypatch):
    """A spec without ``device`` runs its ranks on the card, so without one
    the launcher raises before it starts any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch({"jobs": [{"kind": "fail", "mesh": (1, 1, 2)}]}, 2, timeout_s=30)
    with pytest.raises(ValueError, match="device"):
        launch({"device": "gpu", "jobs": []}, 1, timeout_s=30)
