"""Multi-process runs of the sharded paths: a rank worker and its launcher.

Counterpart of ``scripts/multiproc_smoke.py``. ``launch(spec, nproc)``
writes ``spec`` to a file, starts ``nproc`` fresh interpreters (a new
process each, never a fork) running

    python -m pplp_tpu_torch.parallel.multiproc_smoke <rank> <nproc> <init> <job>

which join one gloo process group through a ``file://`` store in a
temporary directory, run the spec's jobs in order (each on a mesh of its
own) and write their results to ``<job>.rank<r>.pt``. The launcher kills
every rank when one fails or the timeout passes, and raises with the
failed ranks' output; else it returns each rank's results.

A spec is a dict: ``device`` ("cuda", the default: every rank on card 0,
and the launcher raises without one; or "cpu") and ``jobs``, each a dict
with a ``kind`` (``JOBS``), a ``mesh`` (dp, limb, coeff) and the kind's
inputs, whole tensors that every rank cuts its block from. Index ranges
come back as (start, stop) pairs. Each job reports its counted call's
exchanges (``exchanges``, ``bytes_sent``) and, on a card, its kernel
launches (``launches``). Kernels are built before ranks start
(``cuda_build.build``): ranks only load them. A rank runs torch on one CPU
thread (tests start several launches side by side).
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["launch", "RankFailure", "JOBS", "seeded_case", "median_s"]

ROOT = Path(__file__).resolve().parent.parent.parent


class RankFailure(RuntimeError):
    """A rank exited non-zero or the run outlived its timeout."""


def launch(spec: dict, nproc: int, timeout_s: float = 120.0) -> list[dict]:
    """Run ``spec`` on ``nproc`` ranks; each rank's saved results."""
    spec = {"device": "cuda", **spec, "timeout_s": timeout_s}
    _device(spec["device"])  # raises before any rank starts
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save(spec, job)
        init = "file://" + os.path.join(tmp, "store")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nproc)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pplp_tpu_torch.parallel.multiproc_smoke", str(r),
             str(nproc), init, job], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
            for r in range(nproc)]
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                late = time.monotonic() > deadline
                if failed or late:
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    why = (f"rank(s) {failed} failed" if failed
                           else f"ranks still running after {timeout_s:.0f} s")
                    # Every rank's output: the first to fail may be one that
                    # saw another's failure in a collective.
                    raise RankFailure(f"{why}:\n" + "\n".join(
                        f"--- rank {r} ---\n{_tail(logs[r])}" for r in range(nproc)))
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        return [torch.load(f"{job}.rank{r}.pt", weights_only=True) for r in range(nproc)]


def _tail(f, size: int = 4000) -> str:
    f.flush()
    f.seek(0)
    return f.read()[-size:]


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


def _device(name: str) -> torch.device:
    from ..device import cuda_device

    if name == "cuda":
        return cuda_device()
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")


def _span(s: slice) -> list[int]:
    return [s.start, s.stop]


def _ctx(job, dev):
    from ..bfv import BFVContext, EncryptionParameters

    parms = EncryptionParameters.bfv(job["n"], job["t"], coeff_modulus=list(job["moduli"]))
    return BFVContext.build(parms, dev)


def _launch_counts() -> dict:
    from ..ops import behz_cuda, bloom_cuda, ntt_cuda

    return {**ntt_cuda.launches_by_kernel, **behz_cuda.launches_by_kernel,
            **bloom_cuda.launches_by_kernel}


def _reset_launches(dev):
    if dev.type == "cuda":
        from ..ops import behz_cuda, bloom_cuda, ntt_cuda

        torch.cuda.synchronize(dev)
        ntt_cuda.reset_launches()
        behz_cuda.reset_launches()
        bloom_cuda.reset_launches()


def _counted(dev, fn):
    """fn()'s result and what it did: its exchanges, the bytes this rank
    sent in them and, on a card, the kernel launches it made."""
    from .ntt_dist import exchanges, reset_exchanges

    _reset_launches(dev)
    reset_exchanges()
    out = fn()
    _sync(dev)
    return out, {"exchanges": exchanges.calls, "bytes_sent": exchanges.bytes_sent,
                 "launches": _launch_counts() if dev.type == "cuda" else {}}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_s(dev, group, fn, iters: int) -> float:
    """Median seconds of ``fn`` over ``iters`` runs (``run_s``)."""
    return statistics.median(run_s(dev, group, fn, iters))


def run_s(dev, group, fn, iters: int) -> list[float]:
    """Seconds of each of ``iters`` runs of ``fn``, the ranks of ``group``
    starting each together: CUDA events around each run on a card (the
    stream idles through the host-side waits of an exchange, so they count),
    the host clock on the CPU."""
    times = []
    for _ in range(iters):
        _sync(dev)
        if group is not None:
            dist.barrier(group)
        if dev.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return times


def split_ms(dev, group, fn, iters: int) -> dict:
    """A call's median ms (``ms``), then ``iters`` more runs with every
    exchange timed inside the call (``ntt_dist.exchanges``: the device
    synchronized around each): their median ms (``timed_ms``), the median of
    the exchanges' ms a run (``exchange_ms``) and of the rest, the run's time
    less its exchanges (``rest_ms``: kernels, packing, launch gaps); the bytes
    this rank sends a call (``call_bytes``)."""
    from .ntt_dist import exchanges, reset_exchanges

    ms = 1e3 * median_s(dev, group, fn, iters)
    spent = []

    def timed():
        reset_exchanges(timed=True)
        fn()
        spent.append(exchanges.seconds)

    runs = run_s(dev, group, timed, iters)
    exchanges.timed = False
    return {"ms": ms, "timed_ms": 1e3 * statistics.median(runs),
            "exchange_ms": 1e3 * statistics.median(spent),
            "rest_ms": 1e3 * statistics.median(t - e for t, e in zip(runs, spent)),
            "call_bytes": exchanges.bytes_sent}


def job_mesh(job, mesh, dev):
    """The axis groups hold the ranks their coordinates say, and ``gather``
    inverts ``shard`` for a [B, L, n] and a [B, n] tensor."""
    from .mesh import AXES, gather, shard

    sums = {}
    for axis in AXES:
        g = mesh.group(axis)
        if g is None:
            continue
        v = torch.tensor([mesh.rank], dtype=torch.int64)
        dist.all_reduce(v, group=g)
        sums[axis] = [int(v), sum(mesh.axis_ranks(axis))]
    x = job["x"].to(dev)
    ok = [bool(torch.equal(gather(shard(t, mesh, spec), mesh, spec), t))
          for t, spec in ((x, None), (x[:, 0], ("dp", "coeff")))]
    return {"coords": list(mesh.coords()), "sums": sums, "gather_ok": ok}


def job_fail(job, mesh, dev):
    """The last rank raises; the others wait for it in a barrier."""
    if mesh.rank == mesh.world - 1:
        raise RuntimeError("the planned failure of the last rank")
    dist.barrier()
    return {}


def job_ntt(job, mesh, dev):
    """The distributed transform of ``x``: its R spectra, the round trip
    and the negacyclic product with ``y``, each this rank's block."""
    from ..ops import ntt
    from ..ops.primes import Modulus
    from .ntt_dist import make_dist_ntt, pointwise_mul_dist

    tb = ntt.build_tables([Modulus(q) for q in job["moduli"]], job["n"], dev)
    dn = make_dist_ntt(tb, mesh, batch_axis=job.get("batch_axis"),
                       limb_axis=job.get("limb_axis"))
    x, y = dn.shard(job["x"].to(dev)), dn.shard(job["y"].to(dev))

    def run():
        spec = dn.forward(x)
        prod = dn.inverse(pointwise_mul_dist(spec, dn.forward(y), dn))
        return spec, dn.inverse(spec), prod

    (spec, back, prod), did = _counted(dev, run)
    out = {"spec": spec.cpu(), "back": back.cpu(), "prod": prod.cpu(), **did,
           "limbs": _span(dn.limbs), "limb_block": _span(dn.limb_block),
           "coeffs": _span(dn.coeffs),
           "batch": _span(_batch_block(job["x"].shape[0], mesh, job.get("batch_axis")))}
    if job.get("time_iters"):
        out.update(split_ms(dev, dn.group, lambda: dn.inverse(dn.forward(x)),
                            job["time_iters"]))
    return out


def _batch_block(B, mesh, axis):
    from .mesh import block

    return block(B, mesh.size(axis), mesh.coord(axis))


def seeded_case(ctx, seed: int, batch: int, width: int):
    """(relinearization keys of ``width``, ct1, ct2 of ``batch`` rows of
    random residues), drawn on ``ctx``'s device from ``seed``: the same
    tensors in every process on the same kind of device."""
    from ..bfv import behz, sampling
    from ..bfv.ciphertext import Ciphertext
    from ..bfv.keys import SecretKey, shoup
    from ..ops import ntt

    g = torch.Generator(device=ctx.device).manual_seed(seed)
    s_ntt = ntt.forward(sampling.ternary_poly(g, ctx), ctx.tables)
    rlk = behz.create_relin_keys(ctx, SecretKey(s_ntt=s_ntt, s_shoup=shoup(ctx, s_ntt)), g,
                                 width=width)
    polys = [torch.randint(0, 1 << 62, (batch, ctx.L, ctx.n), generator=g, device=ctx.device,
                           dtype=torch.int64) % ctx.q2 for _ in range(4)]
    return rlk, Ciphertext(tuple(polys[:2])), Ciphertext(tuple(polys[2:]))


def job_behz(job, mesh, dev):
    """``DistMultiplier.multiply_relinearize`` of ``ct1`` x ``ct2`` with the
    keys ``keys`` (leaves and groups), or of ``seeded_case(seed, batch,
    width)``: this rank's block of the result."""
    from ..bfv import behz
    from ..bfv.ciphertext import Ciphertext
    from .behz_dist import DistMultiplier

    ctx = _ctx(job, dev)
    if "seed" in job:
        rlk, ct1, ct2 = seeded_case(ctx, job["seed"], job["batch"], job["width"])
    else:
        k = job["keys"]
        rlk = behz.KSwitchKeys(*(k[name].to(dev) for name in ("k0", "k0_shoup", "k1",
                                                               "k1_shoup")),
                               groups=tuple(tuple(g) for g in k["groups"]))
        ct1, ct2 = (Ciphertext(tuple(p.to(dev) for p in job[name])) for name in ("ct1", "ct2"))
    B = ct1.polys[0].shape[0]
    dm = DistMultiplier(ctx, rlk, mesh, batch_axis=job.get("batch_axis"))
    ct1, ct2 = dm.shard_ciphertext(ct1), dm.shard_ciphertext(ct2)
    out, did = _counted(dev, lambda: dm.multiply_relinearize(ct1, ct2))
    res = {"out": torch.stack(out.polys).cpu(), **did, "coeffs": _span(dm.coeffs),
           "batch": _span(_batch_block(B, mesh, job.get("batch_axis")))}
    if job.get("time_iters"):
        res.update(split_ms(dev, dm.group, lambda: dm.multiply_relinearize(ct1, ct2),
                            job["time_iters"]))
    return res


def job_pipeline(job, mesh, dev):
    """The sharded ``build_batched_pipeline`` (or, with ``bf``, the sharded
    ``build_packed_pipeline_bf`` against the server's filter)."""
    from ..bfv.keys import SecretKey
    from . import pipeline
    from .mesh import shard

    ctx = _ctx(job, dev)
    sk = SecretKey(s_ntt=job["s_ntt"].to(dev), s_shoup=job["s_shoup"].to(dev))
    xb, yb, s, r = job["point"]
    cts = [tuple(shard(p.to(dev), mesh) for p in pair) for pair in job["cts"]]
    if job.get("bf"):
        w = job["w"]
        bf = pipeline.build_pipeline_filter(ctx.t, s, r, w, dev)
        fn = pipeline.build_packed_pipeline_bf(ctx, sk, xb, yb, s, r, w, w.bit_length(),
                                               mesh=mesh)
        near, did = _counted(
            dev, lambda: fn(*cts, bf.bits_device, bf._salts_device(), bf.table_size))
        return {"near": near.cpu(), **did}
    step = pipeline.build_batched_pipeline(ctx, sk, xb, yb, s, r, packed=job.get("packed", False),
                                           mesh=mesh)
    out, did = _counted(dev, lambda: step(*cts))
    from .mesh import ct_sharding

    index = ct_sharding(mesh).index(job["cts"][0][0].shape)
    return {"out": out.cpu(), **did, "index": [_span(s) for s in index]}


JOBS = {"mesh": job_mesh, "fail": job_fail, "ntt": job_ntt, "behz": job_behz,
        "pipeline": job_pipeline}


def main(argv) -> int:
    from .distributed import initialize_multihost
    from .mesh import make_mesh

    rank, nproc, init, path = int(argv[1]), int(argv[2]), argv[3], argv[4]
    spec = torch.load(path, weights_only=True)
    torch.set_num_threads(1)
    dev = _device(spec["device"])
    initialize_multihost(init, nproc, rank, backend="gloo", timeout_s=spec["timeout_s"])
    try:
        results = []
        for job in spec["jobs"]:
            mesh = make_mesh(nproc, *job["mesh"])
            results.append(JOBS[job["kind"]](job, mesh, dev))
        torch.save({"results": results}, f"{path}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
