"""The port's sharded proximity pipeline against the reference's results.

At N = 256, T = 2^20 and the chain of ``tests/test_parallel.py`` (two 28-bit
and two 27-bit primes), with the reference's keys carried over and its
ciphertexts remade by the port from the same sampler words (as
``tests/test_torch_pipeline.py`` does), in 4 gloo processes on the CPU
(``parallel/multiproc_smoke.py``), bit for bit (tolerance 0):

* ``build_batched_pipeline(..., mesh=)``, 4 queries, on dp = 2 x limb = 2
  (no communication), dp = 2 x coeff = 2, limb = 2 x coeff = 2 and
  coeff = 4, every rank's block equal to the reference's single-device
  step, as ``tests/test_parallel.py::test_sharded_step_matches_single_device``
  holds the reference's sharded step;
* the packed step (2 rows of 256 packed checks) on dp = 2 x coeff = 2
  against the reference's packed step;
* ``build_packed_pipeline_bf(..., mesh=)`` at the reference's dry-run
  settings (s = 501, r = 99, w = 0xA5A5, the server's filter of r^2 keys) on
  dp = 2 x coeff = 2: the gathered verdicts equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import R_BLIND, S_BLIND, W, W_LEN, XB, YB, _coords, _ctx_pair, _words

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv.keys import make_sk_pk_jit
from pplp_tpu.ops.primes import get_primes
from pplp_tpu.parallel import pipeline as rpipe
from pplp_tpu.primitives.bloom import BloomFilter as RBloomFilter
from pplp_tpu.primitives.bloom import BloomParameters as RBloomParameters
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv.keys import keys_from_reference
from pplp_tpu_torch.parallel import mesh as pmesh
from pplp_tpu_torch.parallel import pipeline
from pplp_tpu_torch.parallel.multiproc_smoke import launch

N, T, ROWS = 256, 1 << 20, 2
BATCHED = {"dp2xlimb2": (2, 2, 1), "dp2xcoeff2": (2, 1, 2), "limb2xcoeff2": (1, 2, 2),
           "coeff4": (1, 1, 4)}


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def env():
    chain = list(get_primes(28, 2, N)) + list(get_primes(27, 2, N))
    jctx, ctx = _ctx_pair(chain)
    rsk, rpk = make_sk_pk_jit(jctx, 33)
    sk, pk = keys_from_reference(
        ctx, _np(rsk.s_ntt), _np(rsk.s_shoup), _np(rpk.pk0_ntt), _np(rpk.pk1_ntt),
        _np(rpk.pk0_shoup), _np(rpk.pk1_shoup))
    renc, enc = rbfv.Encryptor(jctx, rpk), bfv.Encryptor(ctx, pk)

    # One query a ciphertext, 4 queries.
    xa = np.array([1234, 1000, 77, 1003], np.uint64)
    ya = np.array([1212, 900, 99, 1001], np.uint64)
    key = jax.random.key(5)
    ref_b = rpipe.make_batch_inputs(jctx, renc, xa, ya, key)
    cts_b = pipeline.make_batch_inputs(ctx, enc, xa, ya, words=_words(key, 4))
    want_b = _np(jax.jit(rpipe.build_batched_pipeline(jctx, rsk, XB, YB, S_BLIND,
                                                      R_BLIND))(*ref_b))
    # Packed checks, ROWS rows of N.
    pxa, pya = _coords(np.random.default_rng(7), ROWS * N)
    pkey = jax.random.key(8)
    ref_p = rpipe.make_packed_inputs(jctx, renc, pxa, pya, pkey)
    cts_p = pipeline.make_packed_inputs(ctx, enc, pxa, pya, words=_words(pkey, ROWS))
    want_p = _np(jax.jit(rpipe.build_batched_pipeline(jctx, rsk, XB, YB, S_BLIND, R_BLIND,
                                                      packed=True))(*ref_p))
    rp = RBloomParameters(projected_element_count=R_BLIND * R_BLIND,
                          false_positive_probability=1e-4, random_seed=0xA5A5A5A5,
                          index_mode="mixed")
    assert rp.compute_optimal_parameters()
    di = np.arange(R_BLIND * R_BLIND, dtype=np.uint64)
    keys = (((np.uint64(S_BLIND) * (di + np.uint64(R_BLIND))) % np.uint64(T))
            << np.uint64(W_LEN)) | np.uint64(W)
    rbf = RBloomFilter(rp)
    rbf.insert_u64_batch((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         (keys >> np.uint64(32)).astype(np.uint32))
    want_near = np.asarray(jax.jit(rpipe.build_packed_pipeline_bf(
        jctx, rsk, XB, YB, S_BLIND, R_BLIND, W, W_LEN))(
        *ref_p, rbf._bits_device(), rbf._salts_device(), jnp.uint32(rbf.table_size)))

    common = dict(kind="pipeline", n=N, t=T, moduli=chain, s_ntt=sk.s_ntt, s_shoup=sk.s_shoup,
                  point=[XB, YB, S_BLIND, R_BLIND])
    jobs = [dict(common, mesh=m, cts=[list(c) for c in cts_b]) for m in BATCHED.values()]
    jobs.append(dict(common, mesh=(2, 1, 2), cts=[list(c) for c in cts_p], packed=True))
    jobs.append(dict(common, mesh=(2, 1, 2), cts=[list(c) for c in cts_p], bf=True, w=W))
    res = launch({"device": "cpu", "jobs": jobs}, 4, timeout_s=120)
    runs = [[r["results"][j] for r in res] for j in range(len(jobs))]
    return dict(ctx=ctx, sk=sk, cts_b=cts_b, want_b=want_b, want_p=want_p,
                want_near=want_near, runs=runs)


def _assemble(outs, shape):
    got = np.full(shape, -1, np.int64)
    for out in outs:
        got[tuple(slice(*s) for s in out["index"])] = out["out"].numpy()
    return got


@pytest.mark.parametrize("name", list(BATCHED))
def test_sharded_batched_step_matches_reference(env, name):
    outs = env["runs"][list(BATCHED).index(name)]
    assert (_assemble(outs, env["want_b"].shape) == env["want_b"]).all()


def test_sharded_packed_step_matches_reference(env):
    outs = env["runs"][len(BATCHED)]
    assert (_assemble(outs, env["want_p"].shape) == env["want_p"]).all()


def test_sharded_packed_bf_matches_reference(env):
    want = env["want_near"]
    assert want.shape == (ROWS, N) and want.any() and not want.all()
    for out in env["runs"][len(BATCHED) + 1]:  # every rank gathers all verdicts
        assert out["near"].dtype == torch.bool
        assert (out["near"].numpy() == want).all()


def test_single_rank_mesh_is_the_single_device_step(env):
    ctx, sk = env["ctx"], env["sk"]
    step = pipeline.build_batched_pipeline(ctx, sk, XB, YB, S_BLIND, R_BLIND,
                                           mesh=pmesh.make_mesh(1))
    assert (step(*env["cts_b"]).numpy() == env["want_b"]).all()


def test_packed_step_refuses_a_limb_axis(env):
    with pytest.raises(ValueError, match="dp and coeff"):
        pipeline.build_packed_pipeline(env["ctx"], env["sk"], XB, YB, S_BLIND, R_BLIND,
                                       mesh=pmesh.make_mesh(4, 1, 2, 2, rank=0))
