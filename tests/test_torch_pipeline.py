"""The port's packed proximity pipeline against ``pplp_tpu.parallel.pipeline``.

At N = 256, T = 2^20 and the chain of ``tests/test_parallel.py`` (two 28-bit
and two 27-bit primes), 2 ciphertext rows. The reference's keys come across
through ``keys_from_reference``; its ciphertexts are remade by the port from
the same sampler words, and every step is held equal, bit for bit
(tolerance 0: all of it is exact integer arithmetic):

* ``make_packed_inputs`` / ``make_batch_inputs`` (the injected-words form);
* ``build_batched_pipeline``, ``build_packed_pipeline`` and
  ``build_packed_pipeline_bf``, each against the reference's and the clear
  oracle;
* ``RnsDecoder.decode_mod_t`` on an m31 and an m62 chain with t < 2^30,
  ``BloomFilter.contains_u64_batch``, and the server's filter
  (``build_pipeline_filter``, byte-identical to the reference's).

Each reference function is jitted once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv.keys import make_sk_pk_jit
from pplp_tpu.bfv.rns_decrypt import RnsDecoder as RRnsDecoder
from pplp_tpu.parallel import pipeline as rpipe
from pplp_tpu.primitives.bloom import BloomFilter as RBloomFilter
from pplp_tpu.primitives.bloom import BloomParameters as RBloomParameters
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv.keys import keys_from_reference
from pplp_tpu_torch.bfv.rns_decrypt import RnsDecoder, get_decoder
from pplp_tpu_torch.ops.primes import bfv_default, get_primes
from pplp_tpu_torch.parallel import pipeline

N = 256
T = 1 << 20
ROWS = 2
XB, YB, S_BLIND, R_BLIND, W = 1000, 900, 501, 99, 0xA5A5
W_LEN = W.bit_length()


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ctx_pair(chain, t=T, n=N):
    return (rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain)),
            bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain), "cpu"))


def _words(key, B):
    """The sampler words the reference's three-message encryption draws from
    ``key`` (``pipeline._encrypt3_jit`` splits it per message, then
    ``Encryptor.encrypt_pairs`` per sampler)."""
    u, e0, e1 = [], [], []
    for k in jax.random.split(key, 3):
        ku, ke0, ke1 = jax.random.split(k, 3)
        u.append(jax.random.bits(ku, (B, N), jnp.uint32))
        e0.append(jax.random.bits(ke0, (B, 2, N), jnp.uint32))
        e1.append(jax.random.bits(ke1, (B, 2, N), jnp.uint32))
    return tuple(_np(jnp.stack(v)) for v in (u, e0, e1))


def _coords(rng, total):
    """Half near (inside R_BLIND of (XB, YB)), half far, as in
    tests/test_parallel.py's 100k-check test."""
    near = rng.random(total) < 0.5
    dx = rng.integers(-R_BLIND + 1, R_BLIND, total)
    dy_cap = np.sqrt(np.maximum(R_BLIND**2 - 1 - dx**2, 0)).astype(np.int64)
    dy = (rng.integers(0, 2**31, total) % (2 * dy_cap + 1)) - dy_cap
    xa = np.where(near, XB + dx, rng.integers(0, 4000, total)).astype(np.uint64)
    ya = np.where(near, YB + dy, rng.integers(0, 4000, total)).astype(np.uint64)
    return xa, ya


@pytest.fixture(scope="module")
def env():
    chain = list(get_primes(28, 2, N)) + list(get_primes(27, 2, N))
    jctx, ctx = _ctx_pair(chain)
    rsk, rpk = make_sk_pk_jit(jctx, 33)
    sk, pk = keys_from_reference(
        ctx, _np(rsk.s_ntt), _np(rsk.s_shoup), _np(rpk.pk0_ntt), _np(rpk.pk1_ntt),
        _np(rpk.pk0_shoup), _np(rpk.pk1_shoup))
    renc = rbfv.Encryptor(jctx, rpk)
    enc = bfv.Encryptor(ctx, pk)
    xa, ya = _coords(np.random.default_rng(7), ROWS * N)
    key = jax.random.key(8)
    ref_cts = rpipe.make_packed_inputs(jctx, renc, xa, ya, key)
    cts = pipeline.make_packed_inputs(ctx, enc, xa, ya, words=_words(key, ROWS))

    # The reference's filter of r^2 blinded keys, made as bench.py makes it,
    # and the port's (``build_pipeline_filter``): the same bytes.
    rp = RBloomParameters(projected_element_count=R_BLIND * R_BLIND,
                          false_positive_probability=1e-4, random_seed=0xA5A5A5A5,
                          index_mode="mixed")
    assert rp.compute_optimal_parameters()
    di = np.arange(R_BLIND * R_BLIND, dtype=np.uint64)
    bd_ins = (np.uint64(S_BLIND) * (di + np.uint64(R_BLIND))) % np.uint64(T)
    keys = (bd_ins << np.uint64(W_LEN)) | np.uint64(W)
    rbf = RBloomFilter(rp)
    rbf.insert_u64_batch((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         (keys >> np.uint64(32)).astype(np.uint32))
    bf = pipeline.build_pipeline_filter(T, S_BLIND, R_BLIND, W, "cpu")
    assert bf.serialize() == rbf.serialize()

    ref_bf_fn = jax.jit(rpipe.build_packed_pipeline_bf(
        jctx, rsk, XB, YB, S_BLIND, R_BLIND, W, W_LEN))
    ref_near = np.asarray(ref_bf_fn(*ref_cts, rbf._bits_device(), rbf._salts_device(),
                                    jnp.uint32(rbf.table_size)))
    ref_bd = np.asarray(jax.jit(rpipe.build_packed_pipeline(
        jctx, rsk, XB, YB, S_BLIND, R_BLIND))(*ref_cts))
    return dict(jctx=jctx, ctx=ctx, rsk=rsk, sk=sk, renc=renc, enc=enc, xa=xa, ya=ya,
                ref_cts=ref_cts, cts=cts, rbf=rbf, bf=bf, ref_near=ref_near, ref_bd=ref_bd)


def _oracle_bd(xa, ya):
    d2 = (xa.astype(np.int64) - XB) ** 2 + (ya.astype(np.int64) - YB) ** 2
    return d2, (S_BLIND * (d2 + R_BLIND)) % T


def test_make_packed_inputs_match_reference(env):
    for ours, theirs in zip(env["cts"], env["ref_cts"]):
        for a, b in zip(ours, theirs):
            assert a.shape == (ROWS, 4, N)
            assert (a.numpy() == _np(b)).all()


def test_batched_pipeline_matches_reference(env):
    jctx, ctx = env["jctx"], env["ctx"]
    xa = np.array([1234, 1000, 77, 1003], np.uint64)
    ya = np.array([1212, 900, 99, 1001], np.uint64)
    key = jax.random.key(5)
    ref_cts = rpipe.make_batch_inputs(jctx, env["renc"], xa, ya, key)
    cts = pipeline.make_batch_inputs(ctx, env["enc"], xa, ya, words=_words(key, 4))
    for ours, theirs in zip(cts, ref_cts):
        assert all((a.numpy() == _np(b)).all() for a, b in zip(ours, theirs))
    want = jax.jit(rpipe.build_batched_pipeline(jctx, env["rsk"], XB, YB, S_BLIND,
                                                R_BLIND))(*ref_cts)
    got = pipeline.build_batched_pipeline(ctx, env["sk"], XB, YB, S_BLIND, R_BLIND)(*cts)
    assert (got.numpy() == _np(want)).all()
    _, bd = _oracle_bd(xa, ya)
    for b in range(4):
        coeffs = ctx.decode_plain_from_ct_value(got[b].numpy())
        assert coeffs[0] == bd[b] and not any(coeffs[1:])


def test_packed_pipeline_matches_reference(env):
    ctx = env["ctx"]
    step = pipeline.build_packed_pipeline(ctx, env["sk"], XB, YB, S_BLIND, R_BLIND)
    got = step(*env["cts"])
    assert got.shape == (ROWS, N)
    assert (got.numpy() == _np(env["ref_bd"])).all()
    _, bd = _oracle_bd(env["xa"], env["ya"])
    assert (got.numpy().reshape(-1) == bd).all()


def test_packed_pipeline_bf_matches_reference(env):
    ctx, bf = env["ctx"], env["bf"]
    fn = pipeline.build_packed_pipeline_bf(ctx, env["sk"], XB, YB, S_BLIND, R_BLIND,
                                           W, W_LEN)
    got = fn(*env["cts"], bf.bits_device, bf._salts_device(), bf.table_size)
    assert got.dtype == torch.bool and got.shape == (ROWS, N)
    assert (got.numpy() == env["ref_near"]).all()
    # Host oracle: clear blind distance -> key -> the filter's own probe.
    d2, bd = _oracle_bd(env["xa"], env["ya"])
    keys = (bd.astype(np.uint64) << np.uint64(W_LEN)) | np.uint64(W)
    flat = got.numpy().reshape(-1)
    assert [bool(v) for v in flat] == [bf.contains_u64(int(k)) for k in keys]
    assert flat[d2 < R_BLIND * R_BLIND].all()  # no false negatives
    with pytest.raises(ValueError):
        pipeline.build_packed_pipeline_bf(ctx, env["sk"], XB, YB, S_BLIND, R_BLIND, W, 32)


def test_contains_u64_batch_matches_reference(env):
    rng = np.random.default_rng(3)
    _, bd = _oracle_bd(env["xa"], env["ya"])
    keys = np.concatenate([(bd.astype(np.uint64) << np.uint64(W_LEN)) | np.uint64(W),
                           rng.integers(0, 1 << 63, 512, dtype=np.uint64)])
    klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    khi = (keys >> np.uint64(32)).astype(np.uint32)
    want = np.asarray(env["rbf"].contains_u64_batch(jnp.asarray(klo), jnp.asarray(khi)))
    got = env["bf"].contains_u64_batch(torch.from_numpy(klo.astype(np.int64)),
                                       torch.from_numpy(khi.astype(np.int64)))
    assert want.any() and not want.all()
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("profile", ["m31", "m62"])
def test_decoder_matches_reference(profile, env):
    if profile == "m31":
        jctx, ctx = env["jctx"], env["ctx"]
    else:
        # The seal KAT's chain (36-37-bit primes) with t = 2^20.
        jctx, ctx = _ctx_pair(bfv_default(4096), n=4096)
    assert ctx.tables.profile == profile
    rng = np.random.default_rng(11)
    qs = np.array([m.value for m in ctx.moduli], np.uint64)[None, :, None]
    x = (rng.integers(0, 1 << 63, size=(2, ctx.L, ctx.n), dtype=np.uint64) % qs)
    x[0, :, :2] = qs[0] - np.uint64(1)
    got = get_decoder(ctx).decode_mod_t(torch.from_numpy(x.astype(np.int64)))
    if profile == "m31":
        xr = jnp.asarray(x.astype(np.uint32))
    else:
        xr = (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
              jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))
    want = jax.jit(RRnsDecoder(jctx).decode_mod_t)(xr)
    assert (got.numpy() == _np(want)).all()
    # Random residues are mostly far from decryptable: the host decode
    # agrees where the value is, so hold it equal on real ciphertext values.
    if profile == "m31":
        bd = pipeline.build_batched_pipeline(ctx, env["sk"], XB, YB, S_BLIND, R_BLIND,
                                             packed=True)(*env["cts"])
        host = [ctx.decode_plain_from_ct_value(bd[r].numpy()) for r in range(ROWS)]
        assert get_decoder(ctx).decode_mod_t(bd).tolist() == host


def test_decoder_refuses_wide_plain_modulus():
    _, ctx = _ctx_pair(bfv_default(4096), t=1 << 30, n=4096)
    with pytest.raises(NotImplementedError):
        RnsDecoder(ctx)
