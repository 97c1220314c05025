"""The port's Galois automorphisms, rotations and batch encoder against the
reference, on the CPU.

At N = 256, t a 20-bit batching prime, on an m31 chain (three 28-bit
primes) and an m62 one (three 36-bit primes), with the reference's keygen
words injected into the port (``test_torch_keyswitch.reference_setup``):

* ``galois_elt_from_step`` and ``apply_galois_plain``;
* special-prime Galois keys for steps +1, -1 and the column swap, leaf for
  leaf, from the reference's per-digit words;
* ``rotate_rows`` (+1, -1) and ``rotate_columns`` on a batch of random
  ciphertexts with SP keys and with RNS-gadget keys (the reference's
  carried across by ``relin_keys_from_reference``);
* ``BatchEncoder.encode``/``decode`` on both chains, and its two errors;
* rotations of batch-encoded slots decrypt to the rotated slots (port
  alone), with SP keys and with gadget keys.

Comparisons are exact (tolerance 0). The reference's calls for a profile
run under one ``jax.jit`` in a module fixture.
"""

import jax
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import galois as rgalois
from pplp_tpu.bfv import keyswitch as rks
from pplp_tpu.bfv.batch_encoder import BatchEncoder as RBatchEncoder
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz, galois, keyswitch
from pplp_tpu_torch.bfv.batch_encoder import BatchEncoder
from test_torch_keyswitch import (CHAINS, N, T, _leaf, _ref_poly, _same, _sp_leaves,
                                  random_polys, reference_setup, sp_words)

STEPS = {"+1": galois.galois_elt_from_step(1, N), "-1": galois.galois_elt_from_step(-1, N),
         "columns": 2 * N - 1}


@pytest.fixture(scope="module", params=["m31", "m62"])
def rot(request):
    profile = request.param
    rctx, ctx, rkg, kg = reference_setup(profile, 4)
    rsk = rkg.secret_key()
    rctx_qp, P = rks.build_ctx_qp(rctx)
    ctx_qp, _ = keyswitch.build_ctx_qp(ctx)
    for g in STEPS.values():
        rgalois._galois_tables(N, g)  # cached outside the jit below
    polys = random_polys(ctx, 2, 12)
    jct = rbfv.Ciphertext(tuple(_ref_poly(p, profile) for p in polys), "coeff")
    keys = {name: (jax.random.key(30 + i), jax.random.key(40 + i))
            for i, name in enumerate(STEPS)}

    def reference(ct, keys):
        out = {}
        for name, g in STEPS.items():
            ksp, kgad = keys[name]
            spk = rks.create_sp_galois_keys(rctx, rkg, g, ksp)
            gk = rgalois.create_galois_keys(rctx, rsk, g, kgad)
            out[name] = {
                "sp_keys": _sp_leaves(spk),
                "gadget_keys": (gk.k0, gk.k0_shoup, gk.k1, gk.k1_shoup),
                "sp": rgalois.apply_galois(rctx, ct, g, spk).polys,
                "gadget": rgalois.apply_galois(rctx, ct, g, gk).polys,
            }
        return out

    want = jax.jit(reference)(jct, keys)
    port = {}
    for name, g in STEPS.items():
        spk = keyswitch.create_sp_galois_keys(ctx, kg, g, words=sp_words(keys[name][0], ctx,
                                                                         ctx_qp))
        gk = behz.relin_keys_from_reference(
            ctx, *(_leaf(x) for x in want[name]["gadget_keys"]), None)
        port[name] = {"sp": spk, "gadget": gk}
    ct = bfv.Ciphertext(tuple(torch.from_numpy(p) for p in polys))
    return dict(profile=profile, rctx=rctx, ctx=ctx, ct=ct, jct=jct, want=want, port=port,
                P=P)


def test_galois_elt_from_step():
    for n in (64, 256, 4096, 8192):
        for step in (0, 1, 2, -1, -3, n // 2 - 1, -(n // 2 - 1)):
            assert galois.galois_elt_from_step(step, n) == rgalois.galois_elt_from_step(step, n)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_apply_galois_plain_matches_reference(rot, step):
    g, ctx, rctx = STEPS[step], rot["ctx"], rot["rctx"]
    got = galois.apply_galois_plain(ctx, rot["ct"].polys[0], g)
    want = rgalois.apply_galois_plain(rctx, rot["jct"].polys[0], g)
    assert np.array_equal(got.numpy(), _leaf(want))


def test_apply_galois_plain_monomials():
    """sigma_3(5 X) = 5 X^3; sigma_3(X^{n-1}) = +X^{n-3} (X^{2n} = 1)."""
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAINS["m31"]),
                               "cpu")
    x = torch.zeros((ctx.L, N), dtype=torch.int64)
    x[:, 1] = 5
    out = galois.apply_galois_plain(ctx, x, 3)
    assert out[:, 3].tolist() == [5] * ctx.L and int(out.sum()) == 5 * ctx.L
    x = torch.zeros((ctx.L, N), dtype=torch.int64)
    x[:, N - 1] = 1
    out = galois.apply_galois_plain(ctx, x, 3)
    assert out[:, N - 3].tolist() == [1] * ctx.L and int(out.sum()) == ctx.L
    with pytest.raises(ValueError, match="odd"):
        galois.apply_galois_plain(ctx, x, 4)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_sp_galois_keys_match_reference(rot, step):
    spk = rot["port"][step]["sp"]
    assert spk.P == rot["P"]
    for got, want in zip(_sp_leaves(spk), rot["want"][step]["sp_keys"]):
        assert np.array_equal(got.numpy(), _leaf(want))


@pytest.mark.parametrize("kind", ["sp", "gadget"])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_rotation_matches_reference(rot, step, kind):
    ctx, ct, gk = rot["ctx"], rot["ct"], rot["port"][step][kind]
    if step == "columns":
        got = galois.rotate_columns(ctx, ct, gk)
    else:
        got = galois.rotate_rows(ctx, ct, int(step), gk)
    assert _same(got, rot["want"][step][kind])
    assert _same(galois.apply_galois(ctx, ct, STEPS[step], gk), rot["want"][step][kind])
    if kind == "sp":
        assert _same(keyswitch.apply_galois_sp(ctx, ct, STEPS[step], gk),
                     rot["want"][step][kind])


@pytest.mark.parametrize("profile", ["m31", "m62"])
def test_batch_encoder_matches_reference(profile):
    chain = CHAINS[profile]
    rctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain), "cpu")
    be, rbe = BatchEncoder(ctx), RBatchEncoder(rctx)
    assert be.slot_count == rbe.slot_count == N
    assert np.array_equal(be._perm, rbe._perm)
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(0, T, size=N)]
    pt = be.encode(vals)
    assert pt.coeffs == rbe.encode(vals).coeffs
    assert be.decode(pt) == rbe.decode(pt) == vals
    short = [T - 1, 0, 7, 2 * T + 5]  # fewer values than slots, reduced mod t
    assert be.encode(short).coeffs == rbe.encode(short).coeffs
    rows = np.stack([vals, vals[::-1]])
    coeffs = be.encode_rows(rows)
    assert coeffs[1].tolist() == rbe.encode(vals[::-1]).coeffs
    assert np.array_equal(be.decode_rows(coeffs), rows)


# t >= 2^30; not prime; a prime that is not 1 mod 2n (1000002 = 66 mod 512).
@pytest.mark.parametrize("t", [(1 << 30) + 3, 65537 * 2 + 1, 1000003])
def test_batch_encoder_refuses_what_the_reference_refuses(t):
    chain = CHAINS["m62"]  # room for t up to 2^30
    rctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, t, coeff_modulus=chain))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, t, coeff_modulus=chain), "cpu")
    with pytest.raises(Exception) as want:
        RBatchEncoder(rctx)
    with pytest.raises(want.type, match=str(want.value)[:20]):
        BatchEncoder(ctx)


@pytest.mark.parametrize("kind", ["sp", "gadget"])
def test_rotations_move_the_slots(kind):
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAINS["m31"]),
                               "cpu")
    g = torch.Generator().manual_seed(77)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    be = BatchEncoder(ctx)
    half = N // 2
    rng = np.random.default_rng(5)
    rows = rng.integers(0, T, size=(2, N))
    coeffs = be.encode_rows(rows)
    ct = bfv.Encryptor(ctx, pk).encrypt_pairs(coeffs, np.zeros_like(coeffs), g)
    dec = bfv.Decryptor(ctx, sk)

    def keys(g_elt):
        if kind == "sp":
            return keyswitch.create_sp_galois_keys(ctx, kg, g_elt, g)
        return galois.create_galois_keys(ctx, sk, g_elt, g)

    expect = {
        "+1": lambda r: np.concatenate([r[1:half], r[:1], r[half + 1:], r[half:half + 1]]),
        "-1": lambda r: np.concatenate([r[half - 1:half], r[:half - 1], r[N - 1:],
                                        r[half:N - 1]]),
        "columns": lambda r: np.concatenate([r[half:], r[:half]]),
    }
    for step, g_elt in STEPS.items():
        out = galois.apply_galois(ctx, ct, g_elt, keys(g_elt))
        for b in range(2):
            row = bfv.Ciphertext(tuple(p[b] for p in out.polys))
            got = be.decode(dec.decrypt(row))
            assert got == expect[step](rows[b]).tolist(), (kind, step)
