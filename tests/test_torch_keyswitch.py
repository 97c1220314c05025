"""The port's special-prime key switching against the reference, on the CPU.

At N = 256 on an m31 chain (three 28-bit primes) and an m62 one (three
36-bit primes), with the reference's keygen words injected into the port
(``KeyGenerator.from_bits``, the per-digit uniform and CBD words of
``keyswitch.py``'s ``split(key, 3)``):

* the keygen's secret, public key and the words it keeps;
* ``build_ctx_qp``'s special prime, and the SP relinearization keys leaf
  for leaf (k0, k0_shoup, k1, k1_shoup and P);
* ``sp_relinearize`` (and ``Evaluator.relinearize`` with SP keys) on a
  batch of random size-3 ciphertexts, with the port's own keys and with
  the reference's carried across by ``sp_keys_from_reference``;
* ``save_sp_keys`` bytes, ``load_sp_keys`` both ways, wrong magic refused;
* a real product relinearized with SP keys decrypts (port alone).

Comparisons are exact (tolerance 0). Each reference call runs once, under
``jax.jit``, in a module fixture per profile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import keyswitch as rks
from pplp_tpu.bfv import serialize as rserialize
from pplp_tpu.ops.primes import get_primes
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import keyswitch, sampling, serialize
from pplp_tpu_torch.bfv.keys import make_keys

N = 256
T = get_primes(20, 1, N)[0]  # a batching prime: the galois tests share the setup
CHAINS = {"m31": list(get_primes(28, 3, N)), "m62": list(get_primes(36, 3, N))}


def _leaf(a) -> np.ndarray:
    """A reference array (u32, or a (lo, hi) u32 pair on m62) as int64."""
    if isinstance(a, (tuple, list)):
        lo, hi = (np.asarray(x).astype(np.uint64) for x in a)
        return (lo | (hi << np.uint64(32))).view(np.int64)
    return np.asarray(a).astype(np.int64)


def _ref_poly(v, profile):
    """Host residues (int64) -> the reference's u32 array or (lo, hi) pair."""
    v = np.asarray(v).astype(np.uint64)
    if profile == "m31":
        return jnp.asarray(v.astype(np.uint32))
    return (jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def _bits(key, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)


def _same(got, want) -> bool:
    """Port ciphertext (or tensor list) == reference polys, bit for bit."""
    got = got.polys if hasattr(got, "polys") else got
    want = want.polys if hasattr(want, "polys") else want
    return len(got) == len(want) and all(
        np.array_equal(g.cpu().numpy(), _leaf(w)) for g, w in zip(got, want))


def _sp_leaves(spk):
    return (spk.k0, spk.k0_shoup, spk.k1, spk.k1_shoup)


def reference_setup(profile, seed):
    """Reference and port contexts, the reference KeyGenerator and the port
    one from the same words, and the QP contexts built outside any jit."""
    chain = CHAINS[profile]
    rctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain), "cpu")
    assert ctx.tables.profile == rctx.tables.profile == profile
    rkg = rbfv.KeyGenerator(rctx, seed)
    key_a, key_e = jax.random.split(rkg._key_pk)
    kg = bfv.KeyGenerator.from_bits(
        ctx, _bits(rkg._key_s, (N,)),
        _bits(key_a, (ctx.prof.uniform_words, ctx.L, N)), _bits(key_e, (2, N)))
    rks.build_ctx_qp(rctx)  # cached outside the jits below
    return rctx, ctx, rkg, kg


def sp_words(key, ctx, ctx_qp) -> tuple:
    """The uniform [k, 2|4, K, n] and CBD [k, 2, n] words the reference's
    create_sp_kswitch_keys draws from ``key``."""
    u, e = [], []
    for _ in range(ctx.L):
        key, ka, ke = jax.random.split(key, 3)
        u.append(_bits(ka, (ctx.prof.uniform_words, ctx_qp.L, ctx.n)))
        e.append(_bits(ke, (2, ctx.n)))
    return np.stack(u), np.stack(e)


def random_polys(ctx, count, seed, batch=2):
    rng = np.random.default_rng(seed)
    qs = np.asarray([m.value for m in ctx.moduli], np.int64)[:, None]
    polys = [rng.integers(0, 1 << 62, size=(batch, ctx.L, N)) % qs for _ in range(count)]
    polys[0][0, :, :3] = qs - 1  # the largest canonical residues
    return polys


@pytest.fixture(scope="module", params=["m31", "m62"])
def sp(request):
    profile = request.param
    rctx, ctx, rkg, kg = reference_setup(profile, 3)
    key = jax.random.key(9)
    rspk = jax.jit(lambda k: _sp_leaves(rks.create_sp_relin_keys(rctx, rkg, k)))(key)
    rctx_qp, P = rks.build_ctx_qp(rctx)
    ctx_qp, _ = keyswitch.build_ctx_qp(ctx)
    words = sp_words(key, ctx, ctx_qp)
    spk = keyswitch.create_sp_relin_keys(ctx, kg, words=words)
    polys = random_polys(ctx, 3, 11)
    jct = rbfv.Ciphertext(tuple(_ref_poly(p, profile) for p in polys), "coeff")
    jspk = rks.SPKeys(rctx_qp, P, *rspk)
    want = jax.jit(lambda c: rks.sp_relinearize(rctx, c, jspk).polys)(jct)
    ct3 = bfv.Ciphertext(tuple(torch.from_numpy(p) for p in polys))
    return dict(profile=profile, rctx=rctx, ctx=ctx, rkg=rkg, kg=kg, rspk=rspk, P=P,
                jspk=jspk, spk=spk, ct3=ct3, want=want)


def test_keygen_draws_as_before():
    """KeyGenerator keeps its words but draws them as it always has: s, then
    a, then e, so every existing key stays bit-identical."""
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAINS["m31"]),
                               "cpu")
    kg = bfv.KeyGenerator(ctx, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    s = sampling.ternary_poly(g, ctx)
    sk, pk = make_keys(ctx, s, sampling.uniform_rq(g, ctx), sampling.cbd_poly(g, ctx))
    assert torch.equal(kg.secret_key().s_ntt, sk.s_ntt)
    assert torch.equal(kg.create_public_key().pk0_ntt, pk.pk0_ntt)
    assert torch.equal(sampling.ternary_poly_from_bits(kg.secret_words, ctx), s)


def test_keygen_from_reference_words(sp):
    rkg, kg = sp["rkg"], sp["kg"]
    rsk, rpk = rkg.secret_key(), rkg.create_public_key()
    sk, pk = kg.secret_key(), kg.create_public_key()
    assert _same([sk.s_ntt, sk.s_shoup], [rsk.s_ntt, rsk.s_shoup])
    assert _same([pk.pk0_ntt, pk.pk1_ntt, pk.pk0_shoup, pk.pk1_shoup],
                 [rpk.pk0_ntt, rpk.pk1_ntt, rpk.pk0_shoup, rpk.pk1_shoup])


def test_build_ctx_qp(sp):
    ctx, rctx = sp["ctx"], sp["rctx"]
    ctx_qp, P = keyswitch.build_ctx_qp(ctx)
    assert P == sp["P"] == rks.build_ctx_qp(rctx)[1]
    assert ctx_qp.parms.coeff_modulus == tuple(CHAINS[sp["profile"]]) + (P,)
    assert ctx_qp.tables.profile == ctx.tables.profile
    bits = 30 if sp["profile"] == "m31" else 61
    assert P.bit_length() == bits and P not in CHAINS[sp["profile"]]
    assert keyswitch.build_ctx_qp(ctx)[0] is ctx_qp  # contexts are cached


def test_sp_relin_keys_match_reference(sp):
    """Every leaf, the Shoup companions included, and P."""
    spk = sp["spk"]
    assert spk.P == sp["P"]
    assert spk.k0.shape == (len(CHAINS[sp["profile"]]), spk.ctx_qp.L, N)
    for got, want in zip(_sp_leaves(spk), sp["rspk"]):
        assert np.array_equal(got.numpy(), _leaf(want))


@pytest.mark.parametrize("keys", ["port", "carried"])
def test_sp_relinearize_matches_reference(sp, keys):
    ctx = sp["ctx"]
    spk = sp["spk"] if keys == "port" else keyswitch.sp_keys_from_reference(
        ctx, sp["P"], *(_leaf(x) for x in sp["rspk"]))
    assert _same(keyswitch.sp_relinearize(ctx, sp["ct3"], spk), sp["want"])
    assert _same(bfv.Evaluator(ctx).relinearize(sp["ct3"], spk), sp["want"])


def test_sp_keys_from_reference_refuses_another_prime(sp):
    with pytest.raises(ValueError, match="special prime"):
        keyswitch.sp_keys_from_reference(sp["ctx"], sp["P"] - 2 * N,
                                         *(_leaf(x) for x in sp["rspk"]))


def test_sp_relinearize_refuses_a_size_2_ciphertext(sp):
    with pytest.raises(ValueError, match="size-3"):
        keyswitch.sp_relinearize(sp["ctx"], bfv.Ciphertext(sp["ct3"].polys[:2]), sp["spk"])


def test_sp_key_bytes_match_reference(sp):
    ctx, rctx, spk = sp["ctx"], sp["rctx"], sp["spk"]
    blob = serialize.save_sp_keys(spk, ctx)
    rblob = rserialize.save_sp_keys(sp["jspk"], rctx)
    assert blob == rblob
    back = serialize.load_sp_keys(rblob, ctx)
    assert back.P == spk.P
    assert back.ctx_qp.parms.coeff_modulus == spk.ctx_qp.parms.coeff_modulus
    for got, want in zip(_sp_leaves(back), _sp_leaves(spk)):
        assert torch.equal(got, want)
    rback = rserialize.load_sp_keys(blob, rctx)
    for got, want in zip(_sp_leaves(rback), sp["rspk"]):
        assert np.array_equal(_leaf(got), _leaf(want))
    with pytest.raises(ValueError, match="magic"):
        serialize.load_sp_keys(b"PPLPksw1" + blob[8:], ctx)


def test_sp_relinearized_product_decrypts():
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAINS["m31"]),
                               "cpu")
    g = torch.Generator().manual_seed(21)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    spk = keyswitch.create_sp_relin_keys(ctx, kg, g)
    enc, dec, ev = bfv.Encryptor(ctx, pk), bfv.Decryptor(ctx, sk), bfv.Evaluator(ctx)
    a, b = bfv.Plaintext([3, 1]), bfv.Plaintext([5, 0, 2])
    out = ev.relinearize(ev.multiply(enc.encrypt(a, g), enc.encrypt(b, g)), spk)
    assert out.size == 2
    assert dec.decrypt(out).coeffs[:4] == [15, 5, 6, 2]


def test_transforms_get_contiguous_rows(sp, monkeypatch):
    """The NTT kernel takes contiguous rows only: every transform of the
    switch, the SP keygen and a rotation gets them (checked here, where
    the plain transform would take any layout)."""
    from pplp_tpu_torch.bfv import galois
    from pplp_tpu_torch.ops import ntt

    def checked(fn):
        def run(x, tb):
            assert x.is_contiguous(), f"non-contiguous {tuple(x.shape)} into {fn.__name__}"
            return fn(x, tb)
        return run

    monkeypatch.setattr(ntt, "forward", checked(ntt.forward))
    monkeypatch.setattr(ntt, "inverse", checked(ntt.inverse))
    ctx, kg = sp["ctx"], sp["kg"]
    g = torch.Generator().manual_seed(2)
    spk = keyswitch.create_sp_relin_keys(ctx, kg, g)
    keyswitch.sp_relinearize(ctx, sp["ct3"], spk)
    ct = bfv.Ciphertext(sp["ct3"].polys[:2])
    galois.rotate_rows(ctx, ct, 1, keyswitch.create_sp_galois_keys(ctx, kg, 3, g))
