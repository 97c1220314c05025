"""The port's BFV layer against the reference, bit for bit (tolerance 0).

* The m31 known-answer vectors (``tests/fixtures/bfv_kat_n64_m31.json.gz``)
  replayed through the port by the injected path of
  ``tests/test_seal_vectors.py``: keygen from the injected (s, a, e), then
  encrypt, add, sub, add_plain, multiply_plain and decrypt. Every key leaf,
  Shoup companions included, equals the reference's.
* Samplers fed the words ``jax.random.bits`` drew equal the reference's.
* scale_plain / lift_plain_centered, serialization, and keys carried over
  from the reference in either spectrum order.
* The seal profile (m62): the SEAL-default KAT
  (``tests/fixtures/bfv_kat_n4096_sealdefault.json.gz``, the fixture itself
  is the oracle) for every row: encrypt, decrypt, add, sub, the plain rows,
  the BEHZ multiply, the relinearization with the injected per-digit
  randomness, the decrypted product and mod_switch_to_next; the m62
  samplers on the same words; keys carried over from (lo, hi) pairs; and
  ``invariant_noise_budget`` equal to the reference's on both profiles.
"""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import sampling as rsampling
from pplp_tpu.bfv import serialize as rser
from pplp_tpu.bfv.keys import PublicKey as RPublicKey
from pplp_tpu.bfv.keys import SecretKey as RSecretKey
from pplp_tpu.bfv.keys import _shoup as rshoup
from pplp_tpu.bfv.keys import make_sk_pk_jit
from pplp_tpu.ops import ntt as rntt
from pplp_tpu.ops import ntt_vmem
from pplp_tpu.ops import primes as rprimes
from pplp_tpu.ops.primes import get_primes
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz, sampling, serialize
from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
from pplp_tpu_torch.bfv.keys import keys_from_reference, make_keys
from pplp_tpu_torch.ops import ntt
from pplp_tpu_torch.ops import primes

_FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
_FIX = os.path.join(_FIXDIR, "bfv_kat_n64_m31.json.gz")
_FIX_SEAL = os.path.join(_FIXDIR, "bfv_kat_n4096_sealdefault.json.gz")


@pytest.fixture(scope="module")
def kat():
    with gzip.open(_FIX, "rt") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def seal_kat():
    with gzip.open(_FIX_SEAL, "rt") as f:
        return json.load(f)


def _residues(coeffs, chain):
    return np.array([[int(c) % q for c in coeffs] for q in chain], dtype=np.int64)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ctx_pair(n, t, chain):
    jparms = rbfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain)
    parms = bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain)
    return rbfv.BFVContext.build(jparms), bfv.BFVContext.build(parms, "cpu")


def _ct_ints(ct, ctx):
    return [ctx.crt_compose(p.numpy()) for p in ct.polys]


def test_prime_chains_match_reference():
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        assert primes.tpu_default(n) == rprimes.tpu_default(n)
        assert primes.bfv_default(n) == rprimes.bfv_default(n)


def test_kat_n64_m31(kat):
    n, t, chain = kat["n"], kat["t"], kat["moduli"]
    jctx, ctx = _ctx_pair(n, t, chain)
    res = lambda c: _residues(c, chain)  # noqa: E731
    tres = lambda c: torch.from_numpy(res(c))  # noqa: E731

    # Reference keys, built as tests/test_seal_vectors.py builds them.
    fwd = lambda c: rntt.forward(jnp.asarray(res(c).astype(np.uint32)), jctx.tables)  # noqa: E731
    s_ntt = fwd(kat["s"])
    pk0_ntt, pk1_ntt = fwd(kat["pk0"]), fwd(kat["pk1"])
    rsk = RSecretKey(s_ntt=s_ntt, s_shoup=rshoup(jctx, s_ntt))
    rpk = RPublicKey(pk0_ntt=pk0_ntt, pk1_ntt=pk1_ntt,
                     pk0_shoup=rshoup(jctx, pk0_ntt), pk1_shoup=rshoup(jctx, pk1_ntt))

    # Port keys from the injected keygen randomness.
    sk, pk = make_keys(ctx, tres(kat["s"]), ntt.forward(tres(kat["a"]), ctx.tables),
                       tres(kat["e"]))
    for name in ("s_ntt", "s_shoup"):
        assert (getattr(sk, name).numpy() == _np(getattr(rsk, name))).all(), name
    for name in ("pk0_ntt", "pk1_ntt", "pk0_shoup", "pk1_shoup"):
        assert (getattr(pk, name).numpy() == _np(getattr(rpk, name))).all(), name

    exp = kat["expected"]
    want = lambda key: [[int(v) % ctx.q for v in p] for p in exp[key]]  # noqa: E731
    enc = bfv.Encryptor(ctx, pk)
    ct1 = enc.encrypt_with_randomness(bfv.Plaintext(kat["m1"]), tres(kat["u1"]),
                                      tres(kat["e01"]), tres(kat["e11"]))
    ct2 = enc.encrypt_with_randomness(bfv.Plaintext(kat["m2"]), tres(kat["u2"]),
                                      tres(kat["e02"]), tres(kat["e12"]))
    assert _ct_ints(ct1, ctx) == want("ct1")
    assert _ct_ints(ct2, ctx) == want("ct2")

    dec = bfv.Decryptor(ctx, sk)
    assert dec.decrypt(ct1).coeffs[:n] == exp["decrypt_ct1"]

    ev = bfv.Evaluator(ctx)
    assert _ct_ints(ev.add(ct1, ct2), ctx) == want("add")
    assert _ct_ints(ev.sub(ct1, ct2), ctx) == want("sub")
    assert _ct_ints(ev.add_plain(ct1, bfv.Plaintext(kat["m2"])), ctx) == want("add_plain_m2")
    assert (_ct_ints(ev.multiply_plain(ct1, bfv.Plaintext(kat["m2"])), ctx)
            == want("multiply_plain_m2"))


@pytest.mark.parametrize("kind", ["uniform", "ternary", "cbd"])
def test_samplers_match_reference_on_same_words(kind, kat):
    n, t, chain = kat["n"], kat["t"], kat["moduli"]
    jctx, ctx = _ctx_pair(n, t, chain)
    key = jax.random.key(11)
    batch = (3,)
    if kind == "uniform":
        want = rsampling.uniform_rq(key, jctx, batch)
        words = jax.random.bits(key, batch + (2, len(chain), n), jnp.uint32)
        got = sampling.uniform_rq_from_bits(_np(words), ctx)
    elif kind == "ternary":
        want = rsampling.ternary_poly(key, jctx, batch)
        words = jax.random.bits(key, batch + (n,), jnp.uint32)
        got = sampling.ternary_poly_from_bits(_np(words), ctx)
    else:
        want = rsampling.cbd_poly(key, jctx, batch)
        words = jax.random.bits(key, batch + (2, n), jnp.uint32)
        got = sampling.cbd_poly_from_bits(_np(words), ctx)
    assert (got.numpy() == _np(want)).all()
    # The generator-driven form draws the same shapes from torch's words.
    g = torch.Generator().manual_seed(3)
    fn = {"uniform": sampling.uniform_rq, "ternary": sampling.ternary_poly,
          "cbd": sampling.cbd_poly}[kind]
    drawn = fn(g, ctx, batch)
    assert drawn.shape == got.shape and bool((drawn < ctx.q2).all())


@pytest.mark.parametrize("t", [1 << 56, 65537])
def test_scale_and_lift_plain_match_reference(t):
    n = 4096
    chain = rprimes.tpu_default(n)
    jctx, ctx = _ctx_pair(n, t, chain)
    rng = np.random.default_rng(t % 1000)
    m = rng.integers(0, t, size=(2, n), dtype=np.uint64)
    m[0, :4] = [0, 1, (t + 1) // 2, t - 1]
    lo = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (m >> np.uint64(32)).astype(np.uint32)
    want = jctx.scale_plain(jnp.asarray(lo), jnp.asarray(hi))
    assert (ctx.scale_plain(lo, hi).numpy() == _np(want)).all()
    want = jctx.lift_plain_centered(jnp.asarray(lo), jnp.asarray(hi))
    assert (ctx.lift_plain_centered(lo, hi).numpy() == _np(want)).all()


def test_serialize_byte_identical(kat):
    n, t, chain = kat["n"], kat["t"], kat["moduli"]
    jctx, ctx = _ctx_pair(n, t, chain)
    assert serialize.save_parms(ctx.parms) == rser.save_parms(jctx.parms)
    assert serialize.load_parms(rser.save_parms(jctx.parms)) == ctx.parms
    rng = np.random.default_rng(4)
    polys = [_residues(rng.integers(0, 1 << 40, n), chain) for _ in range(2)]
    rct = rbfv.Ciphertext(tuple(jnp.asarray(p.astype(np.uint32)) for p in polys))
    ct = bfv.Ciphertext(tuple(torch.from_numpy(p) for p in polys))
    blob = rser.save_ciphertext(rct, jctx)
    assert serialize.save_ciphertext(ct, ctx) == blob
    back = serialize.load_ciphertext(blob, ctx)
    assert all((a.numpy() == p).all() for a, p in zip(back.polys, polys))


def _roundtrip(ctx, sk, pk, values):
    g = torch.Generator().manual_seed(9)
    plain = bfv.Plaintext(values, n=ctx.n)
    ct = bfv.Encryptor(ctx, pk).encrypt(plain, g)
    return bfv.Decryptor(ctx, sk).decrypt(ct).coeffs[: ctx.n], ct


@pytest.mark.parametrize("engine", ["stage", "vmem"])
def test_keys_from_reference(engine):
    n, t = 256, 65537
    chain = list(get_primes(28, 1, n)) + list(get_primes(27, 1, n))
    jparms = rbfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain)
    jctx = rbfv.BFVContext.build(jparms, engine=engine)
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain), "cpu")
    rsk, rpk = make_sk_pk_jit(jctx, 5)
    perm = None
    if engine == "vmem":
        mono = np.zeros((len(chain), n), np.uint32)
        mono[:, 1] = 1
        x_spec = ntt_vmem.forward_vmem(jnp.asarray(mono), jctx.tables.four_step)
        perm = ntt.order_permutation(_np(x_spec), ctx.tables)
    sk, pk = keys_from_reference(
        ctx, _np(rsk.s_ntt), _np(rsk.s_shoup), _np(rpk.pk0_ntt), _np(rpk.pk1_ntt),
        _np(rpk.pk0_shoup), _np(rpk.pk1_shoup), perm=perm)
    # The secret is the same polynomial: its port spectrum is ours.
    s_coeff = _np(jax.jit(lambda v: rntt.inverse(v, jctx.tables))(rsk.s_ntt))
    assert (sk.s_ntt.numpy() == ntt.forward(torch.from_numpy(s_coeff), ctx.tables).numpy()).all()
    assert (sk.s_shoup.numpy() == bfv.keys.shoup(ctx, sk.s_ntt).numpy()).all()
    assert (pk.pk0_shoup.numpy() == bfv.keys.shoup(ctx, pk.pk0_ntt).numpy()).all()
    # Port encryption under the carried-over keys decrypts in both packages.
    values = list(range(1, 40))
    got, ct = _roundtrip(ctx, sk, pk, values)
    assert got == values + [0] * (n - len(values))
    rct = rser.load_ciphertext(serialize.save_ciphertext(ct, ctx), jctx)
    x = jax.jit(lambda c: rbfv.Decryptor(jctx, rsk).ct_value_rns(c))(rct)
    assert jctx.decode_plain_from_ct_value(np.asarray(x).astype(object))[: len(values)] == values


# ---------------------------------------------------------------------------
# The seal profile (m62)
# ---------------------------------------------------------------------------


def _unpair(p):
    lo, hi = (np.asarray(a).astype(np.uint64) for a in p)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def test_kat_n4096_seal_default(seal_kat):
    """SEAL 4.1 BFVDefault(4096) chain through the injected path, every row
    of the fixture; the multiply through ``RnsMultiplier``, ``Evaluator``
    and ``FusedMultiplier`` (the plain version on the CPU)."""
    kat = seal_kat
    n, t, chain = kat["n"], kat["t"], kat["moduli"]
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain), "cpu")
    assert ctx.tables.profile == "m62"
    tres = lambda c: torch.from_numpy(_residues(c, chain))  # noqa: E731
    fwd = lambda c: ntt.forward(tres(c), ctx.tables)  # noqa: E731

    # Keys from the fixture's (s, pk0, pk1), as tests/test_seal_vectors.py
    # builds them; keygen from (s, a, e) gives the same public key.
    s_ntt = fwd(kat["s"])
    sk = bfv.SecretKey(s_ntt=s_ntt, s_shoup=bfv.keys.shoup(ctx, s_ntt))
    pk0, pk1 = fwd(kat["pk0"]), fwd(kat["pk1"])
    pk = bfv.PublicKey(pk0_ntt=pk0, pk1_ntt=pk1, pk0_shoup=bfv.keys.shoup(ctx, pk0),
                       pk1_shoup=bfv.keys.shoup(ctx, pk1))
    sk2, pk2 = make_keys(ctx, tres(kat["s"]), fwd(kat["a"]), tres(kat["e"]))
    for name in ("pk0_ntt", "pk1_ntt", "pk0_shoup", "pk1_shoup"):
        assert torch.equal(getattr(pk2, name), getattr(pk, name)), name
    assert torch.equal(sk2.s_shoup, sk.s_shoup)

    exp = kat["expected"]
    want = lambda key: [[int(v) % ctx.q for v in p] for p in exp[key]]  # noqa: E731
    enc = bfv.Encryptor(ctx, pk)
    ct1 = enc.encrypt_with_randomness(bfv.Plaintext(kat["m1"]), tres(kat["u1"]),
                                      tres(kat["e01"]), tres(kat["e11"]))
    ct2 = enc.encrypt_with_randomness(bfv.Plaintext(kat["m2"]), tres(kat["u2"]),
                                      tres(kat["e02"]), tres(kat["e12"]))
    assert _ct_ints(ct1, ctx) == want("ct1")
    assert _ct_ints(ct2, ctx) == want("ct2")
    assert bfv.Decryptor(ctx, sk).decrypt(ct1).coeffs[:n] == exp["decrypt_ct1"]
    ev = bfv.Evaluator(ctx)
    assert _ct_ints(ev.add(ct1, ct2), ctx) == want("add")
    assert _ct_ints(ev.sub(ct1, ct2), ctx) == want("sub")
    assert _ct_ints(ev.add_plain(ct1, bfv.Plaintext(kat["m2"])), ctx) == want("add_plain_m2")
    assert (_ct_ints(ev.multiply_plain(ct1, bfv.Plaintext(kat["m2"])), ctx)
            == want("multiply_plain_m2"))
    mul = behz.RnsMultiplier(ctx)
    assert mul.K == 5
    ct3 = mul.multiply(ct1, ct2)
    assert _ct_ints(ct3, ctx) == want("multiply")
    assert _ct_ints(ev.multiply(ct1, ct2), ctx) == want("multiply")
    assert _ct_ints(FusedMultiplier(ctx).multiply(ct1, ct2), ctx) == want("multiply")
    inject = [(tres(a), tres(e)) for a, e in zip(kat["relin_a"], kat["relin_e"])]
    rlk = behz.create_relin_keys(ctx, sk, None, inject=inject)
    assert rlk.groups == ((0,), (1,), (2,))  # width 1, as the fixture's digits
    rel = behz.relinearize(ctx, ct3, rlk)
    assert _ct_ints(rel, ctx) == want("relinearize")
    assert _ct_ints(ev.relinearize(ct3, rlk), ctx) == want("relinearize")
    assert (_ct_ints(FusedMultiplier(ctx, rlk).multiply_relinearize(ct1, ct2), ctx)
            == want("relinearize"))
    assert bfv.Decryptor(ctx, sk).decrypt(rel).coeffs[:n] == exp["decrypt_product"]
    small, ms = bfv.evaluator.mod_switch_to_next(ctx, ct1)
    assert small.L == 2
    assert _ct_ints(ms, small) == [[int(v) % small.q for v in p]
                                   for p in exp["mod_switch_ct1"]]
    small_sk = bfv.evaluator.restrict_secret_key(small, sk)
    assert bfv.Decryptor(small, small_sk).decrypt(ms).coeffs[:n] == exp["decrypt_ct1"]


def _seal_pair(n=256, t=65537):
    chain = list(get_primes(36, 2, n)) + list(get_primes(37, 1, n))
    return _ctx_pair(n, t, chain)


@pytest.mark.parametrize("kind", ["uniform", "ternary", "cbd"])
def test_m62_samplers_match_reference_on_same_words(kind):
    jctx, ctx = _seal_pair()
    assert ctx.tables.profile == "m62"
    key = jax.random.key(12)
    batch = (2,)
    L, n = ctx.L, ctx.n
    if kind == "uniform":
        want = _unpair(rsampling.uniform_rq(key, jctx, batch))
        words = jax.random.bits(key, batch + (4, L, n), jnp.uint32)
        got = sampling.uniform_rq_from_bits(_np(words), ctx)
    elif kind == "ternary":
        want = _unpair(rsampling.ternary_poly(key, jctx, batch))
        words = jax.random.bits(key, batch + (n,), jnp.uint32)
        got = sampling.ternary_poly_from_bits(_np(words), ctx)
    else:
        want = _unpair(rsampling.cbd_poly(key, jctx, batch))
        words = jax.random.bits(key, batch + (2, n), jnp.uint32)
        got = sampling.cbd_poly_from_bits(_np(words), ctx)
    assert (got.numpy() == want).all()
    g = torch.Generator().manual_seed(4)
    fn = {"uniform": sampling.uniform_rq, "ternary": sampling.ternary_poly,
          "cbd": sampling.cbd_poly}[kind]
    drawn = fn(g, ctx, batch)
    assert drawn.shape == got.shape and bool(((drawn >= 0) & (drawn < ctx.q2)).all())


def test_m62_scale_and_lift_plain_match_reference():
    jctx, ctx = _ctx_pair(4096, 1 << 56, list(rprimes.bfv_default(4096)))
    t = ctx.t
    rng = np.random.default_rng(56)
    m = rng.integers(0, t, size=(2, ctx.n), dtype=np.uint64)
    m[0, :4] = [0, 1, (t + 1) // 2, t - 1]
    lo = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (m >> np.uint64(32)).astype(np.uint32)
    want = jax.jit(jctx.scale_plain)(jnp.asarray(lo), jnp.asarray(hi))
    assert (ctx.scale_plain(lo, hi).numpy() == _unpair(want)).all()
    want = jax.jit(jctx.lift_plain_centered)(jnp.asarray(lo), jnp.asarray(hi))
    assert (ctx.lift_plain_centered(lo, hi).numpy() == _unpair(want)).all()


def test_keys_from_reference_m62_pairs():
    jctx, ctx = _seal_pair()
    rsk, rpk = make_sk_pk_jit(jctx, 6)
    leaves = {"s_ntt": rsk.s_ntt, "s_shoup": rsk.s_shoup, "pk0_ntt": rpk.pk0_ntt,
              "pk1_ntt": rpk.pk1_ntt, "pk0_shoup": rpk.pk0_shoup, "pk1_shoup": rpk.pk1_shoup}
    pairs = {k: tuple(np.asarray(a) for a in v) for k, v in leaves.items()}
    sk, pk = keys_from_reference(ctx, **pairs)
    for name, ref_pair in pairs.items():
        obj = sk if name.startswith("s_") else pk
        assert (getattr(obj, name).numpy() == _unpair(ref_pair)).all(), name
    # Shoup companions reach 2^64 - 1: stored as bit patterns, recomputed equal.
    assert bool((pk.pk0_shoup < 0).any())
    assert torch.equal(pk.pk0_shoup, bfv.keys.shoup(ctx, pk.pk0_ntt))
    values = list(range(1, 40))
    got, ct = _roundtrip(ctx, sk, pk, values)
    assert got == values + [0] * (ctx.n - len(values))
    rct = rser.load_ciphertext(serialize.save_ciphertext(ct, ctx), jctx)
    x = jax.jit(lambda c: rbfv.Decryptor(jctx, rsk).ct_value_rns(c))(rct)
    assert jctx.decode_plain_from_ct_value(np.asarray(_unpair(x)).astype(object))[
        : len(values)] == values


@pytest.mark.parametrize("profile", ["tpu", "seal"])
def test_invariant_noise_budget_matches_reference(profile):
    n, t = 256, 65537
    if profile == "tpu":
        jctx, ctx = _ctx_pair(n, t, list(get_primes(28, 1, n)) + list(get_primes(27, 1, n)))
    else:
        jctx, ctx = _seal_pair(n, t)
    rsk, rpk = make_sk_pk_jit(jctx, 7)
    leaves = (rsk.s_ntt, rsk.s_shoup, rpk.pk0_ntt, rpk.pk1_ntt, rpk.pk0_shoup, rpk.pk1_shoup)
    sk, pk = keys_from_reference(
        ctx, *(tuple(np.asarray(a) for a in v) if isinstance(v, tuple) else _np(v)
               for v in leaves))
    _, ct = _roundtrip(ctx, sk, pk, list(range(1, 20)))
    ev = bfv.Evaluator(ctx)
    dec, rdec = bfv.Decryptor(ctx, sk), rbfv.Decryptor(jctx, rsk)
    rdec.ct_value_rns = jax.jit(rdec.ct_value_rns)  # one compile, not eager stages
    budgets = []
    for c in (ct, ev.multiply_plain(ct, bfv.Plaintext([3, 0, 5]))):
        rct = rser.load_ciphertext(serialize.save_ciphertext(c, ctx), jctx)
        budgets.append(dec.invariant_noise_budget(c))
        assert budgets[-1] == rdec.invariant_noise_budget(rct)
    assert budgets[0] > budgets[1] > 0
