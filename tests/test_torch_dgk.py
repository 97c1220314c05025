"""The port's batched DGK against the reference's on the CPU: the plain
``MontgomeryCtx`` against ``pplp_tpu.dgk.modexp.MontgomeryCtx`` on a 384-bit
modulus, and ``DGKBatch`` / ``DGKDeviceTable`` against ``pplp_tpu.dgk.batched``
with (k, t, l) = (512, 64, 12) keys, on the same inputs (made with numpy
from a seed).

Bit-exact (tolerance 0), Montgomery-domain values included. The reference
runs each call once, jitted, in the module fixtures (~25 s); its eager
digit scans would cost seconds per product. The randomness of the
encryptions is cut to 24 bits there: the reference's exponentiation is a
scan over the batch's longest exponent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu.dgk import batched as rbatched
from pplp_tpu.dgk import dgk_encrypt, dgk_gen_keys
from pplp_tpu.dgk import modexp as rmodexp
from pplp_tpu_torch.dgk import batched, modexp
from pplp_tpu_torch.ops import dgk_cuda

K, T, L = 512, 64, 12
B = 4
R_BITS = 24
XB, YB, S_BLIND, R_BLIND = 14, 11, 37, 15
SHARED_EXPS = (37, (1 << 70) + 12345)  # below and above 64 bits


def _ints(rng, count, below):
    """``count`` integers in [0, below) from numpy's generator."""
    nbytes = (below.bit_length() + 71) // 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % below for _ in range(count)]


def _np(t):
    return np.asarray(t).astype(np.int64)


@pytest.fixture(scope="module")
def mont():
    rng = np.random.default_rng(384)
    n = int.from_bytes(rng.bytes(48), "little") | (1 << 383) | 1
    a = [0, 1, n - 1] + _ints(rng, B, n)
    b = [n - 1, n - 1, 1] + _ints(rng, B, n)
    exps = [0, 1] + _ints(rng, len(a) - 2, 1 << 96)
    rmc = rmodexp.MontgomeryCtx.build(n)
    A, Bd = (jnp.asarray(rmodexp.to_digits(v, rmc.D)) for v in (a, b))
    bits = jnp.asarray(rmodexp.exp_to_bits(exps, 96))
    ref = dict(zip(
        ("mont_mul", "to_mont", "from_mont", "mulmod", "powmod", "powmod_shared_base"),
        jax.jit(lambda x, y, e: (rmc.mont_mul(x, y), rmc.to_mont(x), rmc.from_mont(x),
                                 rmc.mulmod(x, y), rmc.powmod(x, e), rmc.powmod(x[:1], e)))(
            A, Bd, bits)))
    for e in SHARED_EXPS:
        ref[e] = jax.jit(lambda x, e=e: rmc.powmod_shared_exp(x, e))(A)
    return dict(n=n, a=a, b=b, exps=exps, rmc=rmc,
                ref={k: _np(v) for k, v in ref.items()},
                mc=modexp.MontgomeryCtx.build(n, device="cpu"))


@pytest.fixture(scope="module")
def dgk():
    """Keys, ciphertexts and clear coordinates, and every reference call."""
    rng = np.random.default_rng(512)
    priv, pub = dgk_gen_keys(K, T, L, seed=7)
    u = pub.u
    ms = _ints(rng, B, u)
    rs = _ints(rng, B, 1 << R_BITS)
    xa, ya = _ints(rng, B, 60), _ints(rng, B, 60)
    plain = [[(x * x + y * y) % u for x, y in zip(xa, ya)], [(-2 * x) % u for x in xa],
             [(-2 * y) % u for y in ya], [S_BLIND * (XB * XB + YB * YB) % u] * B,
             [S_BLIND * R_BLIND % u] * B]
    cts = [[dgk_encrypt(pub, m, r) for m, r in zip(row, _ints(rng, B, 1 << 2 * T))]
           for row in plain]
    rdb = rbatched.DGKBatch.build(pub)
    D = rdb.mc.D
    rc = [jnp.asarray(rmodexp.to_digits(c, D)) for c in cts]
    ref = {"encrypt": jax.jit(lambda: rdb.encrypt_batch(ms, rs))()}
    ref["blind"] = jax.jit(lambda c1, c2, c3, cz, cr: rdb.blind_distance_batch(
        c1, c2, c3, XB, YB, S_BLIND, cz, cr))(*rc)
    ref["decrypt"] = rdb.decrypt_batch(priv, ref["blind"])
    ref["dtab"] = rdb.build_device_table(priv)
    ref["btab"] = rdb.build_bsgs_table(priv)
    ref["decrypt_device"] = jax.jit(
        lambda c: rdb.decrypt_batch_device(priv, ref["dtab"], c))(ref["blind"])
    ref["decrypt_bsgs"] = jax.jit(
        lambda c: rdb.decrypt_batch_device_bsgs(priv, ref["btab"], c))(ref["blind"])
    db = batched.DGKBatch.build(pub, device="cpu")
    want = [S_BLIND * ((x - XB) ** 2 + (y - YB) ** 2 + R_BLIND) % u for x, y in zip(xa, ya)]
    return dict(priv=priv, pub=pub, ms=ms, rs=rs, want=want, ref=ref, db=db,
                cts=[modexp.to_digits(c, D) for c in cts])


def test_montgomery_constants_match_reference(mont):
    mc, rmc = mont["mc"], mont["rmc"]
    assert mc.D == rmc.D
    for name in ("n", "r2", "one_mont"):
        assert np.array_equal(getattr(mc, name).numpy(), _np(getattr(rmc, name))), name


def test_digit_layout_matches_reference(mont):
    mc = mont["mc"]
    digs = modexp.to_digits(mont["a"], mc.D)
    assert np.array_equal(digs.numpy(), _np(rmodexp.to_digits(mont["a"], mc.D)))
    assert modexp.from_digits(digs) == rmodexp.from_digits(digs.numpy()) == mont["a"]
    bits = modexp.exp_to_bits(mont["exps"], 96)
    assert np.array_equal(bits.numpy(), _np(rmodexp.exp_to_bits(mont["exps"], 96)))


@pytest.mark.parametrize("op", ["mont_mul", "to_mont", "from_mont", "mulmod"])
def test_montgomery_ops_match_reference(mont, op):
    """Montgomery-domain outputs (mont_mul, to_mont) included."""
    mc = mont["mc"]
    A, Bd = (modexp.to_digits(mont[k], mc.D) for k in "ab")
    got = {"mont_mul": lambda: mc.mont_mul(A, Bd), "to_mont": lambda: mc.to_mont(A),
           "from_mont": lambda: mc.from_mont(A), "mulmod": lambda: mc.mulmod(A, Bd)}[op]()
    assert np.array_equal(got.numpy(), mont["ref"][op])
    if op == "mulmod":
        n = mont["n"]
        assert modexp.from_digits(got) == [x * y % n for x, y in zip(mont["a"], mont["b"])]


@pytest.mark.parametrize("shared_base", [False, True], ids=["lane-bases", "shared-base"])
def test_powmod_matches_reference(mont, shared_base):
    mc = mont["mc"]
    A = modexp.to_digits(mont["a"], mc.D)
    got = mc.powmod(A[:1] if shared_base else A, modexp.exp_to_bits(mont["exps"], 96))
    assert np.array_equal(got.numpy(), mont["ref"]["powmod_shared_base" if shared_base
                                                     else "powmod"])
    # The dispatcher's plain branch (a CPU tensor) gives the same.
    assert torch.equal(dgk_cuda.powmod(mc, A[:1] if shared_base else A, mont["exps"]), got)


@pytest.mark.parametrize("exp", SHARED_EXPS, ids=["37", "2^70+12345"])
def test_powmod_shared_exp_matches_reference(mont, exp):
    mc = mont["mc"]
    A = modexp.to_digits(mont["a"], mc.D)
    got = mc.powmod_shared_exp(A, exp)
    assert np.array_equal(got.numpy(), mont["ref"][exp])
    assert modexp.from_digits(got) == [pow(x, exp, mont["n"]) for x in mont["a"]]
    assert torch.equal(dgk_cuda.powmod_shared_exp(mc, A, exp), got)


def test_encrypt_batch_matches_reference(dgk):
    got = dgk["db"].encrypt_batch(dgk["ms"], dgk["rs"])
    assert np.array_equal(got.numpy(), _np(dgk["ref"]["encrypt"]))
    assert dgk["db"].decrypt_batch(dgk["priv"], got) == dgk["ms"]


def test_blind_distance_batch_matches_reference(dgk):
    got = dgk["db"].blind_distance_batch(*dgk["cts"][:3], XB, YB, S_BLIND, *dgk["cts"][3:])
    assert np.array_equal(got.numpy(), _np(dgk["ref"]["blind"]))
    assert dgk["db"].decrypt_batch(dgk["priv"], got) == dgk["ref"]["decrypt"] == dgk["want"]


@pytest.mark.parametrize("which", ["dtab", "btab"])
def test_device_tables_match_reference(dgk, which):
    db, priv = dgk["db"], dgk["priv"]
    got = db.build_device_table(priv) if which == "dtab" else db.build_bsgs_table(priv)
    ref = dgk["ref"][which]
    assert (got.size, got.probes) == (ref.size, ref.probes)
    for name in ("fp1", "fp2", "msg"):
        assert np.array_equal(getattr(got, name).numpy(), _np(getattr(ref, name))), name


def test_fingerprint_fold_matches_horner(dgk):
    """The device fold (one weighted sum) equals the reference's wrapping
    u32 Horner fold, on digits at their largest too."""
    D = dgk["db"].mc.D
    digs = np.concatenate([dgk["cts"][0].numpy(), np.full((1, D), 0xFFFF)])
    for mult in (batched._FP_A1, batched._FP_A2):
        got = batched._fp_device(torch.from_numpy(digs), batched._fp_powers(mult, D, "cpu"))
        want = np.asarray(rbatched._fp_device(jnp.asarray(digs.astype(np.uint32)), mult))
        assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("how", ["table", "bsgs"])
def test_device_decrypt_matches_reference(dgk, how):
    db, priv = dgk["db"], dgk["priv"]
    blind = modexp.to_digits(modexp.from_digits(_np(dgk["ref"]["blind"])), db.mc.D)
    if how == "table":
        got = db.decrypt_batch_device(priv, db.build_device_table(priv), blind)
        ref = dgk["ref"]["decrypt_device"]
    else:
        got = db.decrypt_batch_device_bsgs(priv, db.build_bsgs_table(priv), blind)
        ref = dgk["ref"]["decrypt_bsgs"]
    assert got.tolist() == _np(ref).tolist() == dgk["want"]
