"""The port's ct x ct multiply and relinearization against the reference.

Bit for bit (tolerance 0: every step is exact integer arithmetic):

* the m31 known-answer vectors (``tests/fixtures/bfv_kat_n64_m31.json.gz``):
  BEHZ multiply, relinearization with the injected per-digit randomness
  (width 1), decryption of the product and mod_switch_to_next;
* ``pplp_tpu.bfv.behz`` at N = 256 on a 4-prime chain, batch 2, with the
  reference's keys carried over by ``relin_keys_from_reference``: multiply,
  relinearize and multiply + relinearize at gadget widths 1 and 2, through
  ``RnsMultiplier``, ``FusedMultiplier`` and ``Evaluator`` (all of which run
  the plain version on the CPU);
* ``lift_digit_grouped`` and ``default_relin_width`` on the tpu chains
  n = 1024..32768, and the mulmod-chain probe against the reference's
  ``m31.mulmod_shoup``.

The reference side runs under ``jax.jit`` in module-scoped fixtures.
"""

import gzip
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import behz as rbehz
from pplp_tpu.bfv.evaluator import mod_switch_to_next as rmod_switch
from pplp_tpu.ops.modmath import m31 as rm31
from pplp_tpu.ops.primes import get_primes
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.bfv import keys as pkeys
from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
from pplp_tpu_torch.bfv.evaluator import mod_switch_to_next, restrict_secret_key
from pplp_tpu_torch.ops import behz_cuda, cuda_build, mulmod_chain, ntt
from pplp_tpu_torch.ops import primes as pprimes
from pplp_tpu_torch.ops.modmath import m31, shoup_ints

_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "bfv_kat_n64_m31.json.gz")
N = 256
T = 1 << 16
CHAIN = list(get_primes(28, 2, N)) + list(get_primes(27, 2, N))


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ct_ints(ct, ctx):
    return [ctx.crt_compose(p.numpy()) for p in ct.polys]


def _negacyclic(a, b, t):
    n = len(a)
    full = np.convolve(np.asarray(a, np.int64), np.asarray(b, np.int64))
    full = np.concatenate([full, [0]])
    return [int(v) % t for v in full[:n] - full[n:]]


# ---------------------------------------------------------------------------
# Known-answer vectors (m31, n = 64)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kat():
    with gzip.open(_FIX, "rt") as f:
        fix = json.load(f)
    n, t, chain = fix["n"], fix["t"], fix["moduli"]
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, t, coeff_modulus=chain), "cpu")
    res = lambda c: torch.tensor([[int(v) % q for v in c] for q in chain])  # noqa: E731
    sk, pk = pkeys.make_keys(ctx, res(fix["s"]), ntt.forward(res(fix["a"]), ctx.tables),
                             res(fix["e"]))
    enc = bfv.Encryptor(ctx, pk)
    ct1 = enc.encrypt_with_randomness(bfv.Plaintext(fix["m1"]), res(fix["u1"]),
                                      res(fix["e01"]), res(fix["e11"]))
    ct2 = enc.encrypt_with_randomness(bfv.Plaintext(fix["m2"]), res(fix["u2"]),
                                      res(fix["e02"]), res(fix["e12"]))
    inject = [(res(a), res(e)) for a, e in zip(fix["relin_a"], fix["relin_e"])]
    rlk = behz.create_relin_keys(ctx, sk, None, inject=inject)
    return fix, ctx, sk, ct1, ct2, rlk


def _want(fix, ctx, key):
    return [[int(v) % ctx.q for v in p] for p in fix["expected"][key]]


def test_kat_multiply_relinearize_decrypt(kat):
    fix, ctx, sk, ct1, ct2, rlk = kat
    assert rlk.groups == ((0,), (1,), (2,))
    ct3 = behz.RnsMultiplier(ctx).multiply(ct1, ct2)
    assert _ct_ints(ct3, ctx) == _want(fix, ctx, "multiply")
    rel = behz.relinearize(ctx, ct3, rlk)
    assert _ct_ints(rel, ctx) == _want(fix, ctx, "relinearize")
    dec = bfv.Decryptor(ctx, sk)
    assert dec.decrypt(rel).coeffs[: ctx.n] == fix["expected"]["decrypt_product"]
    # The evaluator's entry points give the same ciphertexts.
    ev = bfv.Evaluator(ctx)
    assert _ct_ints(ev.multiply(ct1, ct2), ctx) == _want(fix, ctx, "multiply")
    assert _ct_ints(ev.relinearize(ct3, rlk), ctx) == _want(fix, ctx, "relinearize")
    assert (_ct_ints(ev.multiply_relinearize(ct1, ct2, rlk), ctx)
            == _want(fix, ctx, "relinearize"))


def test_kat_mod_switch(kat):
    fix, ctx, sk, ct1, _, _ = kat
    small, ct = mod_switch_to_next(ctx, ct1)
    assert small.L == ctx.L - 1
    assert _ct_ints(ct, small) == _want(fix, small, "mod_switch_ct1")
    got = bfv.Decryptor(small, restrict_secret_key(small, sk)).decrypt(ct)
    assert got.coeffs[: ctx.n] == fix["expected"]["decrypt_ct1"]


def test_plain_version_is_plain_ntt_independent(kat, monkeypatch):
    """The plain version transforms with forward_plain/inverse_plain only,
    never through the dispatch that sends a CUDA tensor to the NTT kernel,
    so the kernel never vouches for itself on the card."""
    fix, ctx, _, ct1, ct2, rlk = kat

    def refuse(*args, **kwargs):
        raise AssertionError("the plain BEHZ version called the dispatching NTT")

    monkeypatch.setattr(ntt, "forward", refuse)
    monkeypatch.setattr(ntt, "inverse", refuse)
    ct3 = behz.RnsMultiplier(ctx).multiply(ct1, ct2)
    assert _ct_ints(ct3, ctx) == _want(fix, ctx, "multiply")
    assert _ct_ints(behz.relinearize(ctx, ct3, rlk), ctx) == _want(fix, ctx, "relinearize")


# ---------------------------------------------------------------------------
# Port vs reference at N = 256, batch 2, widths 1 and 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref256():
    jctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN), "cpu")
    rsk, rlk2 = rbehz.make_keys_jit(jctx, 3)
    rlk1 = jax.jit(lambda k: rbehz.create_relin_keys(jctx, rsk, k, width=1))(
        jax.random.key(5))
    rng = np.random.default_rng(0)
    qs = np.asarray(CHAIN, np.int64)[:, None]
    polys = [rng.integers(0, 1 << 62, size=(2, len(CHAIN), N)) % qs for _ in range(4)]
    polys[0][0, :, :3] = qs - 1  # largest canonical residues
    jct = lambda a, b: rbfv.Ciphertext(  # noqa: E731
        (jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))), "coeff")
    mul = rbehz.RnsMultiplier(jctx)
    j3 = jax.jit(mul.multiply)(jct(*polys[:2]), jct(*polys[2:]))
    want = {"multiply": [_np(p) for p in j3.polys]}
    keys = {}
    for width, rlk in ((1, rlk1), (2, rlk2)):
        rel = jax.jit(lambda c, r=rlk: rbehz.relinearize(jctx, c, r))(j3)
        want[width] = [_np(p) for p in rel.polys]
        keys[width] = behz.relin_keys_from_reference(
            ctx, *(_np(x) for x in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)),
            rlk.groups)
    pct = lambda a, b: bfv.Ciphertext((torch.from_numpy(a), torch.from_numpy(b)))  # noqa: E731
    return jctx, ctx, pct(*polys[:2]), pct(*polys[2:]), keys, want


def _equal(ct, want):
    return len(ct.polys) == len(want) and all(
        (p.numpy() == w).all() for p, w in zip(ct.polys, want))


def test_keys_carried_over_with_their_groups(ref256):
    _, ctx, _, _, keys, _ = ref256
    assert keys[1].groups == ((0,), (1,), (2,), (3,))
    assert keys[2].groups == ((0, 1), (2, 3))
    assert behz.default_relin_width(ctx) == 2
    for k in keys.values():
        assert torch.equal(k.k0_shoup, pkeys.shoup(ctx, k.k0))
        assert torch.equal(k.k1_shoup, pkeys.shoup(ctx, k.k1))


@pytest.mark.parametrize("via", ["rns", "fused", "evaluator"])
def test_multiply_matches_reference(ref256, via):
    _, ctx, ct1, ct2, _, want = ref256
    if via == "rns":
        got = behz.RnsMultiplier(ctx).multiply(ct1, ct2)
    elif via == "fused":
        got = FusedMultiplier(ctx).multiply(ct1, ct2)
    else:
        got = bfv.Evaluator(ctx).multiply(ct1, ct2)
    assert _equal(got, want["multiply"])


@pytest.mark.parametrize("width", [1, 2])
def test_relinearize_matches_reference(ref256, width):
    _, ctx, _, _, keys, want = ref256
    ct3 = bfv.Ciphertext(tuple(torch.from_numpy(p) for p in want["multiply"]))
    assert _equal(behz.relinearize(ctx, ct3, keys[width]), want[width])
    assert _equal(bfv.Evaluator(ctx).relinearize(ct3, keys[width]), want[width])
    assert _equal(FusedMultiplier(ctx, keys[width]).relinearize(ct3), want[width])


@pytest.mark.parametrize("width", [1, 2])
def test_multiply_relinearize_matches_reference(ref256, width):
    _, ctx, ct1, ct2, keys, want = ref256
    before = behz_cuda.launches
    assert _equal(FusedMultiplier(ctx, keys[width]).multiply_relinearize(ct1, ct2),
                  want[width])
    assert _equal(bfv.Evaluator(ctx).multiply_relinearize(ct1, ct2, keys[width]),
                  want[width])
    assert behz_cuda.launches == before  # the CPU runs the plain version


def test_mod_switch_matches_reference(ref256):
    jctx, ctx, ct1, _, _, _ = ref256
    rct = rbfv.Ciphertext(tuple(jnp.asarray(p.numpy().astype(np.uint32)) for p in ct1.polys))
    rsmall, rout = rmod_switch(jctx, rct)
    small, out = mod_switch_to_next(ctx, ct1)
    assert [m.value for m in small.moduli] == [m.value for m in rsmall.moduli]
    assert _equal(out, [_np(p) for p in rout.polys])


def test_lift_digit_grouped_at_both_widths(ref256):
    jctx, ctx, ct1, _, _, _ = ref256
    poly = ct1.polys[0]
    for width in (1, 2):
        for g in behz._digit_groups(ctx.L, width):
            want = rbehz.lift_digit_grouped(jctx, jnp.asarray(poly.numpy().astype(np.uint32)), g)
            assert (behz.lift_digit_grouped(ctx, poly, g).numpy() == _np(want)).all()


# ---------------------------------------------------------------------------
# Keys, digit lifts and the gadget width on the tpu chains
# ---------------------------------------------------------------------------


def _key_noise(ctx, sk, rlk) -> int:
    """max |e_j| over digits j, from b_j + a_j s - g_j s^2 = -e_j (the same
    small polynomial in every limb, else the keys are not keys of sk)."""
    q2 = ctx.q2
    s2 = m31.mulmod_shoup(sk.s_ntt, sk.s_ntt, sk.s_shoup, q2)
    worst = 0
    for j, group in enumerate(rlk.digit_groups(ctx.L)):
        sel = torch.zeros((ctx.L, 1), dtype=torch.int64)
        sel[list(group)] = 1
        v = m31.mulmod_shoup(rlk.k1[j], sk.s_ntt, sk.s_shoup, q2)
        v = m31.sub(m31.add(rlk.k0[j], v, q2), s2 * sel, q2)
        e = ntt.inverse(v, ctx.tables)
        centered = torch.where(e > q2 // 2, e - q2, e)
        assert torch.equal(centered, centered[:1].expand_as(centered))
        worst = max(worst, int(centered.abs().max()))
    return worst


def test_make_keys_gives_valid_default_width_keys():
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN), "cpu")
    g = torch.Generator().manual_seed(4)
    sk, rlk = behz.make_keys(ctx, g)
    assert rlk.groups == ((0, 1), (2, 3))
    assert _key_noise(ctx, sk, rlk) <= 21  # CBD(21)


def test_relin_keys_carried_over_from_the_vmem_order():
    """Keys generated under the reference's vmem engine, moved into the
    port's order by the derived permutation, are relinearization keys of the
    moved secret."""
    from pplp_tpu.ops import ntt_vmem

    jctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN),
                                 engine="vmem")
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN), "cpu")
    rsk, rlk = rbehz.make_keys_jit(jctx, 7)
    mono = np.zeros((len(CHAIN), N), np.uint32)
    mono[:, 1] = 1
    perm = ntt.order_permutation(
        _np(ntt_vmem.forward_vmem(jnp.asarray(mono), jctx.tables.four_step)), ctx.tables)
    keys = behz.relin_keys_from_reference(
        ctx, *(_np(x) for x in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)), rlk.groups,
        perm=perm)
    s_ntt = pkeys.from_reference_array(ctx, _np(rsk.s_ntt), perm)
    sk = pkeys.SecretKey(s_ntt=s_ntt, s_shoup=pkeys.shoup(ctx, s_ntt))
    assert keys.groups == ((0, 1), (2, 3))
    assert torch.equal(keys.k0_shoup, pkeys.shoup(ctx, keys.k0))
    assert _key_noise(ctx, sk, keys) <= 21


def test_real_product_decrypts_on_cpu():
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN), "cpu")
    g = torch.Generator().manual_seed(8)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rlk = behz.create_relin_keys(ctx, sk, g)
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, T, size=N).tolist() for _ in range(2))
    enc, ev, dec = bfv.Encryptor(ctx, pk), bfv.Evaluator(ctx), bfv.Decryptor(ctx, sk)
    ca, cb = enc.encrypt(bfv.Plaintext(a), g), enc.encrypt(bfv.Plaintext(b), g)
    want = _negacyclic(a, b, T)
    assert dec.decrypt(ev.multiply_relinearize(ca, cb, rlk)).coeffs[:N] == want
    assert dec.decrypt(ev.multiply(ca, cb)).coeffs[:N] == want  # size 3, with s^2


LIFT_N = 1024  # the lift is coefficient-wise: every tpu chain's primes are NTT-friendly here


@pytest.fixture(scope="module")
def tpu_contexts():
    """Per tpu chain: the port's context at its own n, and both packages'
    contexts over that chain at n = LIFT_N for the digit lifts."""
    out = {}
    for n in (1024, 2048, 4096, 8192, 16384, 32768):
        chain = pprimes.tpu_default(n)
        ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, T, coeff_modulus=chain),
                                   "cpu")
        jsmall = rbfv.BFVContext.build(
            rbfv.EncryptionParameters.bfv(LIFT_N, T, coeff_modulus=chain))
        small = bfv.BFVContext.build(
            bfv.EncryptionParameters.bfv(LIFT_N, T, coeff_modulus=chain), "cpu")
        out[n] = (ctx, jsmall, small)
    return out


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384, 32768])
def test_lift_and_width_on_tpu_chains(tpu_contexts, n):
    ctx, jsmall, small = tpu_contexts[n]
    # The reference's width rule reads q, t, L, n and the moduli only.
    view = SimpleNamespace(q=ctx.q, t=ctx.t, L=ctx.L, n=ctx.n, moduli=ctx.moduli)
    assert behz.default_relin_width(ctx) == rbehz.default_relin_width(view)
    rng = np.random.default_rng(n)
    qs = np.asarray([m.value for m in small.moduli], np.int64)[:, None]
    poly = rng.integers(0, 1 << 62, size=(small.L, LIFT_N)) % qs
    poly[:, :2] = qs - 1
    jpoly = jnp.asarray(poly.astype(np.uint32))
    groups = behz._digit_groups(small.L, 1)[:2] + behz._digit_groups(small.L, 2)[-2:]
    for g in groups:
        want = _np(rbehz.lift_digit_grouped(jsmall, jpoly, g))
        assert (behz.lift_digit_grouped(small, torch.from_numpy(poly), g).numpy() == want).all()


def test_default_width_at_the_multiply_benchmark_chain(tpu_contexts):
    """The tpu n = 4096 chain with t = 2^16 picks width 2 in both packages."""
    ctx = tpu_contexts[4096][0]
    jctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(4096, T, profile="tpu"))
    assert ctx.L == 4 and behz.default_relin_width(ctx) == 2
    assert rbehz.default_relin_width(jctx) == 2
    assert behz.multiplier(ctx).K == 6
    assert len(rbehz.RnsMultiplier(jctx).base_bsk.moduli) == 6


# ---------------------------------------------------------------------------
# The mulmod-chain probe and the CUDA wrappers on the CPU
# ---------------------------------------------------------------------------


def test_chain_plain_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.integers(0, mulmod_chain.Q, size=(8, 4, 256), dtype=np.int64)
    x[0, 0, :4] = [0, 1, mulmod_chain.Q - 1, (1 << 32) - 1]  # any u32 is a valid input
    y = jnp.asarray(x.astype(np.uint32))
    for _ in range(16):
        y = rm31.mulmod_shoup(y, jnp.uint32(mulmod_chain.W), jnp.uint32(mulmod_chain.WS),
                              jnp.uint32(mulmod_chain.Q))
    got = mulmod_chain.chain_plain(torch.from_numpy(x))
    assert (got.numpy() == _np(y)).all()
    assert torch.equal(mulmod_chain.chain(torch.from_numpy(x)), got)
    assert mulmod_chain.launches == 0
    with pytest.raises(ValueError):
        mulmod_chain.chain_plain(torch.from_numpy(x), w=5, ws=7)


def test_shoup_ints_match_the_device_precompute():
    """The host constants the kernels' buffers are packed from."""
    qs = list(CHAIN) + [(1 << 30) - (1 << 18) + 1]
    vals = [0, 1, -1, 1 << 40, qs[-1] - 1]
    w, ws = shoup_ints(vals, qs)
    assert w == [v % q for v, q in zip(vals, qs)]
    want = m31.shoup_precompute(torch.tensor(w), torch.tensor(qs))
    assert ws == want.tolist()


def test_cuda_wrappers_refuse_cpu_tensors(ref256):
    _, ctx, ct1, ct2, keys, _ = ref256
    with pytest.raises(ValueError, match="CUDA tensors"):
        behz_cuda.multiply(*ct1.polys, *ct2.polys, behz.multiplier(ctx))
    with pytest.raises(ValueError, match="CUDA tensors"):
        behz_cuda.relinearize(*ct1.polys, ct2.polys[0], ctx, keys[2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        mulmod_chain.chain_cuda(ct1.polys[0])
    assert behz_cuda.launches == 0 and mulmod_chain.launches == 0


def test_measurement_refuses_to_run_without_a_card(capsys):
    from pplp_tpu_torch import measure_multiply

    assert measure_multiply.main([]) == 1
    assert "needs a GPU" in capsys.readouterr().err


def test_parallel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    sources = [cuda_build.CSRC / name for name in ("behz.cu", "mulmod_chain.cu", "ntt.cu")]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(sources, tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_constant_buffer_layout(ref256):
    """The packed constants have exactly the length behz.cu's layout reads."""
    _, ctx, _, _, keys, _ = ref256
    mul = behz.multiplier(ctx)
    L, K = ctx.L, mul.K
    l = K - 1
    buf, scalars = behz_cuda._pack_constants(mul)
    assert len(buf) == 4 + 11 * L + 9 * K + 2 * K * L + 4 * l + 2 * L * l
    assert buf[:4] == scalars
    assert all(0 <= v < 1 << 32 for v in buf)
    lift = behz_cuda._pack_lift(ctx, keys[2].groups)
    assert len(lift) == L + len(keys[2].groups) * (4 + 2 * L)
