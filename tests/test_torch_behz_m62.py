"""The port's seal-profile (m62) multiply, relinearization and mod switch
against the reference, bit for bit (tolerance 0: exact integer arithmetic).

On the m62 chain of ``test_torch_bfv._seal_pair`` (36-, 36- and 37-bit
primes, N = 256, t = 65537, batch 2), against ``pplp_tpu.bfv.behz``:

* the B_sk primes and every constant of ``RnsMultiplier``;
* each BEHZ step: ``_to_bsk``, the tensor products over Q and B_sk,
  ``_fast_floor`` and ``_sk_to_q``;
* multiply, relinearize and multiply + relinearize at gadget widths 1 and 2
  through ``RnsMultiplier``, ``FusedMultiplier`` and ``Evaluator``, with the
  reference's relinearization keys carried across as (lo, hi) pairs;
* ``lift_digit_grouped`` at both widths, ``mod_switch_to_next``, and
  ``default_relin_width`` on the seal chains n = 4096..32768;
* ``Evaluator.negate``, ``add_many`` and ``sub_plain`` on both profiles.

The reference runs eagerly (each op compiles once): its whole multiply is
built in one module fixture, step by step, as ``RnsMultiplier.multiply``
runs it.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import behz as rbehz
from pplp_tpu.bfv.evaluator import mod_switch_to_next as rmod_switch
from pplp_tpu.ops import ntt as rntt
from pplp_tpu.ops.primes import get_primes
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.bfv import keys as pkeys
from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
from pplp_tpu_torch.bfv.evaluator import mod_switch_to_next, restrict_secret_key
from pplp_tpu_torch.ops import behz64_cuda, ntt
from pplp_tpu_torch.ops import primes as pprimes
from pplp_tpu_torch.ops.modmath import m62

N = 256
T = 65537
BATCH = 2
CHAIN = list(get_primes(36, 2, N)) + list(get_primes(37, 1, N))
_M32 = 0xFFFFFFFF


def _unpair(p) -> np.ndarray:
    lo, hi = (np.asarray(a).astype(np.uint64) for a in p)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def _pair(a: np.ndarray):
    a = np.asarray(a, dtype=np.int64)
    return jnp.asarray((a & _M32).astype(np.uint32)), jnp.asarray((a >> 32).astype(np.uint32))


def _pairs(leaf):
    return tuple(np.asarray(a) for a in leaf)


def _equal(ct, want):
    return len(ct.polys) == len(want) and all(
        (p.numpy() == w).all() for p, w in zip(ct.polys, want))


@pytest.fixture(scope="module")
def ref():
    """Both packages' contexts and multipliers, random canonical inputs, and
    the reference's multiply step by step, relinearization at both widths
    and mod switch."""
    jctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=CHAIN), "cpu")
    rmul, mul = rbehz.RnsMultiplier(jctx), behz.RnsMultiplier(ctx)
    rng = np.random.default_rng(62)
    qs = np.asarray(CHAIN, np.int64)[:, None]
    polys = [rng.integers(0, 1 << 62, size=(BATCH, len(CHAIN), N)) % qs for _ in range(4)]
    polys[0][0, :, :3] = qs - 1  # the largest canonical residues
    polys[3][1, :, :2] = 0

    # RnsMultiplier.multiply, step by step (its own per-polynomial shapes).
    tq, tb = rmul.base_q.tables, rmul.base_bsk.tables
    jx = [_pair(p) for p in polys]
    xb = [rmul._to_bsk(x) for x in jx]
    spec = {0: [rntt.forward(x, tq) for x in jx], 1: [rntt.forward(x, tb) for x in xb]}
    es = []
    for basis_i, (basis, tbx) in enumerate(((rmul.base_q, tq), (rmul.base_bsk, tb))):
        a0, a1, b0, b1 = spec[basis_i]
        e0 = rntt.pointwise_mul(a0, b0, tbx)
        e2 = rntt.pointwise_mul(a1, b1, tbx)
        cross = rntt.pointwise_mul(basis.add(a0, a1), basis.add(b0, b1), tbx)
        e1 = basis.sub(basis.sub(cross, e0), e2)
        es.append([rntt.inverse(e, tbx) for e in (e0, e1, e2)])
    floors = [rmul._fast_floor(es[0][j], es[1][j]) for j in range(3)]
    j3 = rbfv.Ciphertext(tuple(rmul._sk_to_q(w) for w in floors), "coeff")

    rsk, rlk1 = rbehz.make_keys_jit(jctx, 3)
    rlk2 = jax.jit(lambda k: rbehz.create_relin_keys(jctx, rsk, k, width=2))(jax.random.key(5))
    want = {"to_bsk": [_unpair(x) for x in xb],
            "e_q": [_unpair(e) for e in es[0]], "e_bsk": [_unpair(e) for e in es[1]],
            "floor": [_unpair(w) for w in floors],
            "multiply": [_unpair(p) for p in j3.polys]}
    keys = {}
    for width, rlk in ((1, rlk1), (2, rlk2)):
        want[width] = [_unpair(p) for p in rbehz.relinearize(jctx, j3, rlk).polys]
        keys[width] = behz.relin_keys_from_reference(
            ctx, *(_pairs(x) for x in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)), rlk.groups)
    rct = rbfv.Ciphertext((jx[0], jx[1]), "coeff")
    rsmall, rout = rmod_switch(jctx, rct)
    want["mod_switch"] = ([m.value for m in rsmall.moduli], [_unpair(p) for p in rout.polys])
    pct = lambda a, b: bfv.Ciphertext((torch.from_numpy(a), torch.from_numpy(b)))  # noqa: E731
    return SimpleNamespace(jctx=jctx, ctx=ctx, rmul=rmul, mul=mul, polys=polys,
                           ct1=pct(*polys[:2]), ct2=pct(*polys[2:]), keys=keys, want=want,
                           jx=jx, rsk=rsk)


def test_bsk_primes_and_constants_equal_the_reference(ref):
    mul, rmul = ref.mul, ref.rmul
    assert ref.ctx.tables.profile == "m62" and mul.bsk_tables.profile == "m62"
    assert [m.value for m in mul.bsk_moduli] == [m.value for m in rmul.base_bsk.moduli]
    assert all(m.value.bit_length() == 60 for m in mul.bsk_moduli)
    assert (mul.l, mul.msk, mul.M) == (rmul.l, rmul.msk, rmul.M)
    for name in ("mtilde_qhat_inv_ints", "conv_q_to_mtilde_ints", "inv_mtilde_bsk_ints",
                 "t_mod_q_ints", "t_mod_bsk_ints", "inv_q_bsk_ints", "qhat_inv_ints",
                 "M_mod_q_ints", "q_mod_bsk_ints", "bhat_inv_b", "conv_q_to_bsk",
                 "conv_b_to_q", "conv_b_to_msk", "mskM_mod_q_ints"):
        assert getattr(mul, name) == [list(r) if isinstance(r, (list, tuple)) else r
                                      for r in getattr(rmul, name)], name
    assert (mul.neg_inv_q_mtilde, mul.inv_M_msk_int, mul.msk_half) == (
        rmul.neg_inv_q_mtilde, rmul.inv_M_msk_int, rmul.msk_half)
    # 64-bit Shoup companions, as int64 bit patterns, equal the reference's pairs.
    for mine, theirs in ((mul.t_mod_bsk, rmul.t_mod_bsk), (mul.inv_q_bsk, rmul.inv_q_bsk),
                         (mul.qhat_inv, rmul.qhat_inv), (mul.M_mod_q, rmul.M_mod_q)):
        for a, b in zip(mine, theirs):
            assert (a.numpy() == _unpair(b)).all()
    # One 128-bit sum holds every base conversion of this chain.
    for conv in (mul.conv_q_to_bsk_t, mul.conv_b_to_q_t, mul.conv_b_to_msk_t):
        assert conv.terms >= conv.table.shape[0]


def test_to_bsk_matches_reference(ref):
    x = torch.stack([torch.from_numpy(p) for p in ref.polys])
    got = ref.mul._to_bsk(x)
    assert all((g.numpy() == w).all() for g, w in zip(got, ref.want["to_bsk"]))


def test_tensor_products_match_reference(ref):
    x = torch.stack([torch.from_numpy(p) for p in ref.polys])
    xb = torch.stack([torch.from_numpy(w) for w in ref.want["to_bsk"]])
    e_q, e_bsk = ref.mul.tensor_products(x, xb)
    assert all((g.numpy() == w).all() for g, w in zip(e_q, ref.want["e_q"]))
    assert all((g.numpy() == w).all() for g, w in zip(e_bsk, ref.want["e_bsk"]))


def test_fast_floor_and_sk_to_q_match_reference(ref):
    e_q = torch.stack([torch.from_numpy(e) for e in ref.want["e_q"]])
    e_bsk = torch.stack([torch.from_numpy(e) for e in ref.want["e_bsk"]])
    w = ref.mul._fast_floor(e_q, e_bsk)
    assert all((g.numpy() == f).all() for g, f in zip(w, ref.want["floor"]))
    out = ref.mul._sk_to_q(torch.stack([torch.from_numpy(f) for f in ref.want["floor"]]))
    assert all((g.numpy() == m).all() for g, m in zip(out, ref.want["multiply"]))


def test_keys_carried_over_as_pairs(ref):
    ctx, keys = ref.ctx, ref.keys
    assert keys[1].groups == ((0,), (1,), (2,))
    assert keys[2].groups == ((0, 1), (2,))
    assert behz.default_relin_width(ctx) == 1
    for k in keys.values():
        assert bool((k.k0_shoup < 0).any())  # companions above 2^63, as bit patterns
        assert torch.equal(k.k0_shoup, pkeys.shoup(ctx, k.k0))
        assert torch.equal(k.k1_shoup, pkeys.shoup(ctx, k.k1))


@pytest.mark.parametrize("via", ["rns", "fused", "evaluator"])
def test_multiply_matches_reference(ref, via):
    ctx, ct1, ct2 = ref.ctx, ref.ct1, ref.ct2
    if via == "rns":
        got = behz.RnsMultiplier(ctx).multiply(ct1, ct2)
    elif via == "fused":
        got = FusedMultiplier(ctx).multiply(ct1, ct2)
    else:
        got = bfv.Evaluator(ctx).multiply(ct1, ct2)
    assert _equal(got, ref.want["multiply"])


@pytest.mark.parametrize("width", [1, 2])
def test_relinearize_matches_reference(ref, width):
    ctx, key = ref.ctx, ref.keys[width]
    ct3 = bfv.Ciphertext(tuple(torch.from_numpy(p) for p in ref.want["multiply"]))
    assert _equal(behz.relinearize(ctx, ct3, key), ref.want[width])
    assert _equal(bfv.Evaluator(ctx).relinearize(ct3, key), ref.want[width])
    assert _equal(FusedMultiplier(ctx, key).relinearize(ct3), ref.want[width])


@pytest.mark.parametrize("width", [1, 2])
def test_multiply_relinearize_matches_reference(ref, width):
    ctx, key = ref.ctx, ref.keys[width]
    before = behz64_cuda.launches
    assert _equal(FusedMultiplier(ctx, key).multiply_relinearize(ref.ct1, ref.ct2),
                  ref.want[width])
    assert _equal(bfv.Evaluator(ctx).multiply_relinearize(ref.ct1, ref.ct2, key),
                  ref.want[width])
    assert behz64_cuda.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("width", [1, 2])
def test_lift_digit_grouped_matches_reference(ref, width):
    poly = ref.ct1.polys[0]
    for g in behz._digit_groups(ref.ctx.L, width):
        want = _unpair(rbehz.lift_digit_grouped(ref.jctx, _pair(poly.numpy()), g))
        assert (behz.lift_digit_grouped(ref.ctx, poly, g).numpy() == want).all()


def test_key_products_reduce_after_every_term(ref):
    """D = 3 digit products of residues near 2^37 each: the sum is taken
    mod q term by term (a plain int64 sum of m62 products would wrap)."""
    ctx, key = ref.ctx, ref.keys[1]
    d = torch.stack([ctx.q2.expand(BATCH, ctx.L, N) - 1] * 3)
    got = behz.key_products(ctx, d, key)
    p = ctx.prof
    for i, (k, ks) in enumerate(((key.k0, key.k0_shoup), (key.k1, key.k1_shoup))):
        terms = [p.mulmod_shoup(d[j], k[j], ks[j], ctx.q2) for j in range(3)]
        want = p.add(p.add(terms[0], terms[1], ctx.q2), terms[2], ctx.q2)
        assert torch.equal(got[i], want)


def test_mod_switch_matches_reference(ref):
    small, out = mod_switch_to_next(ref.ctx, ref.ct1)
    moduli, want = ref.want["mod_switch"]
    assert [m.value for m in small.moduli] == moduli
    assert small.tables.profile == "m62"
    assert _equal(out, want)


def test_mod_switch_decrypts_with_the_restricted_key(ref):
    ctx = ref.ctx
    g = torch.Generator().manual_seed(11)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    values = list(range(1, 50))
    ct = bfv.Encryptor(ctx, pk).encrypt(bfv.Plaintext(values), g)
    small, out = mod_switch_to_next(ctx, ct)
    ssk = restrict_secret_key(small, sk)
    assert torch.equal(ssk.s_shoup, small.prof.shoup_precompute(ssk.s_ntt, small.q2))
    assert bfv.Decryptor(small, ssk).decrypt(out).coeffs[:len(values)] == values


def test_plain_m62_version_is_plain_ntt_independent(ref, monkeypatch):
    """The plain version transforms with forward_plain/inverse_plain only,
    never through the dispatch that sends a CUDA tensor to the u64 kernel."""

    def refuse(*args, **kwargs):
        raise AssertionError("the plain BEHZ version called the dispatching NTT")

    monkeypatch.setattr(ntt, "forward", refuse)
    monkeypatch.setattr(ntt, "inverse", refuse)
    ct3 = behz.RnsMultiplier(ref.ctx).multiply(ref.ct1, ref.ct2)
    assert _equal(ct3, ref.want["multiply"])
    assert _equal(behz.relinearize(ref.ctx, ct3, ref.keys[2]), ref.want[2])


def test_real_product_decrypts_on_cpu_at_both_widths(ref):
    ctx = ref.ctx
    g = torch.Generator().manual_seed(8)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, T, size=N) for _ in range(2))
    full = np.concatenate([np.convolve(a, b), [0]])
    want = [int(v) % T for v in full[:N] - full[N:]]
    enc, ev, dec = bfv.Encryptor(ctx, pk), bfv.Evaluator(ctx), bfv.Decryptor(ctx, sk)
    ca, cb = enc.encrypt(bfv.Plaintext(a.tolist()), g), enc.encrypt(bfv.Plaintext(b.tolist()), g)
    for width in (1, 2):
        rlk = behz.create_relin_keys(ctx, sk, g, width=width)
        assert dec.decrypt(ev.multiply_relinearize(ca, cb, rlk)).coeffs[:N] == want
    assert dec.decrypt(ev.multiply(ca, cb)).coeffs[:N] == want  # size 3, with s^2


@pytest.mark.parametrize("n", [4096, 8192, 16384, 32768])
@pytest.mark.parametrize("t_bits", [16, 56])
def test_default_relin_width_on_the_seal_chains(n, t_bits):
    """Width 1 on seal n = 4096 at t = 2^16 (a 73-bit digit would put the
    noise over the budget), width 2 from n = 8192 at t = 2^56; both packages
    agree (the rule reads q, t, L, n and the moduli only)."""
    chain = pprimes.bfv_default(n)
    q = 1
    for p in chain:
        q *= p
    view = SimpleNamespace(q=q, t=1 << t_bits, L=len(chain), n=n,
                           moduli=tuple(pprimes.Modulus(p) for p in chain))
    width = behz.default_relin_width(view)
    assert width == rbehz.default_relin_width(view)
    if (n, t_bits) == (4096, 16):
        assert width == 1
    if n >= 8192:
        assert width == 2


def test_u64_wrappers_refuse_cpu_tensors(ref):
    ctx, ct1, ct2, mul = ref.ctx, ref.ct1, ref.ct2, ref.mul
    c0, c1 = ct1.polys
    d0, d1 = ct2.polys
    x = torch.stack([c0, c1, d0, d1])
    xb = mul._to_bsk(x)
    calls = [lambda: behz64_cuda.multiply(c0, c1, d0, d1, mul),
             lambda: behz64_cuda.to_bsk(c0, c1, d0, d1, mul),
             lambda: behz64_cuda.tensor_spectra(x, xb, mul),
             lambda: behz64_cuda.floor_sk(x[:3], xb[:3], mul),
             lambda: behz64_cuda.relinearize(c0, c1, d0, ctx, ref.keys[2]),
             lambda: behz64_cuda.lift_digits(c0, ctx, ref.keys[2]),
             lambda: behz64_cuda.key_products(torch.stack([c0, c1]), ctx, ref.keys[2]),
             lambda: behz64_cuda.add_switched(c0, c1, x[:2], ctx)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert behz64_cuda.launches == 0


def test_u64_constant_buffer_layout(ref):
    """Each kernel's packed constants have exactly the length behz64.cu's
    layout reads (``Consts``, ``ToBsk::words``, ``FloorSk::words``), the two
    scalars are kept once (host side), and every value fits a u64."""
    ctx, mul = ref.ctx, ref.mul
    L, K = ctx.L, mul.K
    l = K - 1
    bufs, scalars = behz64_cuda._pack_constants(mul)
    assert {k: len(v) for k, v in bufs.items()} == {
        "tensor": 3 * L + 3 * K,
        "to_bsk": 4 * L + 3 * K + K * (L + 1),
        "floor_sk": 6 * L + 3 * K + l * (L + 1) + (K + L) + L * K}
    assert scalars == [mul.neg_inv_q_mtilde, mul.msk_half]
    buf = bufs["tensor"]
    assert buf[:L + K] == [m.value for m in (*ctx.moduli, *mul.bsk_moduli)]
    assert all(0 <= v < 1 << 64 for part in bufs.values() for v in part + scalars)
    lo, hi = buf[L + K : L + K + 2]  # floor(2^128 / q_0)
    assert lo + (hi << 64) == (1 << 128) // CHAIN[0]
    for width in (1, 2):
        lift = behz64_cuda._pack_lift(ctx, ref.keys[width].groups)
        assert len(lift) == 3 * L + len(ref.keys[width].groups) * (4 + 2 * L)
        assert all(0 <= v < 1 << 64 for v in lift)


# ---------------------------------------------------------------------------
# Evaluator.negate, add_many and sub_plain on both profiles
# ---------------------------------------------------------------------------


def _profile_pair(profile):
    chain = CHAIN if profile == "seal" else list(get_primes(28, 2, N)) + list(get_primes(27, 1, N))
    jctx = rbfv.BFVContext.build(rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain))
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=chain), "cpu")
    return jctx, ctx


def _to_ref(a, profile):
    return _pair(a) if profile == "seal" else jnp.asarray(np.asarray(a).astype(np.uint32))


def _from_ref(a):
    return _unpair(a) if isinstance(a, tuple) else np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("profile", ["tpu", "seal"])
def test_negate_add_many_sub_plain_match_reference(profile):
    jctx, ctx = _profile_pair(profile)
    rng = np.random.default_rng(5)
    qs = np.asarray([m.value for m in ctx.moduli], np.int64)[:, None]
    arrays = [[rng.integers(0, 1 << 62, size=(ctx.L, N)) % qs for _ in range(2)]
              for _ in range(5)]
    arrays[0][0][:, :4] = 0  # negate keeps zero
    cts = [bfv.Ciphertext(tuple(torch.from_numpy(a) for a in pair)) for pair in arrays]
    rcts = [rbfv.Ciphertext(tuple(_to_ref(a, profile) for a in pair), "coeff")
            for pair in arrays]
    ev, rev = bfv.Evaluator(ctx), rbfv.Evaluator(jctx)
    plain = bfv.Plaintext(rng.integers(0, T, size=N).tolist())
    rplain = rbfv.Plaintext(plain.coeffs)
    for got, want in ((ev.negate(cts[0]), rev.negate(rcts[0])),
                      (ev.add_many(cts), rev.add_many(rcts)),
                      (ev.add_many(cts[:1]), rev.add_many(rcts[:1])),
                      (ev.sub_plain(cts[1], plain), rev.sub_plain(rcts[1], rplain))):
        assert _equal(got, [_from_ref(p) for p in want.polys])
    # sub_plain undoes add_plain; the negation adds to zero.
    assert _equal(ev.sub_plain(ev.add_plain(cts[2], plain), plain), arrays[2])
    zero = ev.add(cts[3], ev.negate(cts[3]))
    assert all(not p.any() for p in zero.polys)
    with pytest.raises(ValueError):
        ev.add_many([])


def test_m62_profile_arithmetic_is_bound_to_the_ratio(ref):
    """The m62 instances the multiplier uses carry their bases' ratio words:
    reduce_words of q_d itself is 0 in every limb of B_sk and m_sk."""
    mul = ref.mul
    assert isinstance(mul.bsk_prof, m62) and isinstance(mul.msk_prof, m62)
    zero = mul.bsk_prof.reduce_words((mul.bsk_col & _M32, mul.bsk_col >> 32), mul.bsk_col)
    assert not zero.any()
    assert not mul.msk_prof.reduce_words((mul.msk_col & _M32, mul.msk_col >> 32),
                                         mul.msk_col).any()
