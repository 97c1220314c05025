"""The port on a CUDA card: the hand-written kernels against their plain
versions (the u32 NTT in both I/O widths, the u64 NTT,
the BEHZ multiply + relinearization on the fused and the separate routes,
the seal (m62) multiply on the u64 route and its steps, the u64 NTT on the
60-bit B_sk tables, the mulmod chain), the seal real product and mod
switch, the demo on both profiles and the packed pipeline.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither jax nor the JAX package, so it also runs where jax is not
installed; on the card run it without the suite's conftest (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are bit-exact (tolerance 0): all arithmetic is exact integer
arithmetic.
"""

import numpy as np
import pytest
import torch

from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz, behz_fused
from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
from pplp_tpu_torch.ops import behz64_cuda, behz_cuda, mulmod_chain, ntt, ntt_cuda
from pplp_tpu_torch.ops.modmath import m31
from pplp_tpu_torch.ops.primes import Modulus, bfv_default, get_primes, tpu_default

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(n, dev):
    chain = tpu_default(n) if n >= 1024 else [*get_primes(28, 1, n), *get_primes(27, 1, n)]
    return ntt.build_tables([Modulus(q) for q in chain], n, dev)


def _residues(tb, batch, seed):
    g = torch.Generator(device=tb.device).manual_seed(seed)
    x = torch.randint(0, 1 << 62, batch + (tb.L, tb.n), generator=g,
                      device=tb.device, dtype=torch.int64)
    return x % tb.q_b(1)


@pytest.mark.parametrize("n,batch", [(64, (5,)), (256, (3, 2)), (4096, (3,)),
                                     (8192, (6,)), (16384, (1,)), (32768, ())])
def test_kernel_matches_plain(dev, n, batch):
    tb = _tables(n, dev)
    x = _residues(tb, batch, n)
    before = dict(ntt_cuda.launches_by_kernel)
    spec = ntt.forward(x, tb)
    back = ntt.inverse(spec, tb)
    torch.cuda.synchronize()
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)
    assert ntt_cuda.launches_by_kernel["ntt_forward"] == before["ntt_forward"] + 1
    assert ntt_cuda.launches_by_kernel["ntt_inverse"] == before["ntt_inverse"] + 1


# The seal chains (n, L): 4096/3, 8192/5, 16384/9 and 32768/16, each row over
# a cluster of 2, 2, 2 and 4 blocks. The last case puts primes just below
# 2^62 and 2^61 on the cluster of four, where the lazy forward values reach
# 4q ~ 2^64.
U64_CASES = [(4096, None), (8192, None), (16384, None), (32768, None),
             (32768, (62, 61))]
U64_ONLY = {"ntt_forward": 0, "ntt_inverse": 0, "ntt_forward_u32": 0, "ntt_inverse_u32": 0,
            "ntt_forward_u64": 1, "ntt_inverse_u64": 1}


def _tables62(n, dev, bits=None):
    """The seal chain where there is one (n >= 4096), else 36-, 44- and
    61-bit primes; or one prime of each of ``bits``."""
    if bits is None and n >= 4096:
        chain = bfv_default(n)
    else:
        chain = [get_primes(b, 1, n)[0] for b in bits or (36, 44, 61)]
    tb = ntt.build_tables([Modulus(q) for q in chain], n, dev)
    assert tb.profile == "m62"
    return tb


def _u64_round_trip(x, tb):
    """forward and inverse on the card against the plain transforms; the
    launches they counted."""
    before = dict(ntt_cuda.launches_by_kernel)
    spec = ntt.forward(x, tb)
    back = ntt.inverse(spec, tb)
    torch.cuda.synchronize()
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)
    after = ntt_cuda.launches_by_kernel
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("n,bits", U64_CASES)
def test_u64_kernel_matches_plain(dev, n, bits):
    tb = _tables62(n, dev, bits)
    x = _residues(tb, (2,), n)
    x[0, :, :4] = tb.q_b(1) - 1
    assert _u64_round_trip(x, tb) == U64_ONLY  # one launch per transform at every n


@pytest.mark.parametrize("batch", [1, 5, 15, 30, 64])
@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768])
def test_u64_kernel_rows_per_limb(dev, n, batch):
    """1 .. 64 rows per limb at every n: several rows of a limb per block
    with a tail block (n <= 1024), one row per block (2048), one row per
    cluster of blocks (from 4096 on)."""
    tb = _tables62(n, dev)
    assert _u64_round_trip(_residues(tb, (batch,), n + batch), tb) == U64_ONLY


@pytest.mark.parametrize("n", [64, 1024, 4096, 8192, 16384, 32768])
def test_u64_extreme_inputs(dev, n):
    """All q - 1 drives the lazy butterflies to their bounds; all 0."""
    tb = _tables62(n, dev)
    x = _residues(tb, (3,), n)
    x[0] = tb.q_b(1) - 1
    x[1] = 0
    _u64_round_trip(x, tb)


def test_u64_wrapper_refuses_what_the_kernel_does_not_take(dev):
    tb = _tables62(4096, dev)
    x = _residues(tb, (4,), 1)
    before = ntt_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ntt_cuda.forward(x.cpu(), tb)
    with pytest.raises(ValueError, match="tables on"):
        ntt_cuda.inverse(x, ntt.build_tables(tb.moduli, tb.n, "cpu"))
    with pytest.raises(TypeError):
        ntt_cuda.forward(x.to(torch.int32), tb)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.forward(x[::2], tb)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.inverse(torch.stack([x, x], dim=-1)[..., 0], tb)
    with pytest.raises(ValueError):
        ntt_cuda.forward(x[..., :2048].contiguous(), tb)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_cuda.forward(x.reshape(-1)[1:1 + tb.L * tb.n].view(1, tb.L, tb.n), tb)
    empty = torch.empty((0, tb.L, tb.n), dtype=torch.int64, device=dev)
    assert ntt_cuda.inverse(empty, tb).shape == empty.shape
    assert ntt_cuda.launches == before


@pytest.mark.parametrize("n", [64, 4096, 8192, 32768])
def test_largest_canonical_inputs(dev, n):
    """q - 1 in every slot drives the lazy butterflies to their bounds."""
    tb = _tables(n, dev)
    x = (tb.q_b(1) - 1).expand(2, tb.L, tb.n).contiguous()
    spec = ntt.forward_plain(x, tb)
    assert torch.equal(ntt.forward(x, tb), spec)
    assert torch.equal(ntt.inverse(spec, tb), ntt.inverse_plain(spec, tb))


def _as_u32(x):
    return x.to(torch.int32) if x.dtype == torch.int64 else x


def _as_i64(x):
    return x.to(torch.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("n", [64, 4096, 8192, 32768])
def test_u32_io_kernels_match_plain(dev, n):
    """forward_u32 from int64 and from u32 rows, inverse_u32, and the int64
    kernels, with q - 1 in the first slots."""
    tb = _tables(n, dev)
    x = _residues(tb, (3,), n)
    x[0, :, :5] = tb.q_b(1) - 1
    spec = ntt.forward_plain(x, tb)
    before = dict(ntt_cuda.launches_by_kernel)
    f64 = ntt_cuda.forward_u32(x, tb)
    f32 = ntt_cuda.forward_u32(_as_u32(x), tb)
    back = ntt_cuda.inverse_u32(_as_u32(spec), tb)
    torch.cuda.synchronize()
    assert f64.dtype == f32.dtype == back.dtype == torch.int32
    assert torch.equal(_as_i64(f64), spec)
    assert torch.equal(_as_i64(f32), spec)
    assert torch.equal(_as_i64(back), ntt.inverse_plain(spec, tb))
    assert torch.equal(_as_i64(back), x)
    assert torch.equal(ntt_cuda.forward(x, tb), spec)
    assert torch.equal(ntt_cuda.inverse(spec, tb), x)
    after = ntt_cuda.launches_by_kernel
    assert {k: after[k] - before[k] for k in after} == {
        "ntt_forward": 1, "ntt_inverse": 1, "ntt_forward_u32": 2, "ntt_inverse_u32": 1,
        "ntt_forward_u64": 0, "ntt_inverse_u64": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    tb = _tables(4096, dev)
    x = _residues(tb, (4,), 1)
    with pytest.raises(TypeError):
        ntt_cuda.forward(x.to(torch.int32), tb)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.forward(x[::2], tb)
    with pytest.raises(ValueError):
        ntt_cuda.forward(x[..., :2048].contiguous(), tb)
    with pytest.raises(ValueError, match="16-byte"):
        ntt_cuda.forward(x.reshape(-1)[1:1 + tb.L * tb.n].view(1, tb.L, tb.n), tb)
    with pytest.raises(TypeError):
        ntt_cuda.inverse_u32(x, tb)
    empty = torch.empty((0, tb.L, tb.n), dtype=torch.int64, device=dev)
    before = ntt_cuda.launches
    assert ntt_cuda.forward(empty, tb).shape == empty.shape
    assert ntt_cuda.launches == before


def test_demo_on_card(dev):
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(xa=1234, ya=1212, xb=1000, yb=1000, radius=320,
                         poly_modulus_degree_bits=12, plain_modulus_bits=40,
                         profile="tpu", seed=1234, false_positive_probability=1e-6)
    ntt_cuda.reset_launches()
    res = run_local_demo(cfg, verbose=False, device=dev)
    assert ntt_cuda.launches > 0
    assert res.is_near is True
    bl = Blinding.for_protocol(cfg.plain_modulus_bits, cfg.sq_radius, cfg.seed)
    assert res.blind_distance == bl.s * (99_700 + bl.r) % cfg.plain_modulus
    assert res.bf_device.type == "cuda"


def test_seal_demo_on_card(dev):
    """The demo on its default profile (seal, m62) goes through the u64
    kernel and only it."""
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(xa=1234, ya=1212, xb=1000, yb=1000, radius=320,
                         poly_modulus_degree_bits=12, plain_modulus_bits=40,
                         seed=1234, false_positive_probability=1e-6)
    assert cfg.profile == "seal"
    ntt_cuda.reset_launches()
    res = run_local_demo(cfg, verbose=False, device=dev)
    counts = dict(ntt_cuda.launches_by_kernel)
    assert counts["ntt_forward_u64"] > 0 and counts["ntt_inverse_u64"] > 0
    assert counts["ntt_forward"] == counts["ntt_inverse"] == 0
    assert res.is_near is True
    bl = Blinding.for_protocol(cfg.plain_modulus_bits, cfg.sq_radius, cfg.seed)
    assert res.blind_distance == bl.s * (99_700 + bl.r) % cfg.plain_modulus
    assert res.bf_device.type == "cuda"


def test_packed_pipeline_on_card(dev):
    """BASELINE config[3] at n = 4096 with a few rows: every check equals
    the oracle (clear blind distance -> key -> probe) and the decode equals
    the host CRT decode."""
    from pplp_tpu_torch.bfv.rns_decrypt import get_decoder
    from pplp_tpu_torch.parallel import pipeline

    t, s_blind, r_blind, w, xb, yb, rows = 1 << 20, 501, 99, 0xA5A5, 1000, 900, 3
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, t, profile="tpu"), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    bf = pipeline.build_pipeline_filter(t, s_blind, r_blind, w, dev)
    rng = np.random.default_rng(1)
    total = rows * ctx.n
    xa = np.where(rng.random(total) < 0.5, xb + rng.integers(-60, 60, total),
                  rng.integers(0, 4000, total)).astype(np.uint64)
    ya = np.where(rng.random(total) < 0.5, yb + rng.integers(-60, 60, total),
                  rng.integers(0, 4000, total)).astype(np.uint64)
    cts = pipeline.make_packed_inputs(ctx, bfv.Encryptor(ctx, pk), xa, ya, g)
    fn = pipeline.build_packed_pipeline_bf(ctx, sk, xb, yb, s_blind, r_blind, w,
                                           w.bit_length())
    ntt_cuda.reset_launches()
    got = fn(*cts, bf.bits_device, bf._salts_device(), bf.table_size)
    torch.cuda.synchronize()
    assert ntt_cuda.launches_by_kernel["ntt_forward"] == 1
    assert ntt_cuda.launches_by_kernel["ntt_inverse"] == 1
    d2 = (xa.astype(np.int64) - xb) ** 2 + (ya.astype(np.int64) - yb) ** 2
    bd_clear = (s_blind * (d2 + r_blind)) % t
    keys = (bd_clear.astype(np.uint64) << np.uint64(w.bit_length())) | np.uint64(w)
    want = np.array([bf.contains_u64(int(k)) for k in keys])  # the host scalar probe
    flat = got.reshape(-1).cpu().numpy()
    assert (flat == want).all()
    assert flat[d2 < r_blind**2].all()
    bd = torch.as_tensor(bd_clear, device=dev)
    x = pipeline.build_batched_pipeline(ctx, sk, xb, yb, s_blind, r_blind, packed=True)(*cts)
    dec = get_decoder(ctx).decode_mod_t(x)
    assert torch.equal(dec.reshape(-1), bd)
    for r in range(2):
        assert ctx.decode_plain_from_ct_value(x[r].cpu().numpy()) == dec[r].tolist()


# ---------------------------------------------------------------------------
# The BEHZ multiply + relinearization (csrc/behz.cu)
# ---------------------------------------------------------------------------

KAT_CHAIN = (268432897, 268428161, 134217089)  # tests/fixtures/bfv_kat_n64_m31.json.gz


def _bfv_ctx(n, dev):
    chain = KAT_CHAIN if n == 64 else tpu_default(n)
    parms = bfv.EncryptionParameters.bfv(n, 1 << 16, coeff_modulus=chain)
    return bfv.BFVContext.build(parms, dev)


def _cts(ctx, batch, seed):
    tb = ctx.tables
    polys = [_residues(tb, batch, seed + i) for i in range(4)]
    polys[0][..., :2] = tb.q_b(1) - 1
    return bfv.Ciphertext(tuple(polys[:2])), bfv.Ciphertext(tuple(polys[2:]))


def _same(a, b):
    return a.size == b.size and all(torch.equal(x, y) for x, y in zip(a.polys, b.polys))


def _behz_launches(n, relin_only=False):
    """The BEHZ launches of one multiply (or one relinearization) at n."""
    want = dict.fromkeys(behz_cuda.launches_by_kernel, 0)
    if not relin_only:
        want["behz_to_bsk"] = want["behz_floor_sk"] = 1
        if n <= behz_cuda.FUSED_TENSOR_MAX_N:
            want["behz_tensor_ntt"] = 1
        else:
            want["behz_tensor"] = 2
        return want
    if n <= behz_cuda.FUSED_RELIN_MAX_N:
        want["behz_relin_ntt"] = 1
    else:
        want["behz_lift"] = want["behz_keyprod"] = want["behz_add"] = 1
    return want


@pytest.mark.parametrize("batch", [(1,), (3,)])
@pytest.mark.parametrize("n", [64, 4096, 8192, 16384, 32768])
def test_behz_kernel_matches_plain(dev, n, batch):
    """n <= 8192: both fused kernels; 16384: the separate tensor route and
    the fused relinearization; 32768: both separate."""
    ctx = _bfv_ctx(n, dev)
    g = torch.Generator(device=dev).manual_seed(n)
    sk, _ = behz.make_keys(ctx, g)
    rlk1, rlk2 = (behz.create_relin_keys(ctx, sk, g, width=w) for w in (1, 2))
    assert rlk1.groups != rlk2.groups
    ct1, ct2 = _cts(ctx, batch, n)
    mul = behz.multiplier(ctx)
    plain3 = mul.multiply(ct1, ct2)
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    got3 = FusedMultiplier(ctx).multiply(ct1, ct2)
    torch.cuda.synchronize()
    assert _same(got3, plain3)
    assert behz_cuda.launches_by_kernel == _behz_launches(n)
    fused_t = n <= behz_cuda.FUSED_TENSOR_MAX_N
    assert ntt_cuda.launches_by_kernel["ntt_forward_u32"] == (0 if fused_t else 5)
    xb = behz_cuda.to_bsk(*ct1.polys, *ct2.polys, mul)
    eq, eb = behz_cuda.tensor_products(*ct1.polys, *ct2.polys, xb, mul)
    assert xb.dtype == eq.dtype == eb.dtype == torch.int32  # u32 intermediates
    for rlk in (rlk1, rlk2):
        want = behz.relinearize(ctx, plain3, rlk)
        fused = FusedMultiplier(ctx, rlk)
        assert _same(fused.multiply_relinearize(ct1, ct2), want)
        behz_cuda.reset_launches()
        assert _same(fused.relinearize(plain3), want)  # the relinearization alone
        assert behz_cuda.launches_by_kernel == _behz_launches(n, relin_only=True)


def test_separate_steps_match_plain(dev):
    """The steps of the separate route, each on the same inputs as its plain
    step: tensor_spectra (Q and B_sk), lift_digits, key_products and
    add_switched, at n = 64, width 2, batch 3."""
    ctx = _bfv_ctx(64, dev)
    mul = behz.multiplier(ctx)
    g = torch.Generator(device=dev).manual_seed(6)
    sk, _ = behz.make_keys(ctx, g)
    rlk = behz.create_relin_keys(ctx, sk, g, width=2)
    ct1, ct2 = _cts(ctx, (3,), 6)
    x = torch.stack([*ct1.polys, *ct2.polys])
    for src, tbx in ((x, ctx.tables), (mul._to_bsk(x), mul.bsk_tables)):
        spec = ntt.forward_plain(src, tbx)
        got = behz_cuda.tensor_spectra(_as_u32(spec), tbx)
        assert torch.equal(_as_i64(got), mul.tensor_spectra(spec, tbx))
    c0, c1, c2 = mul.multiply(ct1, ct2).polys
    groups = rlk.digit_groups(ctx.L)
    lifted = torch.stack([behz.lift_digit_grouped(ctx, c2, gr) for gr in groups])
    assert torch.equal(_as_i64(behz_cuda.lift_digits(c2, ctx, rlk)), lifted)
    d_ntt = ntt.forward_plain(lifted, ctx.tables)
    acc = behz.key_products(ctx, d_ntt, rlk)
    assert torch.equal(_as_i64(behz_cuda.key_products(_as_u32(d_ntt), ctx, rlk)), acc)
    d = ntt.inverse_plain(acc, ctx.tables)
    want = torch.stack([m31.add(c, dj, ctx.q2) for c, dj in zip((c0, c1), d)])
    assert torch.equal(behz_cuda.add_switched(c0, c1, _as_u32(d), ctx), want)


def test_behz_at_the_limb_bound(dev):
    """L = 40 (the kernels' bound) at n = 64, width 1: the relinearization
    loops over 40 digits."""
    chain = get_primes(28, behz_cuda.MAX_L, 64)
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(64, 1 << 16, coeff_modulus=chain),
                               dev)
    g = torch.Generator(device=dev).manual_seed(40)
    sk, _ = behz.make_keys(ctx, g)
    rlk = behz.create_relin_keys(ctx, sk, g, width=1)
    assert len(rlk.digit_groups(ctx.L)) == 40
    ct1, ct2 = _cts(ctx, (2,), 40)
    want = behz.relinearize(ctx, behz.multiplier(ctx).multiply(ct1, ct2), rlk)
    assert _same(FusedMultiplier(ctx, rlk).multiply_relinearize(ct1, ct2), want)


def test_evaluator_on_card_runs_the_kernels_only(dev, monkeypatch):
    ctx = _bfv_ctx(4096, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    _, rlk = behz.make_keys(ctx, g)
    ct1, ct2 = _cts(ctx, (2,), 5)
    mul = behz.multiplier(ctx)
    want3 = mul.multiply(ct1, ct2)
    want = behz.relinearize(ctx, want3, rlk)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for owner, name in ((behz.RnsMultiplier, "multiply"), (behz, "relinearize"),
                        (behz_fused, "relinearize"), (ntt, "forward_plain"),
                        (ntt, "inverse_plain")):
        monkeypatch.setattr(owner, name, refuse)
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    ev = bfv.Evaluator(ctx)
    assert _same(ev.multiply(ct1, ct2), want3)
    assert _same(ev.relinearize(want3, rlk), want)
    assert _same(ev.multiply_relinearize(ct1, ct2, rlk), want)
    assert behz_cuda.launches_by_kernel == {
        "behz_to_bsk": 2, "behz_tensor_ntt": 2, "behz_floor_sk": 2, "behz_relin_ntt": 2,
        "behz_tensor": 0, "behz_lift": 0, "behz_keyprod": 0, "behz_add": 0}
    assert ntt_cuda.launches == 0  # the transforms run inside the fused kernels
    # One multiply_relinearize: 4 launches, none of them a plain version.
    behz_cuda.reset_launches()
    assert _same(ev.multiply_relinearize(ct1, ct2, rlk), want)
    assert {k: v for k, v in behz_cuda.launches_by_kernel.items() if v} == {
        "behz_to_bsk": 1, "behz_tensor_ntt": 1, "behz_floor_sk": 1, "behz_relin_ntt": 1}
    assert ntt_cuda.launches == 0


def test_real_product_decrypts_on_card(dev):
    ctx = _bfv_ctx(4096, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rlk = behz.create_relin_keys(ctx, sk, g)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 1 << 16, size=ctx.n) for _ in range(2))
    enc, ev, dec = bfv.Encryptor(ctx, pk), bfv.Evaluator(ctx), bfv.Decryptor(ctx, sk)
    ca, cb = enc.encrypt(bfv.Plaintext(a.tolist()), g), enc.encrypt(bfv.Plaintext(b.tolist()), g)
    full = np.concatenate([np.convolve(a, b), [0]])
    want = [int(v) % (1 << 16) for v in full[: ctx.n] - full[ctx.n:]]
    assert dec.decrypt(ev.multiply_relinearize(ca, cb, rlk)).coeffs[: ctx.n] == want
    assert dec.decrypt(ev.multiply(ca, cb)).coeffs[: ctx.n] == want  # size 3


def test_behz_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ctx = _bfv_ctx(4096, dev)
    mul = behz.multiplier(ctx)
    g = torch.Generator(device=dev).manual_seed(2)
    _, rlk = behz.make_keys(ctx, g)
    ct1, ct2 = _cts(ctx, (2,), 9)
    c0, c1 = ct1.polys
    d0, d1 = ct2.polys
    before = behz_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        behz_cuda.multiply(c0.cpu(), c1, d0, d1, mul)
    with pytest.raises(TypeError):
        behz_cuda.multiply(c0.to(torch.int32), c1, d0, d1, mul)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.stack([c0, c0], dim=-1)[..., 0]
        behz_cuda.multiply(wide, c1, d0, d1, mul)
    with pytest.raises(ValueError):
        behz_cuda.multiply(c0[..., :2048].contiguous(), c1, d0, d1, mul)
    with pytest.raises(ValueError):
        behz_cuda.multiply(c0[:1], c1, d0, d1, mul)
    with pytest.raises(ValueError, match="relin keys"):
        bad = behz.KSwitchKeys(rlk.k0[:1], rlk.k0_shoup[:1], rlk.k1[:1], rlk.k1_shoup[:1],
                               groups=rlk.groups)
        behz_cuda.relinearize(c0, c1, d0, ctx, bad)
    assert behz_cuda.launches == before


# ---------------------------------------------------------------------------
# The seal (m62) multiply + relinearization: the u64 route (csrc/behz64.cu)
# ---------------------------------------------------------------------------


def _seal_ctx(n, t_bits, dev):
    return bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, 1 << t_bits, profile="seal"),
                                dev)


def _seal_setup(n, t_bits, batch, dev):
    """Context, multiplier, width-1 and width-2 keys and two ciphertexts."""
    ctx = _seal_ctx(n, t_bits, dev)
    g = torch.Generator(device=dev).manual_seed(n + t_bits)
    sk, _ = behz.make_keys(ctx, g)
    keys = {w: behz.create_relin_keys(ctx, sk, g, width=w) for w in (1, 2)}
    ct1, ct2 = _cts(ctx, batch, n + 1)
    return ctx, behz.multiplier(ctx), keys, ct1, ct2


_SEAL_LAUNCHES = {"behz64_to_bsk": 1, "behz64_tensor": 1, "behz64_floor_sk": 1,
                  "behz64_lift": 1, "behz64_keyprod": 1, "behz64_add": 1}


@pytest.mark.parametrize("n,t_bits", [(4096, 16), (8192, 56)])
def test_seal_steps_match_plain(dev, n, t_bits):
    """Each u64 kernel's wrapper step on the same inputs as its plain step,
    at both widths, batch 3."""
    ctx, mul, keys, ct1, ct2 = _seal_setup(n, t_bits, (3,), dev)
    tq, tb = ctx.tables, mul.bsk_tables
    x = torch.stack([*ct1.polys, *ct2.polys])
    xb = mul._to_bsk(x)
    assert torch.equal(behz64_cuda.to_bsk(*ct1.polys, *ct2.polys, mul), xb)
    sq, sb = ntt.forward_plain(x, tq), ntt.forward_plain(xb, tb)
    eq, eb = behz64_cuda.tensor_spectra(sq, sb, mul)
    assert torch.equal(eq, mul.tensor_spectra(sq, tq))
    assert torch.equal(eb, mul.tensor_spectra(sb, tb))
    eq, eb = ntt.inverse_plain(eq, tq), ntt.inverse_plain(eb, tb)
    assert torch.equal(behz64_cuda.floor_sk(eq, eb, mul), mul._sk_to_q(mul._fast_floor(eq, eb)))
    c0, c1, c2 = mul.multiply(ct1, ct2).polys
    for rlk in keys.values():
        lifted = torch.stack([behz.lift_digit_grouped(ctx, c2, g)
                              for g in rlk.digit_groups(ctx.L)])
        assert torch.equal(behz64_cuda.lift_digits(c2, ctx, rlk), lifted)
        dn = ntt.forward_plain(lifted, tq)
        acc = behz.key_products(ctx, dn, rlk)
        assert torch.equal(behz64_cuda.key_products(dn, ctx, rlk), acc)
        d = ntt.inverse_plain(acc, tq)
        want = torch.stack([ctx.prof.add(c, dj, ctx.q2) for c, dj in zip((c0, c1), d)])
        assert torch.equal(behz64_cuda.add_switched(c0, c1, d, ctx), want)


_CONVERSION_CASES = [
    # (n, chain, t bits, batch): the seal chains (|B_sk| = L + 2, constant
    # limb counts), rows shorter than one tile of 256 coefficients, and a
    # shape with run-time limb counts (L = 4, |B_sk| = 6).
    (4096, None, 16, (1,)), (4096, None, 16, (3,)), (8192, None, 56, (1,)),
    (8192, None, 56, (5,)), (16384, None, 56, (3,)), (32768, None, 56, (1,)),
    (32768, None, 56, (3,)), (64, "seal4096", 16, (3,)), (128, "seal4096", 16, (1,)),
    (256, "62x4", 16, (3,)), (64, "62x4", 16, (1,)),
]


@pytest.mark.parametrize("n,chain,t_bits,batch", _CONVERSION_CASES)
def test_seal_conversions_match_plain(dev, n, chain, t_bits, batch):
    """to_bsk and floor_sk against their plain steps on random canonical
    residues with the largest ones in every limb."""
    coeff = {None: None, "seal4096": bfv_default(4096), "62x4": get_primes(62, 4, n)}[chain]
    parms = bfv.EncryptionParameters.bfv(n, 1 << t_bits, profile="seal", coeff_modulus=coeff)
    ctx = bfv.BFVContext.build(parms, dev)
    mul = behz.multiplier(ctx)
    assert ctx.tables.profile == "m62" and (chain != "62x4" or (ctx.L, mul.K) == (4, 6))
    tq, tb = ctx.tables, mul.bsk_tables
    x = _residues(tq, (4,) + batch, n + 1)
    x[..., :3] = tq.q_b(1) - 1
    behz64_cuda.reset_launches()
    assert torch.equal(behz64_cuda.to_bsk(*x, mul).reshape(4, *batch, mul.K, n), mul._to_bsk(x))
    eq, eb = _residues(tq, (3,) + batch, n + 2), _residues(tb, (3,) + batch, n + 3)
    eq[..., -3:], eb[..., -3:] = tq.q_b(1) - 1, tb.q_b(1) - 1
    B = int(np.prod(batch))
    got = behz64_cuda.floor_sk(eq.reshape(3, B, ctx.L, n), eb.reshape(3, B, mul.K, n), mul)
    assert torch.equal(got.reshape(eq.shape), mul._sk_to_q(mul._fast_floor(eq, eb)))
    assert behz64_cuda.launches_by_kernel["behz64_to_bsk"] == 1
    assert behz64_cuda.launches_by_kernel["behz64_floor_sk"] == 1


def test_seal_at_the_limb_bound(dev):
    """L = 40 primes of 62 bits (the kernels' bound; |B_sk| = 44) at n = 64:
    the widest conversion sums the u64 route meets, up to 2^127.3 (40
    products of a residue below 2^62 and a constant below 2^60). Each step
    and the whole call at both widths against the plain version."""
    chain = get_primes(62, behz64_cuda.MAX_L, 64)
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(64, 1 << 16, coeff_modulus=chain),
                               dev)
    mul = behz.multiplier(ctx)
    assert ctx.tables.profile == "m62" and mul.K <= behz64_cuda.MAX_K
    tq, tb = ctx.tables, mul.bsk_tables
    ct1, ct2 = _cts(ctx, (2,), 62)
    for p in (*ct1.polys, *ct2.polys):
        p[..., -3:] = tq.q_b(1) - 1  # the largest residues in every input
    x = torch.stack([*ct1.polys, *ct2.polys])
    xb = mul._to_bsk(x)
    assert torch.equal(behz64_cuda.to_bsk(*ct1.polys, *ct2.polys, mul), xb)
    sq, sb = ntt.forward_plain(x, tq), ntt.forward_plain(xb, tb)
    eq, eb = behz64_cuda.tensor_spectra(sq, sb, mul)
    assert torch.equal(eq, mul.tensor_spectra(sq, tq))
    assert torch.equal(eb, mul.tensor_spectra(sb, tb))
    eq, eb = ntt.inverse_plain(eq, tq), ntt.inverse_plain(eb, tb)
    assert torch.equal(behz64_cuda.floor_sk(eq, eb, mul), mul._sk_to_q(mul._fast_floor(eq, eb)))
    g = torch.Generator(device=dev).manual_seed(40)
    sk, _ = behz.make_keys(ctx, g)
    plain3 = mul.multiply(ct1, ct2)
    for width in (1, 2):
        rlk = behz.create_relin_keys(ctx, sk, g, width=width)
        want = behz.relinearize(ctx, plain3, rlk)
        assert _same(FusedMultiplier(ctx, rlk).multiply_relinearize(ct1, ct2), want)


@pytest.mark.parametrize("n", [4096, 8192, 16384, 32768])
def test_u64_ntt_on_the_bsk_tables(dev, n):
    """The u64 transforms on each seal chain's 60-bit B_sk primes."""
    mul = behz.multiplier(_seal_ctx(n, 56, dev))
    tb = mul.bsk_tables
    assert tb.profile == "m62" and all(m.value.bit_length() == 60 for m in tb.moduli)
    x = _residues(tb, (4,), n)
    x[0, :, :2] = tb.q_b(1) - 1
    spec = ntt.forward_plain(x, tb)
    assert torch.equal(ntt_cuda.forward(x, tb), spec)
    assert torch.equal(ntt_cuda.inverse(spec, tb), x)


@pytest.mark.parametrize("n,t_bits,batch", [(4096, 16, (2,)), (8192, 56, (3,)),
                                            (32768, 56, (1,))])
def test_seal_multiply_matches_plain(dev, n, t_bits, batch):
    ctx, mul, keys, ct1, ct2 = _seal_setup(n, t_bits, batch, dev)
    plain3 = mul.multiply(ct1, ct2)
    behz64_cuda.reset_launches()
    assert _same(FusedMultiplier(ctx).multiply(ct1, ct2), plain3)
    assert behz64_cuda.launches == 3
    for rlk in keys.values():
        want = behz.relinearize(ctx, plain3, rlk)
        fused = FusedMultiplier(ctx, rlk)
        behz64_cuda.reset_launches()
        ntt_cuda.reset_launches()
        assert _same(fused.multiply_relinearize(ct1, ct2), want)
        assert behz64_cuda.launches_by_kernel == _SEAL_LAUNCHES
        assert ntt_cuda.launches_by_kernel["ntt_forward_u64"] == 3
        assert ntt_cuda.launches_by_kernel["ntt_inverse_u64"] == 3
        assert _same(fused.relinearize(plain3), want)


def test_seal_evaluator_on_card_runs_the_kernels_only(dev, monkeypatch):
    """An m62 CUDA context never reaches a plain version: the plain steps
    and the plain transforms are made to fail, and the launches counted."""
    ctx, mul, keys, ct1, ct2 = _seal_setup(4096, 16, (2,), dev)
    want3 = mul.multiply(ct1, ct2)
    want = behz.relinearize(ctx, want3, keys[1])

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for owner, name in ((behz.RnsMultiplier, "multiply"), (behz.RnsMultiplier, "_to_bsk"),
                        (behz.RnsMultiplier, "tensor_spectra"), (behz, "relinearize"),
                        (behz, "key_products"), (behz, "lift_digit_grouped"),
                        (behz_fused, "relinearize"), (ntt, "forward_plain"),
                        (ntt, "inverse_plain")):
        monkeypatch.setattr(owner, name, refuse)
    behz64_cuda.reset_launches()
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    ev = bfv.Evaluator(ctx)
    assert _same(ev.multiply_relinearize(ct1, ct2, keys[1]), want)
    assert _same(ev.multiply(ct1, ct2), want3)
    assert _same(ev.relinearize(want3, keys[1]), want)
    assert behz64_cuda.launches_by_kernel == {k: 2 for k in _SEAL_LAUNCHES}
    assert behz_cuda.launches == 0
    assert ntt_cuda.launches_by_kernel["ntt_forward_u64"] == 6
    assert ntt_cuda.launches_by_kernel["ntt_inverse_u64"] == 6


@pytest.mark.parametrize("n,t_bits", [(4096, 16), (8192, 56)])
def test_seal_real_product_and_mod_switch_on_card(dev, n, t_bits):
    ctx = _seal_ctx(n, t_bits, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rng = np.random.default_rng(n)
    a, b = (rng.integers(0, 1 << 16, size=n) for _ in range(2))
    enc, ev, dec = bfv.Encryptor(ctx, pk), bfv.Evaluator(ctx), bfv.Decryptor(ctx, sk)
    ca, cb = enc.encrypt(bfv.Plaintext(a.tolist()), g), enc.encrypt(bfv.Plaintext(b.tolist()), g)
    full = np.concatenate([np.convolve(a, b), [0]])
    want = [int(v) % ctx.t for v in full[:n] - full[n:]]
    for width in (1, 2):
        rlk = behz.create_relin_keys(ctx, sk, g, width=width)
        assert dec.decrypt(ev.multiply_relinearize(ca, cb, rlk)).coeffs[:n] == want
    small, sw = bfv.evaluator.mod_switch_to_next(ctx, ca)
    cpu = bfv.BFVContext.build(ctx.parms, "cpu")
    _, sw_cpu = bfv.evaluator.mod_switch_to_next(cpu, bfv.Ciphertext(tuple(p.cpu() for p in
                                                                            ca.polys)))
    assert all(torch.equal(x.cpu(), y) for x, y in zip(sw.polys, sw_cpu.polys))
    ssk = bfv.evaluator.restrict_secret_key(small, sk)
    assert bfv.Decryptor(small, ssk).decrypt(sw).coeffs[:n] == a.tolist()


def test_u64_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ctx, mul, keys, ct1, ct2 = _seal_setup(4096, 16, (2,), dev)
    c0, c1 = ct1.polys
    d0, d1 = ct2.polys
    before = behz64_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        behz64_cuda.multiply(c0.cpu(), c1, d0, d1, mul)
    with pytest.raises(TypeError):
        behz64_cuda.multiply(c0.to(torch.int32), c1, d0, d1, mul)
    with pytest.raises(ValueError, match="contiguous"):
        behz64_cuda.multiply(torch.stack([c0, c0], dim=-1)[..., 0], c1, d0, d1, mul)
    with pytest.raises(ValueError):
        behz64_cuda.multiply(c0[:1], c1, d0, d1, mul)
    with pytest.raises(ValueError, match="relin keys"):
        bad = behz.KSwitchKeys(keys[1].k0[:1], keys[1].k0_shoup[:1], keys[1].k1[:1],
                               keys[1].k1_shoup[:1], groups=keys[1].groups)
        behz64_cuda.relinearize(c0, c1, d0, ctx, bad)
    tpu = _bfv_ctx(4096, dev)
    x = _residues(tpu.tables, (1,), 3)
    with pytest.raises(ValueError, match="m62"):
        behz64_cuda.add_switched(x, x, torch.stack([x, x]).reshape(2, 1, tpu.L, tpu.n), tpu)
    assert behz64_cuda.launches == before


# ---------------------------------------------------------------------------
# The mulmod chain (csrc/mulmod_chain.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [0, 1, 16, 37])
def test_mulmod_chain_matches_plain(dev, steps):
    g = torch.Generator(device=dev).manual_seed(steps)
    x = torch.randint(0, mulmod_chain.Q, (256, 4, 4096), generator=g, device=dev,
                      dtype=torch.int64)
    x[0, 0, :3] = torch.tensor([0, mulmod_chain.Q - 1, (1 << 32) - 1])
    before = mulmod_chain.launches
    got = mulmod_chain.chain(x, steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(got, mulmod_chain.chain_plain(x, steps=steps))
    assert mulmod_chain.launches == before + 1


def test_mulmod_chain_refuses_what_the_kernel_does_not_take(dev):
    x = torch.zeros((4, 64), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mulmod_chain.chain_cuda(x.cpu())
    with pytest.raises(TypeError):
        mulmod_chain.chain_cuda(x.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        mulmod_chain.chain_cuda(x.T)
