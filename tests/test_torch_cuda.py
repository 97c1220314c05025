"""The port on a CUDA card: the hand-written kernels against their plain
versions (the u32 NTT in both I/O widths, the u64 NTT,
the BEHZ multiply + relinearization on the fused and the separate routes,
the seal (m62) multiply on the u64 route and its steps, the u64 NTT on the
60-bit B_sk tables, the mulmod chain, the DGK Montgomery kernels), the seal
real product and mod switch, the demo on both profiles, the packed pipeline,
the networked entry points and the DGK batch path and protocol.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither jax nor the JAX package, so it also runs where jax is not
installed; on the card run it without the suite's conftest (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are bit-exact (tolerance 0): all arithmetic is exact integer
arithmetic.
"""

import ctypes

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


# -- the networked entry points (protocol.netmain, bfv.serialize keys, the sweep) --

_NET_NTT = {"tpu": ("ntt_forward", "ntt_inverse"), "seal": ("ntt_forward_u64", "ntt_inverse_u64")}


def _tcp_run(client_fn, server_fn):
    """server_fn(channel) on a thread and client_fn(channel) here, over a TCP
    connection on 127.0.0.1; (client result, server result, channels)."""
    import socket
    import threading

    from pplp_tpu_torch.protocol.transport import Channel

    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        ca = Channel(socket.create_connection(listener.getsockname()))
        cb = Channel(listener.accept()[0])
    out, err = {}, []

    def serve():
        try:
            out["server"] = server_fn(cb)
        except Exception as e:  # re-raised below
            err.append(e)

    th = threading.Thread(target=serve)
    th.start()
    try:
        client = client_fn(ca)
    finally:
        th.join(timeout=300)
        ca.close()
        cb.close()
    assert not th.is_alive()
    if err:
        raise err[0]
    return client, out["server"], ca, cb


@pytest.mark.parametrize("profile", ["seal", "tpu"])
def test_client_server_pair_on_card(dev, profile):
    """run_client_protocol / run_server_protocol over 127.0.0.1 at n = 8192,
    t = 2^56, r = 128 (far) and 320 (near): the oracle's verdict, the blind
    distance s(d^2 + r) mod t, the profile's NTT kernels, the filter on the
    card, the byte counts of both sides equal."""
    from pplp_tpu_torch.protocol import ProtocolConfig
    from pplp_tpu_torch.protocol.netmain import run_client_protocol, run_server_protocol

    for radius, near in ((128, False), (320, True)):
        kw = dict(radius=radius, profile=profile, seed=17, false_positive_probability=1e-4)
        ntt_cuda.reset_launches()
        client, server, ca, cb = _tcp_run(
            lambda ch: run_client_protocol(ch, ProtocolConfig(xa=1234, ya=1212, **kw),
                                           verbose=False, device=dev),
            lambda ch: run_server_protocol(ch, ProtocolConfig(xb=1000, yb=1000, **kw),
                                           verbose=False, device=dev))
        counts = dict(ntt_cuda.launches_by_kernel)
        assert all(counts[k] > 0 for k in _NET_NTT[profile]), counts
        assert client.is_near is near
        bl = server.blinding
        assert client.blind_distance == bl.s * (99_700 + bl.r) % (1 << 56)
        assert server.bf.bits_device.is_cuda
        assert (ca.bytes_sent, ca.bytes_received) == (cb.bytes_received, cb.bytes_sent)


@pytest.mark.parametrize("profile", ["seal", "tpu"])
def test_key_formats_on_card(dev, profile):
    """pk, sk and width-1/2 relinearization keys at n = 8192: the card saves
    the bytes a CPU copy saves, and loads them to the CPU's tensors."""
    import copy

    from pplp_tpu_torch.bfv import serialize

    parms = bfv.EncryptionParameters.bfv(8192, 1 << 56, profile=profile)
    ctx, cpu = bfv.BFVContext.build(parms, dev), bfv.BFVContext.build(parms, "cpu")
    g = torch.Generator(device=dev).manual_seed(31)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    cases = [(pk, serialize.save_public_key, serialize.load_public_key),
             (sk, serialize.save_secret_key, serialize.load_secret_key)]
    cases += [(behz.create_relin_keys(ctx, sk, g, width=w), serialize.save_kswitch_keys,
               serialize.load_kswitch_keys) for w in (1, 2)]
    for key, save, load in cases:
        leaves = {k: v for k, v in vars(key).items() if k != "groups"}
        host = copy.copy(key)
        for k, v in leaves.items():
            setattr(host, k, v.cpu())
        ntt_cuda.reset_launches()
        blob = save(key, ctx)
        on_card = load(blob, ctx)
        assert ntt_cuda.launches == 2
        assert blob == save(host, cpu)
        on_cpu = load(blob, cpu)
        for k, v in leaves.items():
            assert torch.equal(getattr(on_card, k), v), k
            assert torch.equal(getattr(on_card, k).cpu(), getattr(on_cpu, k)), k
        assert getattr(on_card, "groups", None) == getattr(key, "groups", None)


@pytest.mark.parametrize("profile", ["seal", "tpu"])
@pytest.mark.parametrize("variant", ["leg", "opt"])
def test_sweep_radius_on_card(dev, profile, variant):
    """One tc/ts radius (r = 64, n = 8192, t = 2^56) of either variant over
    127.0.0.1 on the card: the profile's NTT kernels ran, the traffic counts
    agree, the server's stages took time."""
    from pplp_tpu_torch.benchmark import sweep

    tc = getattr(sweep, f"test_client_{variant}")
    ts = getattr(sweep, f"test_server_{variant}")
    ntt_cuda.reset_launches()
    (traffic, dur), sdur, ca, cb = _tcp_run(
        lambda ch: tc(ch, 64, 1234, 1212, 13, 56, profile, device=dev),
        lambda ch: ts(ch, 64, 1000, 1000, profile, device=dev))
    counts = dict(ntt_cuda.launches_by_kernel)
    assert all(counts[k] > 0 for k in _NET_NTT[profile]), counts
    assert (traffic.c_sendPk > 0) == (variant == "leg")
    assert traffic.c_total == traffic.c_totalSend + traffic.c_totalRecv
    assert ca.bytes_sent == cb.bytes_received and ca.bytes_received == cb.bytes_sent
    assert sdur.d_setBF > 0 and sdur.d_homoCalc > 0 and dur.d_total > 0


def test_device_named_without_an_index(dev):
    """``--device cuda`` (no index): the tables, the context and every
    tensor made on it resolve to the current card, so the kernels take
    them; the demo runs through the NTT kernels."""
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, 1 << 40), "cuda")
    assert ctx.device == torch.device("cuda", torch.cuda.current_device())
    ntt_cuda.reset_launches()
    res = run_local_demo(ProtocolConfig(radius=16, poly_modulus_degree_bits=12,
                                        plain_modulus_bits=40, seed=3),
                         verbose=False, device="cuda")
    assert ntt_cuda.launches > 0 and res.bf_device.type == "cuda"


# ---------------------------------------------------------------------------
# The DGK back-end (csrc/dgk_mont.cu)
# ---------------------------------------------------------------------------

_DGK_KEYS = {512: (512, 64, 12, 7), 2048: (2048, 320, 16, 5)}  # W = 17 and 65
_DGK_LANES = 67  # not a multiple of the 64-thread block


@pytest.fixture(scope="module", params=sorted(_DGK_KEYS), ids=lambda k: f"k{k}")
def dgk_keys(request):
    from pplp_tpu_torch.dgk import dgk_gen_keys

    return dgk_gen_keys(*_DGK_KEYS[request.param][:3], seed=_DGK_KEYS[request.param][3])


def _dgk_operands(mc, dev, seed):
    """_DGK_LANES numbers below n: 0, 1, 2, n - 1, n - 2, then random."""
    import random

    from pplp_tpu_torch.dgk.modexp import to_digits

    rng, n = random.Random(seed), mc.n_int
    vals = [0, 1, 2, n - 1, n - 2] + [rng.randrange(n) for _ in range(_DGK_LANES - 5)]
    rng.shuffle(vals)
    return vals, to_digits(vals, mc.D, dev)


def test_dgk_kernels_match_plain(dev, dgk_keys):
    """Each kernel against its plain version on the card and against pow."""
    import random

    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import from_digits
    from pplp_tpu_torch.ops import dgk_cuda

    priv, pub = dgk_keys
    mc = DGKBatch.build(pub, device=dev).mc
    n, rng = pub.n, random.Random(1)
    a, A = _dgk_operands(mc, dev, 1)
    b, Bd = _dgk_operands(mc, dev, 2)
    before = dict(dgk_cuda.launches_by_kernel)
    got = dgk_cuda.mulmod(mc, A, Bd)
    assert torch.equal(got, mc.mulmod(A, Bd))
    assert from_digits(got) == [x * y % n for x, y in zip(a, b)]
    assert torch.equal(dgk_cuda.mulmod(mc, A, Bd[3:4]), mc.mulmod(A, Bd[3:4]))
    got = dgk_cuda.mulmod_const(mc, A, b[7])  # the giant step's one-product form
    assert torch.equal(got, dgk_cuda.mulmod_const_plain(mc, A, b[7]))
    assert from_digits(got) == [x * b[7] % n for x in a]
    exps = [0, 1, 2] + [rng.getrandbits(rng.choice([5, 20, 33])) for _ in range(_DGK_LANES - 3)]
    for base in (A, A[:1]):  # per-lane and shared bases
        got = dgk_cuda.powmod(mc, base, exps)
        assert torch.equal(got, dgk_cuda.powmod_plain(mc, base, exps))
    for e in (0, 1, 37, 123321):
        assert torch.equal(dgk_cuda.powmod_shared_exp(mc, A, e), mc.powmod_shared_exp(A, e))
    got = from_digits(dgk_cuda.powmod_shared_exp(mc, A, priv.vpq))  # the decrypt exponent
    assert got == [pow(x, priv.vpq, n) for x in a]
    cs = [_dgk_operands(mc, dev, s)[1] for s in range(3, 8)]
    for xb, yb, s in ((123321, 123654, 37), (0, 3, 0), (1, 0, 65535)):
        got = dgk_cuda.blind_distance(mc, *cs[:3], xb, yb, s, *cs[3:])
        assert torch.equal(got, dgk_cuda.blind_distance_plain(mc, *cs[:3], xb, yb, s, *cs[3:]))
    after = dgk_cuda.launches_by_kernel
    assert {k: after[k] - before[k] for k in after} == {
        "dgk_mulmod": 3, "dgk_powmod_lanes": 2, "dgk_powmod_shared": 5, "dgk_blind_distance": 3}


def test_dgk_group_geometry_is_the_models(dev):
    """The library's group geometry (G, L, window bits) at each width is the
    one the host model checks (tests/test_torch_dgk_host.py GEOMETRY)."""
    from pplp_tpu_torch.ops import dgk_cuda

    assert {W: dgk_cuda.group(W) for W in dgk_cuda.WIDTHS} == {
        17: (4, 5, 3), 33: (3, 11, 3), 65: (5, 13, 3), 97: (8, 13, 3), 129: (10, 13, 3)}
    lib, geometry = dgk_cuda.load(), (ctypes.c_int * 3)()
    assert lib.pplp_dgk_group(13, geometry) != 0  # a width not built


@pytest.mark.parametrize("batch", [1, 5, 13, 67])
def test_dgk_group_kernels_at_batch_sizes(dev, dgk_keys, batch):
    """The group kernels (G threads a number) at a batch of one group, part
    of a warp, one group past a full block (13 at G = 5: 12 numbers a
    block) and several blocks with a partial last group: per-lane and
    shared bases against the plain versions (exponents up to 64 bits, the
    plain version runs ~100 launches a product) and 800- and 640-bit
    exponents against pow."""
    import random

    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import from_digits
    from pplp_tpu_torch.ops import dgk_cuda

    priv, pub = dgk_keys
    mc = DGKBatch.build(pub, device=dev).mc
    vals, A = _dgk_operands(mc, dev, 11)
    vals, A = vals[:batch], A[:batch]
    rng, n = random.Random(batch), pub.n
    short = ([0, 1, (1 << 64) - 1] + [rng.getrandbits(rng.choice([3, 20, 64]))
                                      for _ in range(batch)])[:batch]
    wide = ([0, 1, (1 << 800) - 1] + [rng.getrandbits(800) for _ in range(batch)])[:batch]
    before = dict(dgk_cuda.launches_by_kernel)
    for base, bv in ((A, vals), (A[:1], vals[:1] * batch)):
        assert torch.equal(dgk_cuda.powmod(mc, base, short),
                           dgk_cuda.powmod_plain(mc, base, short))
        got = from_digits(dgk_cuda.powmod(mc, base, wide))
        assert got == [pow(x, e, n) for x, e in zip(bv, wide)]
    for e in (0, 1, 37):
        assert torch.equal(dgk_cuda.powmod_shared_exp(mc, A, e), mc.powmod_shared_exp(A, e))
    for e in (priv.vpq, (1 << 640) - 1):
        got = from_digits(dgk_cuda.powmod_shared_exp(mc, A, e))
        assert got == [pow(x, e, n) for x in vals]
    after = dgk_cuda.launches_by_kernel
    assert after["dgk_powmod_lanes"] - before["dgk_powmod_lanes"] == 4
    assert after["dgk_powmod_shared"] - before["dgk_powmod_shared"] == 5


def test_dgk_batch_on_card_runs_the_kernels_only(dev, dgk_keys, monkeypatch):
    """encrypt, blind distance and both device decrypts on the card through
    the kernels alone (the plain products raise), against the clear oracle."""
    import random

    from pplp_tpu_torch.dgk import dgk_encrypt
    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import MontgomeryCtx, to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    priv, pub = dgk_keys
    db = DGKBatch.build(pub, device=dev)
    u, rng, B = pub.u, random.Random(5), _DGK_LANES
    xa, ya = [rng.randrange(300) for _ in range(B)], [rng.randrange(300) for _ in range(B)]
    xb, yb, s, r = 123, 45, rng.randrange(1, u), rng.randrange(u)
    rnd = int(2.5 * pub.t)
    monkeypatch.setattr(MontgomeryCtx, "mont_mul", lambda *a: pytest.fail("plain product"))
    dgk_cuda.reset_launches()
    ms = [(x * x + y * y) % u for x, y in zip(xa, ya)]
    c1 = db.encrypt_batch(ms, [rng.getrandbits(rnd) for _ in range(B)])
    c2, c3, cz, cr = (to_digits([dgk_encrypt(pub, m, rng.getrandbits(rnd)) for m in row],
                                db.mc.D, dev)
                      for row in ([(-2 * x) % u for x in xa], [(-2 * y) % u for y in ya],
                                  [s * (xb * xb + yb * yb) % u] * B, [s * r % u] * B))
    out = db.blind_distance_batch(c1, c2, c3, xb, yb, s, cz, cr)
    want = [s * ((x - xb) ** 2 + (y - yb) ** 2 + r) % u for x, y in zip(xa, ya)]
    assert db.decrypt_batch_device(priv, db.build_device_table(priv), out).tolist() == want
    assert db.decrypt_batch_device_bsgs(priv, db.build_bsgs_table(priv), out).tolist() == want
    assert db.decrypt_batch(priv, c1) == ms
    counts = dgk_cuda.launches_by_kernel
    assert counts["dgk_powmod_lanes"] == 2 and counts["dgk_blind_distance"] == 1
    assert counts["dgk_powmod_shared"] == 3 and counts["dgk_mulmod"] > 1


def test_dgk_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A modulus of a width not compiled (W = 13) runs at the next one up;
    one wider than the widest (W = 130) is refused by name, as are CPU
    operands, other types, row counts and exponents past 2048 bits."""
    from pplp_tpu_torch.dgk.modexp import MontgomeryCtx, from_digits, to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    n = (1 << 383) | 12345
    mc = MontgomeryCtx.build(n, device=dev)  # W = 13, run at 17
    x = to_digits([1, 2, n - 1], mc.D, dev)
    assert from_digits(dgk_cuda.mulmod(mc, x, x)) == [1, 4, 1]
    assert torch.equal(dgk_cuda.blind_distance(mc, x, x, x, 3, 2, 5, x, x),
                       dgk_cuda.blind_distance_plain(mc, x, x, x, 3, 2, 5, x, x))
    mc = MontgomeryCtx.build((1 << 4112) | 12345, device=dev)  # W = 130
    x = to_digits([1, 2], mc.D, dev)
    with pytest.raises(ValueError, match="at most 129 32-bit limbs .* W = 130"):
        dgk_cuda.mulmod(mc, x, x)
    mc = MontgomeryCtx.build((1 << 511) | 12345, device=dev)  # W = 17
    x = to_digits([1, 2], mc.D, dev)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dgk_cuda.mulmod_cuda(mc, x, x.cpu())
    with pytest.raises(ValueError, match="digit rows"):
        dgk_cuda.mulmod_cuda(mc, x.to(torch.int32), x)
    with pytest.raises(ValueError, match="rows for"):
        dgk_cuda.powmod_cuda(mc, x, [1, 2, 3])
    with pytest.raises(ValueError, match="shared exponent"):
        dgk_cuda.powmod_shared_exp(mc, x, 1 << 2048)


@pytest.mark.parametrize("bits", [1040, 3081, 4105])
def test_dgk_kernels_at_the_other_widths(dev, bits):
    """Random odd moduli at W = 33, 97 and 129: each kernel against its
    plain version and pow, at a batch not a multiple of a block, with the
    edge cases among the operands."""
    import random

    from pplp_tpu_torch.dgk.modexp import MontgomeryCtx, from_digits, to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    rng = random.Random(bits)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    mc = MontgomeryCtx.build(n, device=dev)
    B = 23
    vals = [[0, 1, 2, n - 1, n - 2] + [rng.randrange(n) for _ in range(B - 5)]
            for _ in range(5)]
    for v in vals:
        rng.shuffle(v)
    cs = [to_digits(v, mc.D, dev) for v in vals]
    A, a = cs[0], vals[0]
    got = dgk_cuda.mulmod(mc, A, cs[1])
    assert torch.equal(got, mc.mulmod(A, cs[1]))
    assert from_digits(got) == [x * y % n for x, y in zip(a, vals[1])]
    assert torch.equal(dgk_cuda.mulmod_const(mc, A, vals[1][0]),
                       dgk_cuda.mulmod_const_plain(mc, A, vals[1][0]))
    exps = [0, 1] + [rng.getrandbits(16) for _ in range(B - 2)]
    assert torch.equal(dgk_cuda.powmod(mc, A, exps), dgk_cuda.powmod_plain(mc, A, exps))
    assert from_digits(dgk_cuda.powmod_shared_exp(mc, A, 37)) == [pow(x, 37, n) for x in a]
    for xb, yb, s in ((123321, 123654, 37), (0, 1, 0)):
        got = dgk_cuda.blind_distance(mc, *cs[:3], xb, yb, s, *cs[3:])
        assert torch.equal(got, dgk_cuda.blind_distance_plain(mc, *cs[:3], xb, yb, s, *cs[3:]))
        assert from_digits(got) == [
            pow(c1 * pow(c2, xb, n) * pow(c3, yb, n) % n, s, n) * cz * cr % n
            for c1, c2, c3, cz, cr in zip(*vals)]


def test_dgk_batch_at_k1024_on_card(dev):
    """DGKBatch at real k = 1024 keys (t = 160, l = 16; W = 33), which the
    card path refused before it ran every width: encrypt, blind distance
    and the device decrypt through the kernels, every lane equal to
    s(d^2 + r) mod u."""
    import random

    from pplp_tpu_torch.dgk import dgk_encrypt, dgk_gen_keys
    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    priv, pub = dgk_gen_keys(1024, 160, 16, seed=3)
    db = DGKBatch.build(pub, device=dev)
    assert dgk_cuda.width(db.mc) == 33
    u, rng, B = pub.u, random.Random(6), 200
    xa, ya = [rng.randrange(300) for _ in range(B)], [rng.randrange(300) for _ in range(B)]
    xb, yb, s, r = 123, 45, rng.randrange(1, u), rng.randrange(u)
    rnd = int(2.5 * pub.t)
    dgk_cuda.reset_launches()
    ms = [(x * x + y * y) % u for x, y in zip(xa, ya)]
    c1 = db.encrypt_batch(ms, [rng.getrandbits(rnd) for _ in range(B)])
    c2, c3, cz, cr = (to_digits([dgk_encrypt(pub, m, rng.getrandbits(rnd)) for m in row],
                                db.mc.D, dev)
                      for row in ([(-2 * x) % u for x in xa], [(-2 * y) % u for y in ya],
                                  [s * (xb * xb + yb * yb) % u] * B, [s * r % u] * B))
    out = db.blind_distance_batch(c1, c2, c3, xb, yb, s, cz, cr)
    want = [s * ((x - xb) ** 2 + (y - yb) ** 2 + r) % u for x, y in zip(xa, ya)]
    assert db.decrypt_batch_device(priv, db.build_device_table(priv), out).tolist() == want
    assert db.decrypt_batch(priv, c1) == ms
    assert all(v > 0 for v in dgk_cuda.launches_by_kernel.values())


@pytest.mark.parametrize("radius,coords,near", [(44, (100, 100, 140, 110), True),
                                                (31, (100, 100, 140, 120), False)])
def test_pplp_dgk_on_card(dev, radius, coords, near):
    from pplp_tpu_torch.dgk import dgk_gen_keys
    from pplp_tpu_torch.dgk.protocol import pplp_dgk

    xa, ya, xb, yb = coords
    res = pplp_dgk(radius, xa=xa, ya=ya, xb=xb, yb=yb, k=512, t=64, l=12, seed=8,
                   keys=dgk_gen_keys(512, 64, 12, seed=7))
    assert res.is_near == near


# ---------------------------------------------------------------------------
# Special-prime key switching, Galois rotations, the batch encoder and CKKS
# ---------------------------------------------------------------------------

SURFACE_STEPS = {"+1": 1, "-1": -1, "columns": None}


def _surface_setup(profile, dev, batch=(3,)):
    """A context with a batching t at n = 4096 on ``profile``'s chain, its
    CPU twin, keys (SP and gadget Galois keys for each step, SP and width-1
    relinearization keys) and two ciphertexts of random residues."""
    from pplp_tpu_torch.bfv import galois, keyswitch

    n = 4096
    t = get_primes(20, 1, n)[0]
    parms = bfv.EncryptionParameters.bfv(n, t, profile=profile)
    ctx, cpu = bfv.BFVContext.build(parms, dev), bfv.BFVContext.build(parms, "cpu")
    g = torch.Generator(device=dev).manual_seed(17)
    kg = bfv.KeyGenerator(ctx, g)
    sk = kg.secret_key()
    keys = {}
    for name, step in SURFACE_STEPS.items():
        elt = 2 * n - 1 if step is None else galois.galois_elt_from_step(step, n)
        keys["sp", name] = (elt, keyswitch.create_sp_galois_keys(ctx, kg, elt, g))
        keys["gadget", name] = (elt, galois.create_galois_keys(ctx, sk, elt, g))
    keys["relin", "sp"] = keyswitch.create_sp_relin_keys(ctx, kg, g)
    keys["relin", "w1"] = behz.create_relin_keys(ctx, sk, g, width=1)
    ct1, ct2 = _cts(ctx, batch, 23)
    return ctx, cpu, keys, ct1, ct2


def _to_cpu(keys, cpu):
    from pplp_tpu_torch.bfv import keyswitch

    leaves = [x.cpu() for x in (keys.k0, keys.k0_shoup, keys.k1, keys.k1_shoup)]
    if isinstance(keys, keyswitch.SPKeys):
        return keyswitch.SPKeys(keyswitch.build_ctx_qp(cpu)[0], keys.P, *leaves)
    return behz.KSwitchKeys(*leaves, groups=keys.groups)


def _cpu_ct(ct):
    return bfv.Ciphertext(tuple(p.cpu() for p in ct.polys), ct.domain)


def _same_cpu(card, cpu_ct):
    return card.size == cpu_ct.size and all(
        torch.equal(x.cpu(), y) for x, y in zip(card.polys, cpu_ct.polys))


@pytest.mark.parametrize("profile", ["tpu", "seal"])
def test_sp_relinearize_and_rotations_match_cpu(dev, profile):
    from pplp_tpu_torch.bfv import galois, keyswitch

    ctx, cpu, keys, ct1, ct2 = _surface_setup(profile, dev)
    for (kind, name), (elt, gk) in ((k, v) for k, v in keys.items() if k[0] != "relin"):
        got = galois.apply_galois(ctx, ct1, elt, gk)
        assert _same_cpu(got, galois.apply_galois(cpu, _cpu_ct(ct1), elt, _to_cpu(gk, cpu))), (
            kind, name)
    ct3 = bfv.Evaluator(ctx).multiply(ct1, ct2)
    cpu3 = bfv.Evaluator(cpu).multiply(_cpu_ct(ct1), _cpu_ct(ct2))
    assert _same_cpu(ct3, cpu3)
    spk = keys["relin", "sp"]
    assert _same_cpu(keyswitch.sp_relinearize(ctx, ct3, spk),
                     keyswitch.sp_relinearize(cpu, cpu3, _to_cpu(spk, cpu)))


@pytest.mark.parametrize("profile", ["tpu", "seal"])
def test_sp_keys_bytes_on_card(dev, profile):
    from pplp_tpu_torch.bfv import serialize

    ctx, cpu, keys, _, _ = _surface_setup(profile, dev, batch=(1,))
    spk = keys["relin", "sp"]
    blob = serialize.save_sp_keys(spk, ctx)
    assert blob == serialize.save_sp_keys(_to_cpu(spk, cpu), cpu)
    back = serialize.load_sp_keys(blob, ctx)
    assert back.k0.device == spk.k0.device
    assert all(torch.equal(a, b) for a, b in zip((back.k0, back.k0_shoup, back.k1, back.k1_shoup),
                                                 (spk.k0, spk.k0_shoup, spk.k1, spk.k1_shoup)))


@pytest.mark.parametrize("rows", [(1,), (64,)])
def test_u64_ntt_on_the_61_bit_special_prime(dev, rows):
    """The QP tables of the CLI's seal chain at n = 8192: five 43-44-bit
    primes and the 61-bit special prime, whose lazy values reach 4P."""
    from pplp_tpu_torch.bfv import keyswitch

    ctx_qp, P = keyswitch.build_ctx_qp(_seal_ctx(8192, 20, dev))
    assert P.bit_length() == 61 and ctx_qp.L == 6
    tb = ctx_qp.tables
    x = _residues(tb, rows, 61)
    x[..., :3] = tb.q_b(1) - 1
    before = dict(ntt_cuda.launches_by_kernel)
    spec = ntt.forward(x, tb)
    back = ntt.inverse(spec, tb)
    torch.cuda.synchronize()
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)
    assert ntt_cuda.launches_by_kernel["ntt_forward_u64"] == before["ntt_forward_u64"] + 1


def test_gadget_rotation_is_one_relinearization_launch(dev):
    from pplp_tpu_torch.bfv import galois

    ctx, _, keys, ct1, _ = _surface_setup("tpu", dev)
    elt, gk = keys["gadget", "+1"]
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    galois.apply_galois(ctx, ct1, elt, gk)
    assert {k: v for k, v in behz_cuda.launches_by_kernel.items() if v} == {"behz_relin_ntt": 1}
    assert ntt_cuda.launches == 0


def test_surface_on_card_runs_no_plain_version(dev, monkeypatch):
    """Rotations with both key kinds, sp_relinearize and ckks_multiply (SP
    and gadget keys) on the card with the plain transforms and the plain
    key switch made to fail; the NTT and relinearization kernels counted."""
    from pplp_tpu_torch.bfv import galois, keyswitch
    from pplp_tpu_torch.ckks import ckks

    results = {}
    for profile in ("tpu", "seal"):
        ctx, cpu, keys, ct1, ct2 = _surface_setup(profile, dev)
        ct3 = bfv.Evaluator(ctx).multiply(ct1, ct2)
        results[profile] = ctx, cpu, keys, ct1, ct3
    cctx = ckks.CKKSContext.build(n=4096, scale=float(1 << 26),
                                  coeff_modulus=get_primes(28, 4, 4096), device=dev)
    cpu_cctx = ckks.CKKSContext.build(n=4096, scale=float(1 << 26),
                                      coeff_modulus=get_primes(28, 4, 4096), device="cpu")
    g = torch.Generator(device=dev).manual_seed(4)
    ckg = bfv.KeyGenerator(cctx.base, g)
    csk, cpk = ckg.secret_key(), ckg.create_public_key()
    ckeys = {"sp": keyswitch.create_sp_relin_keys(cctx.base, ckg, g),
             "gadget": ckks.ckks_create_relin_keys(cctx, csk, g)}
    enc = ckks.CKKSEncoder(cctx)
    ca, cb = (ckks.ckks_encrypt(cctx, cpk, enc.coeffs_to_rns(np.stack([enc.encode(v)] * 2)), g)
              for v in ([1.5, -2.0], [4.0, 0.25]))
    want = {kind: ckks.ckks_multiply(cpu_cctx, _cpu_ct(ca), _cpu_ct(cb),
                                     rlk=_to_cpu(k, cpu_cctx.base))
            for kind, k in ckeys.items()}

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for owner, name in ((ntt, "forward_plain"), (ntt, "inverse_plain"),
                        (behz, "keyswitch_contributions"),
                        (behz, "keyswitch_contributions_grouped"), (behz, "relinearize")):
        monkeypatch.setattr(owner, name, refuse)
    for mod in (ntt_cuda, behz_cuda, behz64_cuda):
        mod.reset_launches()
    outs = []
    for profile, (ctx, cpu, keys, ct1, ct3) in results.items():
        for (kind, name), (elt, gk) in ((k, v) for k, v in keys.items() if k[0] != "relin"):
            outs.append((profile, kind, name, galois.apply_galois(ctx, ct1, elt, gk)))
        outs.append((profile, "relin", "sp", keyswitch.sp_relinearize(ctx, ct3,
                                                                      keys["relin", "sp"])))
    prods = {kind: ckks.ckks_multiply(cctx, ca, cb, rlk=k) for kind, k in ckeys.items()}
    torch.cuda.synchronize()
    counts = {**ntt_cuda.launches_by_kernel, **behz_cuda.launches_by_kernel,
              **behz64_cuda.launches_by_kernel}
    monkeypatch.undo()
    # tpu: 3 SP rotations + sp_relinearize, 2 transforms each; CKKS: 1 forward
    # and 1 inverse per multiply, 2 more with SP keys. seal: the same on u64.
    assert counts["ntt_forward"] == 4 + 2 + 1 and counts["ntt_inverse"] == 4 + 2 + 1
    assert counts["ntt_forward_u64"] >= 4 and counts["ntt_inverse_u64"] >= 4
    assert counts["behz_relin_ntt"] == 3 + 1  # gadget rotations, CKKS gadget relinearize
    assert counts["behz64_keyprod"] == 3
    for profile, kind, name, got in outs:
        ctx, cpu, keys, ct1, ct3 = results[profile]
        if kind == "relin":
            want_ct = keyswitch.sp_relinearize(cpu, _cpu_ct(ct3),
                                               _to_cpu(keys["relin", "sp"], cpu))
        else:
            elt, gk = keys[kind, name]
            want_ct = galois.apply_galois(cpu, _cpu_ct(ct1), elt, _to_cpu(gk, cpu))
        assert _same_cpu(got, want_ct), (profile, kind, name)
    for kind, got in prods.items():
        assert _same_cpu(got, want[kind]), kind


@pytest.mark.parametrize("profile", ["tpu", "seal"])
def test_batch_encoder_on_card(dev, profile):
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(
        4096, get_primes(20, 1, 4096)[0], profile=profile), dev)
    cpu = bfv.BFVContext.build(ctx.parms, "cpu")
    rows = np.random.default_rng(5).integers(0, ctx.t, size=(4, 4096))
    be, cpu_be = bfv.BatchEncoder(ctx), bfv.BatchEncoder(cpu)
    ntt_cuda.reset_launches()
    coeffs = be.encode_rows(rows)
    assert np.array_equal(coeffs, cpu_be.encode_rows(rows))
    assert np.array_equal(be.decode_rows(coeffs), rows)
    assert ntt_cuda.launches_by_kernel["ntt_inverse"] == 1
    assert ntt_cuda.launches_by_kernel["ntt_forward"] == 1


def test_ckks_demo_and_rescale_on_card(dev):
    from pplp_tpu_torch.ckks import ckks
    from pplp_tpu_torch.ckks.demo import run_aggregation_demo

    assert run_aggregation_demo(verbose=False, device=dev).abs_error < 1e-2
    chain = get_primes(28, 4, 8192)
    ctx = ckks.CKKSContext.build(n=8192, scale=float(1 << 26), coeff_modulus=chain, device=dev)
    cpu = ckks.CKKSContext.build(n=8192, scale=float(1 << 26), coeff_modulus=chain,
                                 device="cpu")
    ct = bfv.Ciphertext(tuple(_residues(ctx.base.tables, (2,), 90 + i) for i in range(2)))
    _, got = ckks.ckks_rescale(ctx, ct)
    _, want = ckks.ckks_rescale(cpu, _cpu_ct(ct))
    assert _same_cpu(got, want)
