"""The port on a CUDA card: the hand-written kernels against their plain
versions (the u32 and u64 NTTs, the BEHZ multiply + relinearization, the
mulmod chain), the demo on both profiles and the packed pipeline.

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
from pplp_tpu_torch.ops import behz_cuda, mulmod_chain, ntt, ntt_cuda
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


# The seal chains (n, L): 4096/3, 8192/5, 16384/9 and 32768/16; n = 32768 is
# the kernel's split path. The last case puts primes just below 2^62 and
# 2^61 on the split path, where the lazy forward values reach 4q ~ 2^64.
U64_CASES = [(4096, None), (8192, None), (16384, None), (32768, None),
             (32768, (62, 61))]


@pytest.mark.parametrize("n,bits", U64_CASES)
def test_u64_kernel_matches_plain(dev, n, bits):
    chain = bfv_default(n) if bits is None else [get_primes(b, 1, n)[0] for b in bits]
    tb = ntt.build_tables([Modulus(q) for q in chain], n, dev)
    assert tb.profile == "m62"
    x = _residues(tb, (2,), n)
    x[0, :, :4] = tb.q_b(1) - 1
    before = dict(ntt_cuda.launches_by_kernel)
    spec = ntt.forward(x, tb)
    back = ntt.inverse(spec, tb)
    torch.cuda.synchronize()
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)
    after = ntt_cuda.launches_by_kernel
    assert {k: after[k] - before[k] for k in after} == {
        "ntt_forward": 0, "ntt_inverse": 0, "ntt_forward_u64": 1, "ntt_inverse_u64": 1}


def test_largest_canonical_inputs(dev):
    """q - 1 in every slot drives the lazy butterflies to their bounds."""
    tb = _tables(4096, dev)
    x = (tb.q_b(1) - 1).expand(2, tb.L, tb.n).contiguous()
    assert torch.equal(ntt.forward(x, tb), ntt.forward_plain(x, tb))


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    tb = _tables(4096, dev)
    x = _residues(tb, (4,), 1)
    with pytest.raises(TypeError):
        ntt_cuda.forward(x.to(torch.int32), tb)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.forward(x[::2], tb)
    with pytest.raises(ValueError):
        ntt_cuda.forward(x[..., :2048].contiguous(), tb)
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


@pytest.mark.parametrize("n", [64, 4096])
def test_behz_kernel_matches_plain(dev, n):
    ctx = _bfv_ctx(n, dev)
    g = torch.Generator(device=dev).manual_seed(n)
    sk, _ = behz.make_keys(ctx, g)
    rlk1, rlk2 = (behz.create_relin_keys(ctx, sk, g, width=w) for w in (1, 2))
    assert rlk1.groups != rlk2.groups
    ct1, ct2 = _cts(ctx, (3,), n)
    mul = behz.multiplier(ctx)
    plain3 = mul.multiply(ct1, ct2)
    behz_cuda.reset_launches()
    got3 = FusedMultiplier(ctx).multiply(ct1, ct2)
    torch.cuda.synchronize()
    assert _same(got3, plain3)
    assert behz_cuda.launches == 4  # to_bsk, tensor x 2, floor_sk
    for rlk in (rlk1, rlk2):
        want = behz.relinearize(ctx, plain3, rlk)
        fused = FusedMultiplier(ctx, rlk)
        assert _same(fused.multiply_relinearize(ct1, ct2), want)
        behz_cuda.reset_launches()
        assert _same(fused.relinearize(plain3), want)  # the relinearization alone
        assert behz_cuda.launches == 3  # lift, keyprod, add


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
        "behz_to_bsk": 2, "behz_tensor": 4, "behz_floor_sk": 2,
        "behz_lift": 2, "behz_keyprod": 2, "behz_add": 2}
    assert ntt_cuda.launches > 0


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
