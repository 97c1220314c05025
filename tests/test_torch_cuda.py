"""The port on a CUDA card: the hand-written kernels against their plain
versions (the u32 NTT in both I/O widths, the u64 NTT,
the BEHZ multiply + relinearization on the fused and the separate routes,
the seal (m62) multiply on the u64 route and its steps, the u64 NTT on the
60-bit B_sk tables, the m62 profile's elementwise kernels (every op of
``modmath.m62`` against the plain chain, and the demo's BFV stages on the
card against the CPU), the mulmod chain, the DGK Montgomery kernels), the seal
real product and mod switch, the demo on both profiles, the packed pipeline,
the networked entry points, the DGK batch path and protocol, the 2PC
predicates (``secure2pc``: in process and a networked party pair), and the
distributed multiply and the coefficient/row exchange in two gloo ranks
that share the card, an NCCL group of one rank, and the Bloom filter's
kernels (insert, probe, the words' bytes on the wire) against their plain
versions, and the demo at the reference's r = 8192.

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
from pplp_tpu_torch.bfv.rns_decrypt import get_decoder
from pplp_tpu_torch.ops import (behz64_cuda, behz_cuda, bloom_cuda, modmath_cuda, mulmod_chain,
                                ntt, ntt_cuda, pipeline_cuda)
from pplp_tpu_torch.ops.modmath import m31, m62, m62_plain
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
    pipeline_cuda.reset_launches()
    got = fn(*cts, bf.bits_device, bf._salts_device(), bf.table_size)
    torch.cuda.synchronize()
    # The fused route: the six polynomials in two runs (c0 and c1 of the
    # three messages each lie back to back), one combine, one inverse, one decode.
    launched = {k: v for k, v in {**ntt_cuda.launches_by_kernel,
                                  **pipeline_cuda.launches_by_kernel}.items() if v}
    assert launched == {"ntt_forward_u32": 2, "ntt_inverse_u32": 1, "pipe_combine": 1,
                        "pipe_decode": 1}
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


# (xb, yb, s, r): the pipeline's own, and values at the ends of [0, t).
FUSED_BLINDINGS = {"ciphertexts": (1000, 900, 501, 99),
                   "edges": ((1 << 20) - 1, 0, (1 << 20) - 1, (1 << 20) - 2)}


@pytest.fixture(scope="module")
def pipe_env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, 1 << 20, profile="tpu"), dev)
    g = torch.Generator(device=dev).manual_seed(4)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    from pplp_tpu_torch.parallel import pipeline

    bf = pipeline.build_pipeline_filter(1 << 20, 501, 99, 0xA5A5, dev)
    return dict(ctx=ctx, sk=sk, enc=bfv.Encryptor(ctx, pk), gen=g, bf=bf)


def _fused_inputs(env, rows, kind):
    """make_packed_inputs' ciphertexts (c0 and c1 of the three messages back
    to back: two forward launches), or six separate tensors of 0 and q - 1
    (six launches)."""
    from pplp_tpu_torch.parallel import pipeline

    ctx = env["ctx"]
    if kind == "ciphertexts":
        rng = np.random.default_rng(rows)
        xa = rng.integers(900, 1100, rows * ctx.n).astype(np.uint64)
        ya = rng.integers(800, 1000, rows * ctx.n).astype(np.uint64)
        return pipeline.make_packed_inputs(ctx, env["enc"], xa, ya, env["gen"]), 2
    pos = torch.arange(rows * ctx.L * ctx.n, device=ctx.device).reshape(rows, ctx.L, ctx.n)
    e = [torch.where(pos % (i + 2) == 0, ctx.q2 - 1, 0) for i in range(6)]
    return [(e[0], e[1]), (e[2], e[3]), (e[4], e[5])], 6


@pytest.mark.parametrize("kind", ["ciphertexts", "edges"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("rows", [1, 3, 250])
def test_fused_step_matches_plain(pipe_env, rows, packed, kind):
    """The fused route (forward_u32 from the int64 ciphertexts, pipe_combine,
    the inverse, pipe_decode) against the plain torch chain on the same CUDA
    inputs: x, the decoded blind distances and the verdicts, bit for bit,
    with the exact launches of the route."""
    from pplp_tpu_torch.parallel import pipeline

    ctx, sk, bf = pipe_env["ctx"], pipe_env["sk"], pipe_env["bf"]
    values = FUSED_BLINDINGS[kind]
    cts, forwards = _fused_inputs(pipe_env, rows, kind)
    step = pipeline.build_batched_pipeline(ctx, sk, *values, packed=packed)
    ntt_cuda.reset_launches()
    pipeline_cuda.reset_launches()
    x = step(*cts)
    torch.cuda.synchronize()
    assert dict(pipeline_cuda.launches_by_kernel) == {"pipe_combine": 1, "pipe_decode": 0}
    assert ntt_cuda.launches_by_kernel["ntt_forward_u32"] == forwards
    assert ntt_cuda.launches_by_kernel["ntt_inverse"] == 1
    assert x.dtype == torch.int64 and torch.equal(x, step.plain(*cts))
    dec = get_decoder(ctx)
    bd_plain = dec.decode_mod_t_plain(x)
    assert torch.equal(dec.decode_mod_t(x), bd_plain)
    assert torch.equal(dec.decode_mod_t(x.to(torch.int32)), bd_plain)
    if not packed:
        return
    packed_fn = pipeline.build_packed_pipeline(ctx, sk, *values)
    assert torch.equal(packed_fn(*cts), bd_plain)
    assert torch.equal(packed_fn.plain(*cts), bd_plain)
    fn = pipeline.build_packed_pipeline_bf(ctx, sk, *values, 0xA5A5, 16)
    table = (bf.bits_device, bf._salts_device(), bf.table_size)
    assert torch.equal(fn(*cts, *table), fn.plain(*cts, *table))


@pytest.mark.parametrize("t", [1 << 20, 65537, (1 << 29) - 3])
def test_fused_decode_matches_plain(dev, t):
    """pipe_decode on random and edge residues (int64 and u32 in) against
    the plain decode, at a power-of-two t and two odd ones."""
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, t, profile="tpu"), dev)
    x = _residues(ctx.tables, (5,), t % 1000)
    x[0] = ctx.q2 - 1
    x[1, :, :2048] = 0
    dec = get_decoder(ctx)
    want = dec.decode_mod_t_plain(x)
    pipeline_cuda.reset_launches()
    assert torch.equal(dec.decode_mod_t(x), want)
    assert torch.equal(dec.decode_mod_t(x.to(torch.int32)), want)
    assert pipeline_cuda.launches_by_kernel["pipe_decode"] == 2


def test_m62_pipeline_takes_the_plain_route(dev):
    """A seal (m62) chain on the card runs the plain chain: no fused launch,
    and the spans say so."""
    from pplp_tpu_torch.parallel import pipeline
    from pplp_tpu_torch.utils import profiling

    ctx = bfv.BFVContext.build(
        bfv.EncryptionParameters.bfv(4096, 1 << 20, coeff_modulus=bfv_default(4096)), dev)
    assert ctx.tables.profile == "m62"
    g = torch.Generator(device=dev).manual_seed(5)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rng = np.random.default_rng(2)
    xa = rng.integers(900, 1100, ctx.n).astype(np.uint64)
    ya = rng.integers(800, 1000, ctx.n).astype(np.uint64)
    cts = pipeline.make_packed_inputs(ctx, bfv.Encryptor(ctx, pk), xa, ya, g)
    fn = pipeline.build_packed_pipeline(ctx, sk, 1000, 900, 501, 99)
    pipeline_cuda.reset_launches()
    profiling.enable()
    try:
        profiling.drain()
        bd = fn(*cts)
        spans = profiling.drain()
    finally:
        profiling.disable()
    assert {s.name: s.attrs["route"] for s in spans} == {"pipeline.evaluate": "plain",
                                                          "pipeline.decode": "plain"}
    assert not any(pipeline_cuda.launches_by_kernel.values())
    d2 = (xa.astype(np.int64) - 1000) ** 2 + (ya.astype(np.int64) - 900) ** 2
    assert (bd.reshape(-1).cpu().numpy() == (501 * (d2 + 99)) % (1 << 20)).all()


# ---------------------------------------------------------------------------
# The m62 profile's elementwise kernels (csrc/modmath64.cu)
# ---------------------------------------------------------------------------

M62_BOUND = {"mulmod_shoup": 4}  # x < 2^63 there; 4q - 1 is the Harvey butterflies' top
# The second operand's shape against x's: a spectrum [L, n] or a per-limb
# constant [L, 1] under a batch, or both operands batched.
M62_SHAPES = {"batch_by_spectrum": ((3,), ()), "spectrum_by_column": ((), None),
              "batch_by_batch": ((3,), (3,))}


def _m62_operands(op, n, shapes, seed):
    """CPU operands of ``op`` on the seal chain of n: residues drawn below
    the op's input bound with 0, q - 1, 2q - 1 and 4q - 1 (as far as the
    bound goes) in the first slots, Shoup companions floor(w 2^64 / q) of
    w near q (bit 63 set) among them, q and 2q as [L, 1], the ratio words."""
    qs = bfv_default(n)
    L, rng = len(qs), np.random.default_rng(seed)
    x_lead, y_lead = M62_SHAPES[shapes]
    bound = M62_BOUND.get(op, 1)

    def draw(lead, hi_mul, column=False):
        """Residues below hi_mul q, [*lead, L, n] (or a column [*lead, L,
        1]); a row's first slots 0, q // 2 + 1 (its companion has bit 63
        set) and k q - 1 for k = 1, 2, 4 up to hi_mul."""
        cols = 1 if column else n
        rows = int(np.prod(lead, dtype=int))
        v = np.array([[[int(x) % (hi_mul * q)
                        for x in rng.integers(0, 1 << 63, cols, dtype=np.uint64)] for q in qs]
                      for _ in range(rows)], dtype=np.uint64)
        if not column:
            for li, q in enumerate(qs):
                v[:, li, :2] = 0, q // 2 + 1
                for j, k in enumerate(k for k in (1, 2, 4) if k <= hi_mul):
                    v[:, li, 2 + j] = k * q - 1
        return torch.from_numpy(v.view(np.int64).reshape(tuple(lead) + (L, cols)))

    q_col = torch.tensor([[q] for q in qs])
    ratio = tuple(torch.tensor([[((1 << 128) // q >> (32 * i)) & 0xFFFFFFFF] for q in qs])
                  for i in range(3))
    column = y_lead is None
    y_shape = x_lead if column else y_lead
    x = draw(x_lead, bound)
    y = draw(y_shape, 1, column)
    if op == "mulmod_shoup":
        ws = torch.from_numpy(np.array([(int(w) << 64) // qs[(i // y.shape[-1]) % L]
                                        for i, w in enumerate(y.reshape(-1).tolist())],
                                       dtype=np.uint64).view(np.int64)).reshape(y.shape)
        assert (ws < 0).any()  # bit 63 set: read as a u64
        args = (x, y, ws, q_col)
    elif op in ("add", "sub"):
        args = (x, y, q_col)
    elif op == "neg":
        args = (x, q_col)
    elif op == "mulmod":
        args = (x, y, q_col)
    elif op == "reduce128":  # strided word planes of [*lead, 4, L, n], as the sampler reads
        w = torch.from_numpy(rng.integers(0, 1 << 32, tuple(x_lead) + (4, L, n), dtype=np.int64))
        w[..., :2] = 0xFFFFFFFF  # 2^128 - 1 and its neighbours
        w[..., 0, :, 2:4] = 0
        args = (tuple(w[..., i, :, :] for i in range(4)), q_col)
    else:  # shoup_precompute
        args = (x, q_col)
    return args, ratio


def _to(args, dev):
    return tuple(_to(a, dev) if isinstance(a, tuple) else a.to(dev) for a in args)


@pytest.mark.parametrize("shapes", list(M62_SHAPES))
@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("op", list(modmath_cuda.OPS))
def test_m62_kernel_matches_plain(dev, op, n, shapes):
    """Each m62 op on CUDA residues is one launch of its kernel, equal bit
    for bit to the plain chain on the CPU (inputs up to 4q - 1 where the op
    takes them) at the seal chains of n = 4096 and 8192, over every broadcast the stages use."""
    args, ratio = _m62_operands(op, n, shapes, seed=n + len(op))
    want = getattr(m62_plain(ratio), op)(*args)
    before = dict(modmath_cuda.launches_by_kernel)
    got = getattr(m62(_to(ratio, dev)), op)(*_to(args, dev))
    after = dict(modmath_cuda.launches_by_kernel)
    assert got.device == dev and got.dtype == torch.int64 and got.is_contiguous()
    assert torch.equal(got.cpu(), want)
    kernel = modmath_cuda.OPS[op][0]
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kernel) for k in after}


@pytest.mark.parametrize("n", [4096, 8192])
def test_m62_kernels_read_views_and_immediates(dev, n):
    """Operands as the callers pass them: a u64 as (lo, hi) words [B, 1, n]
    under the limbs (``reduce_u64_to_rns``), an expanded view with stride 0
    (``sampling.lift_small``), a strided half of a reshaped row (the plain
    NTT's butterflies), Python ints for q; each equal to the plain chain."""
    qs = bfv_default(n)
    tb = _tables62(n, dev)
    p, pc = tb.prof, m62_plain(tuple(r.cpu() for r in tb.mu_b(1)))
    q2 = tb.q_b(1)
    rng = np.random.default_rng(n)
    lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, (3, 1, n), dtype=np.int64))
              for _ in range(2))
    assert torch.equal(p.reduce_words((lo.to(dev), hi.to(dev)), q2).cpu(),
                       pc.reduce_words((lo, hi), q2.cpu()))
    mag = torch.from_numpy(rng.integers(0, 40, (3, n), dtype=np.int64))
    pos = mag.to(dev).unsqueeze(-2).expand(3, tb.L, n)  # stride 0 over the limbs
    assert pos.stride(1) == 0
    assert torch.equal(p.neg(pos, q2).cpu(), pc.neg(pos.cpu(), q2.cpu()))
    x = _residues(tb, (2,), n)
    half = x.reshape(2, tb.L, 16, 2, n // 32)[..., 1, :]
    w, ws = tb.w[:, 16:32, None], tb.ws[:, 16:32, None]
    assert torch.equal(m62.mulmod_shoup(half, w, ws, tb.q_b(2)).cpu(),
                       m62_plain.mulmod_shoup(half.cpu(), w.cpu(), ws.cpu(), tb.q_b(2).cpu()))
    for q in qs[:2]:
        a = x[:, 0].contiguous() % q
        assert torch.equal(m62.add(a, a, q).cpu(), m62_plain.add(a.cpu(), a.cpu(), q))
    with pytest.raises(ValueError, match="one device"):
        m62.add(x, x.cpu(), q2)


def _seal_demo_stages(ctx, words, values, plains):
    """The demo's kGen, enc and homoCalc on ``ctx`` from injected words:
    the keys, the three ciphertexts' bytes and the blind distance."""
    from pplp_tpu_torch.bfv.serialize import save_ciphertext
    from pplp_tpu_torch.protocol import stages

    s_bits, a_bits, e_bits, u_bits, e0_bits, e1_bits = words
    with torch.no_grad():
        kg = bfv.KeyGenerator.from_bits(ctx, s_bits, a_bits, e_bits)
        sk, pk = kg.secret_key(), kg.create_public_key()
        m_lo = np.stack([p[0] for p in values])
        m_hi = np.stack([p[1] for p in values])
        ct = bfv.Encryptor(ctx, pk).encrypt_pairs_from_bits(m_lo, m_hi, u_bits, e0_bits, e1_bits)
        c = [bfv.Ciphertext((ct.polys[0][i], ct.polys[1][i]), "coeff") for i in range(3)]
        saved = [save_ciphertext(x, ctx) for x in c]
        out = stages.blind_distance(ctx, *c, *plains)
    keys = {"s_ntt": sk.s_ntt, "s_shoup": sk.s_shoup, "pk0_ntt": pk.pk0_ntt,
            "pk1_ntt": pk.pk1_ntt, "pk0_shoup": pk.pk0_shoup, "pk1_shoup": pk.pk1_shoup}
    return keys, ct, saved, out, save_ciphertext(out, ctx)


def test_seal_demo_stages_equal_on_card_and_cpu(dev):
    """The demo's kGen, enc and homoCalc at the cell's shape (seal n = 8192,
    t = 2^56) from one generator seed's words: on the card (the m62
    kernels) and on the CPU (the plain chain) every key leaf, Shoup
    companions included, every ciphertext, its saved bytes and the blind
    distance's bytes are equal."""
    from pplp_tpu_torch.protocol import stages

    parms = bfv.EncryptionParameters.bfv(8192, 1 << 56, coeff_modulus=bfv_default(8192))
    ctx_d, ctx_c = bfv.BFVContext.build(parms, dev), bfv.BFVContext.build(parms, "cpu")
    n, L, t = ctx_c.n, ctx_c.L, ctx_c.t
    g = torch.Generator().manual_seed(20260)
    draw = lambda *shape: torch.randint(0, 1 << 32, shape, generator=g,  # noqa: E731
                                        dtype=torch.int64).numpy()
    words = (draw(n), draw(4, L, n), draw(2, n), draw(3, n), draw(3, 2, n), draw(3, 2, n))
    xa, ya, xb, yb, s, r = 1234, 1212, 1000, 1000, 4099, 77
    values = [stages.plain_pair(v, t, n) for v in (xa * xa + ya * ya, 2 * xa, 2 * ya)]
    plains = [stages.plain_pair(v, t, n) for v in (xb * xb + yb * yb, xb, yb, s, s * r)]
    modmath_cuda.reset_launches()
    card = _seal_demo_stages(ctx_d, words, values, plains)
    assert sum(modmath_cuda.launches_by_kernel.values()) > 0
    cpu = _seal_demo_stages(ctx_c, words, values, plains)
    for leaf in card[0]:
        assert torch.equal(card[0][leaf].cpu(), cpu[0][leaf]), leaf
    for a, b in zip(card[1].polys, cpu[1].polys):
        assert torch.equal(a.cpu(), b)
    assert card[2] == cpu[2]
    for a, b in zip(card[3].polys, cpu[3].polys):
        assert torch.equal(a.cpu(), b)
    assert card[4] == cpu[4]


def test_blind_distance_launches(dev):
    """One ``stages.blind_distance`` at the demo's shape on the card: the
    m62 kernels it launches, exactly, beside two forward transforms and one
    inverse."""
    from pplp_tpu_torch.protocol import stages

    parms = bfv.EncryptionParameters.bfv(8192, 1 << 56, coeff_modulus=bfv_default(8192))
    ctx = bfv.BFVContext.build(parms, dev)
    g = torch.Generator(device=dev).manual_seed(8)
    sk, pk = stages.keygen(ctx, g)
    lo, hi = stages.plain_pair(7, ctx.t, ctx.n)
    ct = stages.encrypt_batch(ctx, pk, np.stack([lo] * 3), np.stack([hi] * 3), g)
    c = [bfv.Ciphertext((ct.polys[0][i], ct.polys[1][i]), "coeff") for i in range(3)]
    plains = [stages.plain_pair(v, ctx.t, ctx.n) for v in (5, 6, 7, 8, 9)]
    torch.cuda.synchronize()
    modmath_cuda.reset_launches()
    ntt_cuda.reset_launches()
    stages.blind_distance(ctx, *c, *plains)
    torch.cuda.synchronize()
    # add_plain twice: two reduce_words, a Shoup product by delta, two adds;
    # the plaintexts' spectra: reduce_words, the centred lift's sub, their
    # companions; six Shoup products by the spectra, two adds and two subs.
    assert modmath_cuda.launches_by_kernel == {
        "m62_add": 6, "m62_sub": 3, "m62_neg": 0, "m62_shoup": 8, "m62_mulmod": 0,
        "m62_reduce128": 5, "m62_shoup_pre": 1}
    assert {k: v for k, v in ntt_cuda.launches_by_kernel.items() if v} == {
        "ntt_forward_u64": 2, "ntt_inverse_u64": 1}


def test_bfv_stage_spans_say_the_cuda_route(dev):
    """On an m62 chain on the card the BFV stages' spans carry route "cuda";
    on the tpu chain (m31), which the kernels do not take, "plain"."""
    from pplp_tpu_torch.protocol import stages
    from pplp_tpu_torch.utils import profiling

    for profile, route in (("seal", "cuda"), ("tpu", "plain")):
        ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, 1 << 20, profile=profile),
                                   dev)
        g = torch.Generator(device=dev).manual_seed(3)
        profiling.enable()
        try:
            profiling.drain()
            modmath_cuda.reset_launches()
            sk, pk = stages.keygen(ctx, g)
            lo, hi = stages.plain_pair(5, ctx.t, ctx.n)
            stages.encrypt_batch(ctx, pk, lo[None], hi[None], g)
            got = {s.name: s.attrs for s in profiling.drain()}
        finally:
            profiling.disable()
        assert got["bfv.keygen"] == got["bfv.encrypt"] == {"route": route}
        assert bool(sum(modmath_cuda.launches_by_kernel.values())) == (route == "cuda")


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


def _np_words(seed, device):
    """A words source for ``secure2pc``: numpy words from one seed, moved to
    ``device`` (two sources of one seed hand out the same words)."""
    rng = np.random.default_rng(seed)
    return lambda shape: torch.from_numpy(rng.integers(0, 1 << 32, tuple(shape))).to(device)


@pytest.mark.parametrize("yao_bug", [False, True])
def test_2pc_predicates_on_card_equal_cpu(dev, yao_bug):
    """Circle and polygon on the card from injected words: the verdicts equal
    the same calls on the CPU, and (correct variant) the clear oracle; the
    Beaver shares equal the CPU's bit for bit."""
    from pplp_tpu_torch.secure2pc import circuits, sharing

    rng = np.random.default_rng(21)
    B = 4096
    x0, y0, x1, y1 = (rng.integers(0, 1 << 15, B) for _ in range(4))
    got = circuits.circle_predicate_2pc(x0, y0, x1, y1, 5000 ** 2, words=_np_words(1, dev),
                                        yao_bug=yao_bug, device=dev)
    want = circuits.circle_predicate_2pc(x0, y0, x1, y1, 5000 ** 2, words=_np_words(1, "cpu"),
                                         yao_bug=yao_bug, device="cpu")
    assert got.is_cuda and torch.equal(got.cpu(), want)
    a, b = [1000, -1000, -1000, 1000], [1000, 1000, -1000, -1000]
    xp, yp = rng.integers(-2000, 2000, B), rng.integers(-2000, 2000, B)
    pgot = circuits.polygon_predicate_2pc(a, b, xp, yp, words=_np_words(2, dev),
                                          yao_bug=yao_bug, device=dev)
    pwant = circuits.polygon_predicate_2pc(a, b, xp, yp, words=_np_words(2, "cpu"),
                                           yao_bug=yao_bug, device="cpu")
    assert pgot.is_cuda and torch.equal(pgot.cpu(), pwant)
    if not yao_bug:
        assert np.array_equal(want.numpy(), circuits.circle_predicate_clear(x0, y0, x1, y1,
                                                                             5000 ** 2))
        assert np.array_equal(pwant.numpy(), circuits.polygon_predicate_clear(a, b, xp, yp))
    x = torch.tensor([0, 1, (1 << 16) + 1, 1 << 31, (1 << 32) - 1] * 7)
    shares = []
    for device in (dev, "cpu"):
        words = _np_words(3, device)
        sx, sy = sharing.share(x.to(device), words), sharing.share(x.flip(0).to(device), words)
        prod = sharing.BeaverDealer(words).mul(sx, sy)
        shares.append((prod.s0.cpu(), prod.s1.cpu(), sharing.reconstruct(prod).cpu()))
    assert all(torch.equal(g, w) for g, w in zip(*shares))
    assert shares[1][2].tolist() == [u * v % (1 << 32) for u, v in zip(x.tolist(),
                                                                      x.flip(0).tolist())]


def test_2pc_party_pair_on_card(dev):
    """A PartyArith pair over a socketpair, both parties on the card; then
    the networked circle (open and yao) reads the oracle."""
    import socket
    import threading

    from pplp_tpu_torch.protocol.transport import Channel
    from pplp_tpu_torch.secure2pc import circuits, networked, ot

    group = ot.SchnorrGroup.generate(pbits=512, qbits=160, seed=3)
    x = np.array([3, 100, 0, 1 << 31, 0xFFFFFFFF], np.int64)
    y = np.array([5, 2, 0xFFFFFFFF, 2, 0xFFFFFFFF], np.int64)
    x0, y0, x1, y1 = [0, 500, -300], [0, 500, 40], [100, -500, -310], [100, 500, 45]

    def run(role, ch):
        pa = networked.PartyArith.setup(ch, role, 5, group, seed=5, device=dev)
        assert all(t.is_cuda for t in pa.triples)
        sx = pa.share_input(x) if role == 0 else pa.share_input()
        sy = pa.share_input(y) if role == 1 else pa.share_input()
        res = [pa.open(pa.mul(sx, sy)).cpu()]
        for compare in ("open", "yao"):
            mine = (x0, y0) if role == 0 else (x1, y1)
            res.append(networked.circle_predicate_2pc_networked(
                ch, role, *mine, 400 ** 2, group, seed=7, compare=compare, device=dev))
        return res

    a, b = socket.socketpair()
    out = {}
    th = threading.Thread(target=lambda: out.update(one=run(1, Channel(b))), daemon=True)
    th.start()
    zero = run(0, Channel(a))
    th.join(120)
    assert not th.is_alive()
    want = [u * v % (1 << 32) for u, v in zip(x.tolist(), y.tolist())]
    oracle = circuits.circle_predicate_clear(x0, y0, x1, y1, 400 ** 2)
    for res in (zero, out["one"]):
        assert res[0].tolist() == want
        assert all(np.array_equal(r, oracle) for r in res[1:])


def test_2pc_refuses_a_missing_card(dev, monkeypatch):
    from pplp_tpu_torch.secure2pc import circuits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        circuits.circle_predicate_2pc([1], [2], [3], [4], 9, device="cuda")


# ---------------------------------------------------------------------------
# Multi-device: gloo ranks sharing the card (parallel/multiproc_smoke.py)
# ---------------------------------------------------------------------------


def _built():
    """Every kernel library built in this process: ranks only load them."""
    from pplp_tpu_torch.ops import cuda_build

    cuda_build.build(sorted(cuda_build.CSRC.glob("*.cu")))


def test_dist_multiplier_two_ranks_on_card(dev):
    """DistMultiplier on coeff = 2 at n = 4096, batch 8, width 2: the
    separate-route kernels on each rank's blocks, bit-exact against the
    single-process FusedMultiplier (the fused kernels)."""
    from pplp_tpu_torch.parallel.multiproc_smoke import launch, seeded_case

    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, 1 << 16, profile="tpu"), dev)
    rlk, c1, c2 = seeded_case(ctx, 5, 8, 2)
    want = torch.stack(FusedMultiplier(ctx, rlk).multiply_relinearize(c1, c2).polys).cpu()
    _built()
    res = launch({"device": "cuda", "jobs": [dict(
        kind="behz", mesh=(1, 1, 2), n=4096, t=1 << 16, moduli=[m.value for m in ctx.moduli],
        seed=5, batch=8, width=2)]}, 2, timeout_s=300)
    got = torch.full(want.shape, -1, dtype=torch.int64)
    for r in res:
        out = r["results"][0]
        got[:, slice(*out["batch"]), :, slice(*out["coeffs"])] = out["out"]
        launches = out["launches"]
        assert all(launches[k] > 0 for k in ("behz_to_bsk", "behz_tensor", "behz_floor_sk",
                                             "behz_lift", "behz_keyprod", "behz_add",
                                             "ntt_forward_u32", "ntt_inverse_u32"))
        assert launches["behz_tensor_ntt"] == launches["behz_relin_ntt"] == 0
    assert torch.equal(got, want)


def test_exchange_round_trip_on_card(dev):
    """The C -> R -> C exchange of CUDA tensors between two ranks (gloo
    takes them as they are), around the rank's NTT kernels: 3 limbs split
    2 + 1; rows, round trip and product against the single-process kernels."""
    from pplp_tpu_torch.parallel.multiproc_smoke import launch

    n = 4096
    tb = ntt.build_tables([Modulus(q) for q in tpu_default(n)[:3]], n, dev)
    x, y = _residues(tb, (2,), 1), _residues(tb, (2,), 2)
    spec = ntt.forward(x, tb).cpu()
    prod = ntt.negacyclic_polymul(x, y, tb).cpu()
    _built()
    res = launch({"device": "cuda", "jobs": [dict(
        kind="ntt", mesh=(1, 1, 2), n=n, moduli=[m.value for m in tb.moduli], x=x.cpu(),
        y=y.cpu())]}, 2, timeout_s=300)
    assert [r["results"][0]["limbs"] for r in res] == [[0, 2], [2, 3]]
    for r in res:
        out = r["results"][0]
        limbs, cs = slice(*out["limbs"]), slice(*out["coeffs"])
        assert torch.equal(out["spec"], spec[:, limbs])
        assert torch.equal(out["back"], x.cpu()[:, :, cs])
        assert torch.equal(out["prod"], prod[:, :, cs])
        assert out["launches"]["ntt_forward"] > 0 and out["launches"]["ntt_inverse"] > 0


def test_nccl_group_of_one_rank_on_card(dev, tmp_path):
    """The NCCL branch of ``initialize_multihost``, ``mesh.transport`` and
    the exchange, in a group of one rank on card 0 (NCCL takes one rank a
    card): a CPU tensor goes to the card for the collective and comes back
    where it was, and the exchange counts itself."""
    import torch.distributed as dist

    from pplp_tpu_torch.parallel import ntt_dist
    from pplp_tpu_torch.parallel.distributed import initialize_multihost
    from pplp_tpu_torch.parallel.mesh import transport

    initialize_multihost("file://" + str(tmp_path / "store"), 1, 0, backend="nccl",
                         timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        x = torch.arange(2 * 3 * 64, dtype=torch.int64)
        assert transport(x).is_cuda and transport(x.to(dev)).is_cuda
        parts = [torch.empty_like(transport(x))]
        dist.all_gather(parts, transport(x))
        assert torch.equal(parts[0].cpu(), x)
        ntt_dist.reset_exchanges(timed=True)
        for t in (x, x.to(dev)):
            back = ntt_dist._all_to_all(t, [t.numel()], [t.numel()], dist.group.WORLD)
            assert back.device == t.device and torch.equal(back.cpu(), x)
        assert ntt_dist.exchanges.calls == 2 and ntt_dist.exchanges.bytes_sent == 0
        assert ntt_dist.exchanges.seconds > 0
    finally:
        ntt_dist.reset_exchanges()
        dist.destroy_process_group()


# --- The Bloom filter's kernels (csrc/bloom.cu) on a packed table ---------

def _bf(dev, count, fpp, mode, cls="BloomFilter"):
    from pplp_tpu_torch import primitives

    p = primitives.BloomParameters(projected_element_count=count, false_positive_probability=fpp,
                                   random_seed=0xA5A5A5A5, index_mode=mode)
    assert p.compute_optimal_parameters()
    return getattr(primitives, cls)(p, device=dev)


def _insert_launches(bf, count, probes=0) -> dict:
    """The launches by kernel of one insert of ``count`` keys into ``bf``:
    the direct kernel once, or count, scatter and apply of the sub-slice
    or the partitioned route once a chunk (``insert_plan``)."""
    from pplp_tpu_torch.ops import bloom_cuda

    plan = bloom_cuda.insert_plan(bf.table_size, bf.salt_count, count)
    return {**dict.fromkeys(bloom_cuda.launches_by_kernel, 0), **plan.launches(),
            "bf_probe": probes}


def _probe_keys(dev, bl, sq, n, seed):
    """n keys of inserted candidates and n of candidates above r^2."""
    from pplp_tpu_torch.primitives.blinding import distance_keys

    g = torch.Generator(device=dev).manual_seed(seed)
    di = torch.cat([torch.randint(0, sq, (n,), generator=g, device=dev),
                    sq + torch.randint(0, 1 << 30, (n,), generator=g, device=dev)])
    return distance_keys(di, bl.s, bl.r, bl.w, bl.w_len)


@pytest.mark.parametrize("radius,mode,fpp", [(4096, "mixed", 1e-12), (4096, "reference", 1e-12),
                                             (8192, "reference", 1e-12), (4096, "mixed", 1e-4)])
def test_bloom_kernels_match_plain_on_the_demo_filters(dev, radius, mode, fpp):
    """The demo's filter (fpp 1e-12, r = 4096 and the reference's r = 8192,
    whose 3,859,468,176 bits need u32 indices: the partitioned insert, 23
    chunks of count, scatter and apply) and the client/server one (fpp
    1e-4, 40.2 MB: the sub-slice route, count, scatter and apply a chunk
    in shared memory): the kernels, making the
    r^2 keys themselves, against blind_distance_keys + index_fill_ on the
    unpacked table: the same serialize() bytes, and the same verdicts on
    100,000 inserted and 100,000 outside keys."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import Blinding, bloom
    from pplp_tpu_torch.primitives.blinding import blind_distance_keys

    sq = radius * radius
    bl = Blinding.for_protocol(56, sq, seed=radius)
    bf = _bf(dev, sq, fpp, mode)
    sizes, salts, mixed = bf._sizes(), bf._salts_device(), mode == "mixed"
    bloom_cuda.reset_launches()
    bf.insert_blind_distances(bl, sq)
    assert bloom_cuda.launches_by_kernel == _insert_launches(bf, sq)
    assert bf.bits_device.dtype == torch.int32 and bf.bits_device.numel() == (bf.table_size + 31) // 32
    assert bf.inserted_element_count == sq
    plain = torch.zeros(bf.table_size, dtype=torch.uint8, device=dev)
    for klo, khi, _ in blind_distance_keys(bl, sq, dev):
        bloom.insert_plain(plain, klo, khi, salts, sizes, mixed)
    packed = bloom.pack_bits(plain).cpu().numpy().tobytes()
    assert bf.serialize() == bf._header_bytes() + packed
    klo, khi = _probe_keys(dev, bl, sq, 100_000, radius)
    got = bf.contains_u64_batch(klo, khi)
    assert bloom_cuda.launches_by_kernel["bf_probe"] == 1
    assert torch.equal(got, bloom.probe_plain(plain, klo, khi, salts, sizes, mixed))
    assert bool(got[:100_000].all())


def test_bloom_kernels_match_plain_on_the_pipeline_filter(dev):
    """BASELINE config[3]'s filter (r = 99, mixed, 187,920 bits: the probe
    stages it in shared memory): keys given as words, and the probe from
    blind distances at the step's 102,400, against the plain version; the
    same probe of a table too large to stage."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.parallel import pipeline
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import blinded_keys

    t, s, r, w = 1 << 20, 501, 99, 0xA5A5
    bloom_cuda.reset_launches()
    bf = pipeline.build_pipeline_filter(t, s, r, w, dev)
    assert bloom_cuda.launches_by_kernel == _insert_launches(bf, r * r)
    assert bloom_cuda.launches_by_kernel["bf_insert"] == 1
    bd_all = s * (torch.arange(r * r, device=dev) + r) % t
    g = torch.Generator(device=dev).manual_seed(3)
    bd = torch.where(torch.rand(102_400, generator=g, device=dev) < 0.5,
                     bd_all[torch.randint(0, r * r, (102_400,), generator=g, device=dev)],
                     torch.randint(0, t, (102_400,), generator=g, device=dev)).reshape(25, 4096)
    large = _bf(dev, 1 << 20, 1e-4, "mixed")
    large.insert_u64_batch(*blinded_keys(bd_all, w, w.bit_length()))
    for other in (bf, large):  # staged in shared memory, then read from device memory
        sizes, salts = other._sizes(), other._salts_device()
        plain = torch.zeros(other.table_size, dtype=torch.uint8, device=dev)
        bloom.insert_plain(plain, *blinded_keys(bd_all, w, w.bit_length()), salts, sizes, True)
        assert other.serialize() == (other._header_bytes()
                                     + bloom.pack_bits(plain).cpu().numpy().tobytes())
        before = bloom_cuda.launches_by_kernel["bf_probe"]
        got = pipeline.bf_probe(bd, w, w.bit_length(), other.bits_device, salts, other.table_size)
        assert bloom_cuda.launches_by_kernel["bf_probe"] == before + 1
        want = bloom.probe_plain(plain, *blinded_keys(bd.reshape(-1), w, w.bit_length()), salts,
                                 sizes, True).reshape(bd.shape)
        assert torch.equal(got, want) and bool(got.any()) and not bool(got.all())


def test_bloom_kernels_on_a_compressed_filter(dev):
    """A CompressibleBloomFilter compressed twice between inserts (a size
    chain of three): bytes and verdicts against the plain version, which
    folds its unpacked table on the card; the set operators on words."""
    from pplp_tpu_torch.primitives import bloom

    rng = np.random.default_rng(5)
    lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, 300_000, dtype=np.uint64)
                               .astype(np.int64)).to(dev) for _ in range(2))
    bf = _bf(dev, 200_000, 1e-4, "mixed", "CompressibleBloomFilter")
    salts = bf._salts_device()
    plain = torch.zeros(bf.table_size, dtype=torch.uint8, device=dev)
    for a, b, cut in ((0, 70_000, 30.0), (70_000, 140_000, 20.0), (140_000, 200_000, None)):
        bf.insert_u64_batch(lo[a:b], hi[a:b])
        bloom.insert_plain(plain, lo[a:b], hi[a:b], salts, bf._sizes(), True)
        if cut:
            assert bf.compress(cut)
            folded = torch.zeros(bf.table_size, dtype=torch.uint8, device=dev)
            folded.index_put_((torch.arange(plain.numel(), device=dev) % bf.table_size,), plain,
                              accumulate=True)
            plain = (folded > 0).to(torch.uint8)
    assert len(bf.size_list) == 3
    assert bf.serialize() == (bf._header_bytes() + bloom.pack_bits(plain).cpu().numpy().tobytes()
                              + bf._tail())
    got = bf.contains_u64_batch(lo, hi)
    assert torch.equal(got, bloom.probe_plain(plain, lo, hi, salts, bf._sizes(), True))
    assert bool(got[:200_000].all())
    # Set algebra on the card's words against the host bytes of the same filters.
    a, b = _bf(dev, 50_000, 1e-3, "mixed"), _bf(dev, 50_000, 1e-3, "mixed")
    a.insert_u64_batch(lo[:30_000], hi[:30_000])
    b.insert_u64_batch(lo[20_000:50_000], hi[20_000:50_000])
    ta, tb = (np.frombuffer(f.serialize(), np.uint8)[-(f.table_size // 8):] for f in (a, b))
    for op, fn in (("__ior__", np.bitwise_or), ("__iand__", np.bitwise_and),
                   ("__ixor__", np.bitwise_xor)):
        c = bloom.BloomFilter.deserialize(a.serialize(), "mixed", device=dev)
        getattr(c, op)(b)
        assert np.array_equal(np.frombuffer(c.serialize(), np.uint8)[-(c.table_size // 8):],
                              fn(ta, tb)), op
    a.clear()
    assert not a.bits_device.any() and not np.frombuffer(a.serialize(), np.uint8)[-100:].any()


def test_bf_message_is_page_locked_and_read_in_place(dev):
    """The w || filter message of a packed filter on the card: one
    page-locked buffer that the table's one copy fills (``bloom.table_to_host``
    records ``pinned`` = 1), with the CPU route's bytes; a second filter's
    own host table (``serialize()``) is one page-locked copy too, with the
    same bytes; the client's ``deserialize`` of the message copies no table
    byte (``copied`` = 0)."""
    import warnings

    from pplp_tpu_torch.primitives import Blinding, BloomFilter
    from pplp_tpu_torch.protocol import ProtocolConfig
    from pplp_tpu_torch.protocol.roles import ProximityServer
    from pplp_tpu_torch.utils import profiling

    cfg = ProtocolConfig(radius=1024, false_positive_probability=1e-4)
    bl = Blinding.for_protocol(56, cfg.sq_radius, seed=24)
    card, own, cpu = (ProximityServer(cfg, d, blinding=bl) for d in (dev, dev, "cpu"))
    for s in (card, own, cpu):
        s.build_bloom_filter()
    assert card.bf.packed and not cpu.bf.packed
    table_bytes = card.bf.table_size // 8
    profiling.enable()
    try:
        message = card.bf_message()
        wire = own.bf.serialize()
        got = BloomFilter.deserialize(memoryview(message)[8:], "mixed", device="cpu")
    finally:
        spans = profiling.drain()
        profiling.disable()
    with warnings.catch_warnings():  # the message is read-only
        warnings.simplefilter("ignore")
        assert torch.from_numpy(np.frombuffer(message, np.uint8)).is_pinned()
    assert message == cpu.bf_message()
    assert wire == bytes(message[8:]) and own.bf.bit_table.flags.writeable
    assert torch.from_numpy(own.bf.bit_table).is_pinned()
    copies = [s.attrs for s in spans if s.name == "bloom.table_to_host"]
    assert copies == [{"bytes": table_bytes, "pinned": 1}] * 2
    assert [s.attrs for s in spans if s.name == "bloom.deserialize"] == [
        {"bytes": len(message) - 8, "copied": 0}]
    assert np.shares_memory(got.bit_table, np.frombuffer(message, np.uint8)) and got == card.bf


def test_bloom_filter_on_card_raises_without_its_kernels(dev, monkeypatch):
    """A filter on the card keeps a packed table, and when the kernel
    library cannot load it raises: nothing falls back to the plain version."""
    from pplp_tpu_torch.ops import bloom_cuda, cuda_build

    from pplp_tpu_torch.primitives import BloomFilter

    with pytest.raises(ValueError, match="packed"):
        BloomFilter(None, device=dev, packed=False)

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_build, "load", no_nvcc)
    bf = _bf(dev, 1000, 1e-4, "mixed")
    keys = torch.arange(10, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="nvcc"):
        bf.insert_u64_batch(keys, keys)
    with pytest.raises(RuntimeError, match="nvcc"):
        bf.contains_u64_batch(keys, keys)
    with pytest.raises(TypeError):  # an unpacked table is not the kernels'
        bloom_cuda.probe_cuda(torch.zeros(bf.table_size, dtype=torch.uint8, device=dev),
                              bf._salts_device(), bf._sizes(), True, keys=(keys, keys))


@pytest.mark.parametrize("xa,near", [(1234, True), (10234, False)])
def test_demo_r8192_on_card(dev, xa, near):
    """The demo at the reference's largest radius (seal, -d 13 -b 56): the
    verdict equals the clear oracle, the filter's 67,108,864 keys go into
    482.4 MB of words through the partitioned insert (23 chunks of count,
    scatter and apply), and the peak device memory stays below the
    unpacked table's 3.86 GB, which is never allocated. The peak is at most
    the same demo's at r = 128 plus two tables' bytes: before the
    partitioned insert it was that plus one table (the words), and the
    insert's stash and histograms are no larger than the table."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    peaks = {}
    for radius in (128, 8192):
        cfg = ProtocolConfig(xa=xa, ya=1212, xb=1000, yb=1000, radius=radius,
                             poly_modulus_degree_bits=13, plain_modulus_bits=56, seed=7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        bloom_cuda.reset_launches()
        res = run_local_demo(cfg, verbose=False, device=dev)
        peaks[radius] = torch.cuda.max_memory_allocated(dev)
    assert res.is_near is near
    assert ((xa - 1000) ** 2 + 212 ** 2 < 8192 ** 2) is near
    plan = bloom_cuda.insert_plan(res.bf_table_bits, 40, 8192 ** 2)
    assert plan.route == "partitioned" and plan.chunks == 23
    assert bloom_cuda.launches_by_kernel == {**dict.fromkeys(bloom_cuda.launches_by_kernel, 0),
                                             "bf_insert_count": 23, "bf_insert_scatter": 23,
                                             "bf_insert_apply": 23}
    assert res.bf_table_bits == 3_859_468_176 and res.bf_device.type == "cuda"
    table = 4 * bloom_cuda.words_for(res.bf_table_bits)
    assert peaks[8192] < res.bf_table_bits, f"peak {peaks}: the unpacked table was allocated"
    assert peaks[8192] <= peaks[128] + 2 * table, f"peaks {peaks}, table {table} B"


def test_partitioned_insert_just_above_one_slice(dev):
    """A table just above one slice (2^SLICE_LOG2 + 1,000 bits: a ragged
    last bucket of 1,000 bits) and a key count that is not a multiple of
    the chunk: the partitioned kernels' words equal the direct kernel's and
    the plain version's bytes, with given keys and with a blinded range
    from a start above 0, in both index modes; launches 3 a chunk."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import distance_keys

    bits = (1 << bloom_cuda.SLICE_LOG2) + 1000
    salts = torch.tensor(bloom._PREDEF_SALT[:13], dtype=torch.int64, device=dev)
    plan = bloom_cuda.insert_plan(bits, 13, 1, route="partitioned")
    count = 3 * plan.chunk_keys + 12_345
    rng = np.random.default_rng(16)
    lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, count, dtype=np.uint64)
                               .astype(np.int64)).to(dev) for _ in range(2))
    bl = (0x3FFFFFFB, 0x12345, 0xBEEF, 16, 1000, count)
    for mixed in (True, False):
        for kw, (klo, khi) in ((dict(keys=(lo, hi)), (lo, hi)),
                               (dict(blinded=bl),
                                distance_keys(torch.arange(1000, 1000 + count, device=dev),
                                              *bl[:4]))):
            words = torch.zeros(bloom_cuda.words_for(bits), dtype=torch.int32, device=dev)
            direct = torch.zeros_like(words)
            bloom_cuda.reset_launches()
            bloom_cuda.insert_partitioned(words, salts, (bits,), mixed, **kw)
            assert bloom_cuda.launches_by_kernel == {
                **dict.fromkeys(bloom_cuda.launches_by_kernel, 0), "bf_insert_count": 4,
                "bf_insert_scatter": 4, "bf_insert_apply": 4}
            bloom_cuda.insert_direct(direct, salts, (bits,), mixed, **kw)
            plain = torch.zeros(bits, dtype=torch.uint8, device=dev)
            bloom.insert_plain(plain, klo, khi, salts, (bits,), mixed)
            assert torch.equal(words, direct)
            assert torch.equal(words.view(torch.uint8)[:bits // 8], bloom.pack_bits(plain))


# --- The sub-slice insert (bf_insert_sub_count / _scatter / _apply) ---

def _sub_case(dev, case):
    """(sizes, salts, mixed, key kwargs, (klo, khi), words before the
    insert, insert_subslice kwargs) of a card test's case."""
    from pplp_tpu_torch.parallel import pipeline
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.primitives.blinding import blinded_keys, distance_keys

    rng = np.random.default_rng(18)
    if case in ("client/server", "client/server, prefilled, stash 1x, 2^20",
                "client/server, reference mode", "zero keys"):
        mode = "reference" if "reference" in case else "mixed"
        bf = _bf(dev, 4096 * 4096, 1e-4, mode)
        sq = 0 if case == "zero keys" else 4096 * 4096
        bl = Blinding.for_protocol(56, max(sq, 1), seed=18)
        start = 1000 if "prefilled" in case else 0
        kw = dict(blinded=(bl.s, bl.r, bl.w, bl.w_len, start, sq))
        keys = distance_keys(torch.arange(start, start + sq, device=dev), bl.s, bl.r, bl.w,
                             bl.w_len)
        words = torch.zeros_like(bf.bits_device)
        if "prefilled" in case:
            words = _probe_table(dev, bf.table_size, 13, 0.3, 18)
        opts = dict(slice_log2=20, stash_factor=1) if "stash 1x" in case else {}
        return bf._sizes(), bf._salts_device(), mode == "mixed", kw, keys, words, opts
    if case == "config[3], 2^14":
        t, s, r, w = 1 << 20, 501, 99, 0xA5A5
        bf = pipeline.build_pipeline_filter(t, s, r, w, dev)
        keys = blinded_keys(s * (torch.arange(r * r, device=dev) + r) % t, w, w.bit_length())
        return (bf._sizes(), bf._salts_device(), True, dict(keys=keys), keys,
                torch.zeros_like(bf.bits_device), dict(slice_log2=14))
    assert case == "compressed, a chain of three"
    bf = _bf(dev, 200_000, 1e-4, "mixed", "CompressibleBloomFilter")
    assert bf.compress(30.0) and bf.compress(20.0) and len(bf.size_list) == 3
    keys = tuple(torch.from_numpy(rng.integers(0, 1 << 32, 66_667, dtype=np.uint64)
                                  .astype(np.int64)).to(dev) for _ in range(2))
    return (bf._sizes(), bf._salts_device(), True, dict(keys=keys), keys,
            torch.zeros_like(bf.bits_device), dict(slice_log2=16))


SUB_CASES = ("client/server", "client/server, prefilled, stash 1x, 2^20",
             "client/server, reference mode", "config[3], 2^14", "compressed, a chain of three",
             "zero keys")


@pytest.mark.parametrize("case", SUB_CASES)
def test_subslice_insert_matches_plain_and_direct(dev, case):
    """The sub-slice route (``insert_subslice``) on the client/server
    filter (40.2 MB, 13 salts, 16.8M keys made in the kernels; 614 buckets
    of 2^19 bits, or 307 of 2^20 at a 1x stash: 22 chunks), on a table
    that already holds bits, in both index modes, on config[3]'s table
    (sub-slices of 2^14 bits), on a compressed filter's chain of three
    sizes and with no key: its words equal the direct kernel's and the
    plain insert's bytes, the last word's bits above the table size as
    they were, and it launches count, scatter and apply once a chunk."""
    from pplp_tpu_torch.primitives import bloom

    sizes, salts, mixed, kw, (klo, khi), before, opts = _sub_case(dev, case)
    bits = sizes[-1]
    plan = bloom_cuda.insert_plan(bits, salts.numel(), klo.numel(), route="subslice", **opts)
    if case.startswith("client/server"):
        assert plan.buckets == (307 if "2^20" in case else 614)
    words, direct = before.clone(), before.clone()
    bloom_cuda.reset_launches()
    bloom_cuda.insert_subslice(words, salts, sizes, mixed, **kw, **opts)
    assert bloom_cuda.launches_by_kernel == {**dict.fromkeys(bloom_cuda.launches_by_kernel, 0),
                                             **plan.launches()}
    bloom_cuda.insert_direct(direct, salts, sizes, mixed, **kw)
    plain = bloom.unpack_words(before, bits)
    bloom.insert_plain(plain, klo, khi, salts, sizes, mixed)
    assert torch.equal(words, direct)
    assert torch.equal(words.view(torch.uint8)[:bits // 8], bloom.pack_bits(plain)[:bits // 8])
    if bits % 32:
        top = (1 << 32) - (1 << (bits % 32))
        assert int(words[-1]) & top == int(before[-1]) & top
    if klo.numel() == 0:
        assert torch.equal(words, before) and not any(bloom_cuda.launches_by_kernel.values())


def test_client_server_session_in_two_processes(dev):
    """The benchmark's client/server deployment at its size (seal n = 8192,
    t = 2^56, r = 4096, fpp 1e-4): the server's filter of 16.7M keys and 13
    salts takes the sub-slice route, and one opt session between a server
    process on the card (``pplp_bench/entries/client_server.py``) and a
    client here, over loopback TCP, gives the plain reference's blind
    distance, verdict and w || filter frame, its 128-byte header included."""
    import json
    import types
    from pathlib import Path

    from pplp_bench.entries import client_server as cs
    from pplp_bench.reference import bloom as ref_bloom
    from pplp_bench.reference import frames
    from pplp_bench.reference import proximity as ref
    from pplp_bench.traffic import DemoTraffic

    bench = Path(__file__).resolve().parents[1] / "pplp_bench"
    config = json.loads((bench / "configs" / "cs-seal-d13.json").read_text())
    mix = json.loads((bench / "traffic" / "cs-r4096-half-near.json").read_text())
    radius, t = mix["radius"], 1 << config["plain_modulus_bits"]
    salts, bits = ref_bloom.optimal_parameters(radius * radius, config["false_positive_probability"])
    assert (salts, bits) == (13, 321668808)
    assert bloom_cuda.insert_plan(bits, salts, radius * radius).route == "subslice"
    session = types.SimpleNamespace(device=dev, config=config, mix=mix,
                                    spans=types.SimpleNamespace(ranges=False, current={}))
    state = cs.State(DemoTraffic(mix, config["plain_modulus_bits"], 2**31 + 9), None)
    state.server = cs.Server(session)
    tests = [state.traffic.test(i) for i in range(2)]
    try:
        runs = [cs.run_session(session, state, None, test, cs.WARM_TIMEOUT_S) for test in tests]
    finally:
        if state.chan is not None:
            state.chan.close()
        state.server.stop()
    assert not state.server.proc.is_alive()
    assert {test.near for test in tests} == {True, False}
    for test, run in zip(tests, runs):
        want = ref.demo_test(test, radius, t, config["false_positive_probability"],
                             config["bf_seed"], True, dev, wire=True)
        assert run.client.blind_distance == want["blind_distance"]
        assert run.client.is_near == want["near"] == test.near
        header, payload = run.bf_frame
        assert len(payload) == 40_208_705
        assert header + payload == frames.frame(want["wire"])


def test_subslice_steps_and_refusals(dev):
    """Each sub-slice kernel's step on one chunk of the client/server
    filter's keys (``sub_count_cuda``, ``sub_scatter_cuda``,
    ``sub_apply_cuda``): the totals are a bincount of idx >> 19, the
    offsets their exclusive scan, the stash the chunk's indices with each
    sub-slice's run in its range, and the table after the apply the
    plain version's; the route raises on a plan it cannot take and on a
    table whose storage is not 16-byte aligned."""
    from pplp_tpu_torch.primitives import Blinding, bloom
    from pplp_tpu_torch.primitives.blinding import distance_keys

    bf = _bf(dev, 4096 * 4096, 1e-4, "mixed")
    sizes, salts, bits = bf._sizes(), bf._salts_device(), bf.table_size
    plan = bloom_cuda.insert_plan(bits, 13, 4096 * 4096, route="subslice", stash_factor=1)
    n = plan.chunk_keys
    bl = Blinding.for_protocol(56, 4096 * 4096, seed=5)
    blinded = (bl.s, bl.r, bl.w, bl.w_len, 0, n)
    words = torch.zeros_like(bf.bits_device)
    stash, counts = bloom_cuda.subslice_buffers(plan, dev)
    bloom_cuda.sub_count_cuda(words, salts, sizes, True, plan, counts[0], blinded=blinded)
    bloom_cuda.sub_scatter_cuda(words, salts, sizes, True, plan, counts[0], stash,
                                blinded=blinded)
    bloom_cuda.sub_apply_cuda(words, salts, sizes, plan, counts[0], stash)
    klo, khi = distance_keys(torch.arange(n, device=dev), bl.s, bl.r, bl.w, bl.w_len)
    idx = bloom._indices(klo, khi, salts, sizes, True).reshape(-1)
    nb = plan.buckets
    totals = torch.bincount(idx >> plan.slice_log2, minlength=nb)
    got = counts[0].to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got[:nb], totals) and torch.equal(got[nb:2 * nb], totals)
    assert torch.equal(got[2 * nb:], torch.cumsum(totals, 0) - totals)
    flat = stash.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(torch.sort(flat).values, torch.sort(idx).values)
    assert bool((flat[1:] >> plan.slice_log2 >= flat[:-1] >> plan.slice_log2).all())
    plain = torch.zeros(bits, dtype=torch.uint8, device=dev)
    plain.index_fill_(0, idx, 1)
    assert torch.equal(words.view(torch.uint8)[:bits // 8], bloom.pack_bits(plain))
    with pytest.raises(ValueError, match="whole sub-slice"):
        bloom_cuda.insert_subslice(torch.zeros(100, dtype=torch.int32, device=dev), salts,
                                   (3200,), True, blinded=blinded)
    store = torch.zeros(words.numel() + 1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="bf_insert_sub_apply"):
        bloom_cuda.insert_subslice(store[1:], salts, sizes, True, blinded=blinded)


# --- The probe's routes and edges (bf_probe: staged, device memory) ---

def _probe_table(dev, bits, n_salts, density, seed, offset=0):
    """A packed table of ``bits`` bits, each set with probability
    ``density`` (default: the one that leaves ~30% of keys present at
    ``n_salts`` salts), ``offset`` words into its storage."""
    from pplp_tpu_torch.primitives import bloom

    rng = np.random.default_rng(seed)
    p = 0.3 ** (1 / n_salts) if density is None else density
    packed = np.packbits(rng.random(bits) < p, bitorder="little")
    words = bloom.words_of_bytes(packed, dev)[:bloom_cuda.words_for(bits)]
    if offset:
        store = torch.zeros(words.numel() + offset, dtype=torch.int32, device=dev)
        store[offset:] = words
        words = store[offset:]
    return words


def _probe_against_plain(dev, words, bits, n_salts, count, seed, sizes=None, mixed=True):
    from pplp_tpu_torch.primitives import bloom

    sizes = sizes or (bits,)
    salts = torch.tensor(bloom._PREDEF_SALT[:n_salts], dtype=torch.int64, device=dev)
    rng = np.random.default_rng(seed + 1)
    lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, count, dtype=np.uint64)
                               .astype(np.int64)).to(dev) for _ in range(2))
    bloom_cuda.reset_launches()
    got = bloom_cuda.probe_cuda(words, salts, sizes, mixed, keys=(lo, hi))
    assert bloom_cuda.launches_by_kernel["bf_probe"] == 1
    want = bloom.probe_plain(bloom.unpack_words(words, sizes[-1]), lo, hi, salts, sizes, mixed)
    assert torch.equal(got, want)
    return got


_STAGE = bloom_cuda.STAGE_WORDS
PROBE_EDGES = {  # name: (table bits, salts, keys, density, offset in words)
    "staged 1 mod 4": (32 * 4001 - 5, 13, 100_003, None, 0),
    "staged 2 mod 4": (32 * 4002, 13, 100_003, None, 0),
    "staged 3 mod 4": (32 * 4003 - 31, 13, 1025, None, 0),
    "config[3] words": (187_920, 13, 102_400, None, 0),
    "exactly the stage": (32 * _STAGE, 13, 50_001, None, 0),
    "one word past the stage": (32 * _STAGE + 1, 13, 50_001, None, 0),
    "staged, storage not 16-byte aligned": (32 * 4001, 13, 30_000, None, 1),
    "device, storage not 16-byte aligned": (32 * 40_001, 13, 30_000, None, 1),
    "one key, staged": (100_000, 13, 1, None, 0),
    "one key, device": (10_000_000, 40, 1, None, 0),
    "all ones, staged": (100_000, 40, 3333, 1.0, 0),
    "all ones, device": (10_000_003, 40, 3333, 1.0, 0),
    "all zero, staged": (100_000, 13, 3333, 0.0, 0),
    "all zero, device": (10_000_003, 13, 3333, 0.0, 0),
    **{f"{s} salts, staged": (150_000, s, 20_000, None, 0) for s in (1, 13, 40, 128)},
    **{f"{s} salts, device": (20_000_000, s, 20_000, None, 0) for s in (1, 13, 40, 128)},
}


@pytest.mark.parametrize("case", list(PROBE_EDGES))
def test_probe_edges_match_plain(dev, case):
    """``bf_probe`` on both routes and at their edges (word counts 1, 2
    and 3 mod 4, exactly ``STAGE_WORDS`` words and one past them, storage
    that is not 16-byte aligned, one key, key counts that are not a
    multiple of the block, tables all set and all clear, 1, 13, 40 and 128
    salts): the verdicts equal ``probe_plain``'s, in one launch."""
    bits, n_salts, count, density, offset = PROBE_EDGES[case]
    words = _probe_table(dev, bits, n_salts, density, bits % 1009, offset)
    assert (words.data_ptr() % 16 != 0) == (offset != 0)
    got = _probe_against_plain(dev, words, bits, n_salts, count, bits % 1013)
    if density is not None:
        assert bool(got.all()) if density == 1.0 else not bool(got.any())
    elif count > 1000:
        assert 0 < int(got.sum()) < count


@pytest.mark.parametrize("w_len,bits", [(1, 187_920), (31, 187_920), (1, 10_000_000),
                                        (31, 10_000_000)])
def test_probe_blind_distances_at_w_len_edges(dev, w_len, bits):
    """The blind-distance source at w_len 1 and 31, staged and from device
    memory, on a [25, 4096] batch read in place: the verdicts are
    ``probe_plain``'s of ``blinded_keys`` and shaped like the batch."""
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import blinded_keys

    w = (1 << w_len) - 1
    words = _probe_table(dev, bits, 13, None, w_len)
    salts = torch.tensor(bloom._PREDEF_SALT[:13], dtype=torch.int64, device=dev)
    g = torch.Generator(device=dev).manual_seed(w_len)
    bd = torch.randint(0, 1 << 32, (25, 4096), generator=g, device=dev)
    bloom_cuda.reset_launches()
    got = bloom.probe(words, salts, bits, True, blind_distances=(bd, w, w_len))
    assert bloom_cuda.launches_by_kernel["bf_probe"] == 1 and got.shape == bd.shape
    want = bloom.probe_plain(bloom.unpack_words(words, bits), *blinded_keys(bd.reshape(-1), w,
                                                                           w_len), salts, (bits,),
                             True)
    assert torch.equal(got.reshape(-1), want) and 0 < int(got.sum()) < got.numel()


def test_probe_follows_a_compressed_chain(dev):
    """A compressed filter's probe before and after ``compress``: the chain
    that the wrapper checked and cached for the old sizes gives way to the
    new list, and the verdicts equal ``probe_plain``'s on the folded table
    each time."""
    from pplp_tpu_torch.primitives import bloom

    rng = np.random.default_rng(17)
    lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, 60_000, dtype=np.uint64)
                               .astype(np.int64)).to(dev) for _ in range(2))
    bf = _bf(dev, 40_000, 1e-4, "mixed", "CompressibleBloomFilter")
    bf.insert_u64_batch(lo[:40_000], hi[:40_000])
    salts = bf._salts_device()
    for cut in (None, 30.0, 20.0):
        if cut:
            assert bf.compress(cut)
        sizes = bf._sizes()
        assert bloom_cuda.chain_array(sizes).tolist() == list(sizes)
        bloom_cuda.reset_launches()
        got = bf.contains_u64_batch(lo, hi)
        assert bloom_cuda.launches_by_kernel["bf_probe"] == 1
        plain = bloom.unpack_words(bf.bits_device, bf.table_size)
        assert torch.equal(got, bloom.probe_plain(plain, lo, hi, salts, sizes, True))
        assert bool(got[:40_000].all())
    assert len(bf.size_list) == 3


def test_probe_launch_floor_is_not_a_probe(dev):
    """The empty kernel at the probe's geometry launches on both routes and
    counts no ``bf_probe`` launch."""
    bloom_cuda.reset_launches()
    for bits in (187_920, 10_000_000):
        words = torch.zeros(bloom_cuda.words_for(bits), dtype=torch.int32, device=dev)
        bloom_cuda.probe_floor_cuda(words, 102_400)
    torch.cuda.synchronize()
    assert not any(bloom_cuda.launches_by_kernel.values())
