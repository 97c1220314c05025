"""A numpy model of ``csrc/pipeline.cu`` (the packed step's combine and
decode kernels) in u32 words, against the plain torch chain and the
reference, and the fused route's dispatch rule.

The model does what each kernel thread does, op for op: u32 words held in
uint64, ``__umulhi`` as the high half of a uint64 product, every wrapping
u32 difference masked to 32 bits. It reads the arrays the wrapper packs
(``pipeline_cuda.combine_constants``, ``decode_constants``) in the planes'
order of the kernel, so a change to the kernel's arithmetic or layout
changes this model with it. At N = 256 and the chain of
``tests/test_torch_pipeline.py`` (two 28-bit and two 27-bit primes), every
value is held equal, bit for bit, to ``build_batched_pipeline``'s plain
step, ``RnsDecoder.decode_mod_t_plain`` and the reference's
``pplp_tpu.parallel.pipeline`` step and ``RnsDecoder``: random residues and
edge residues (0 and q - 1 in every polynomial), 1 and 3 rows, packed and
not, and blinding values at the ends of [0, t).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import N, T, _ctx_pair, _np

from pplp_tpu.bfv.keys import make_sk_pk_jit
from pplp_tpu.bfv.rns_decrypt import RnsDecoder as RRnsDecoder
from pplp_tpu.parallel import pipeline as rpipe
from pplp_tpu_torch.bfv.keys import keys_from_reference
from pplp_tpu_torch.bfv.rns_decrypt import RnsDecoder, get_decoder
from pplp_tpu_torch.ops import ntt, pipeline_cuda
from pplp_tpu_torch.ops.primes import get_primes
from pplp_tpu_torch.parallel import pipeline
from pplp_tpu_torch.utils import profiling

U32 = np.uint64(0xFFFFFFFF)
CHAIN = list(get_primes(28, 2, N)) + list(get_primes(27, 2, N))
# (xb, yb, s, r): the pipeline's own, and values at the ends of [0, t).
BLINDINGS = {"baseline": (1000, 900, 501, 99), "ends": (T - 1, 0, T - 1, T - 2),
             "ends2": (0, T - 1, 1, T - 1)}


# --- the model -------------------------------------------------------------

def _csub(x, q):
    return np.where(x >= q, x - q, x)


def _add(a, b, q):
    return _csub((a + b) & U32, q)


def _sub(a, b, q):
    return np.where(a >= b, a - b, (a + q - b) & U32)


def _mul_shoup(x, w, ws, q):
    """w x mod q: (w x - umulhi(ws, x) q) in wrapping u32, one subtract."""
    est = (ws * x) >> np.uint64(32)
    return _csub((w * x - est * q) & U32, q)


def model_combine(spec, consts, q):
    """``pipe_combine_kernel`` on u32 spectra [6, ..., L, n] (c1_0, c2_0,
    c3_0, c1_1, c2_1, c3_1), the constant planes [10, L, n] and q [L]."""
    spec, k = spec.astype(np.uint64), consts.astype(np.uint32).astype(np.uint64)
    q = np.asarray(q, np.uint64)[:, None]
    z, sr, xb, xbs, yb, ybs, s, ss, sk, sks = k
    acc0 = _sub(_add(spec[0], z, q),
                _add(_mul_shoup(spec[1], xb, xbs, q), _mul_shoup(spec[2], yb, ybs, q), q), q)
    acc1 = _sub(spec[3],
                _add(_mul_shoup(spec[4], xb, xbs, q), _mul_shoup(spec[5], yb, ybs, q), q), q)
    val = _add(_mul_shoup(acc0, s, ss, q),
               _mul_shoup(_mul_shoup(acc1, s, ss, q), sk, sks, q), q)
    return _add(val, sr, q)


def model_decode(x, limbs, scalars):
    """``pipe_decode_kernel`` on residues x [..., L, n] -> int64 [..., n]."""
    x = np.asarray(x).astype(np.uint64)
    w = limbs.astype(np.uint32).astype(np.uint64)
    t, g, g_mod_t, inv, inv_s = (np.uint64(v) for v in scalars)
    st = np.zeros(x.shape[:-2] + x.shape[-1:], np.uint64)
    sg = np.zeros_like(st)
    for i in range(w.shape[0]):
        q, y_w, y_s, ct, ct_s, cg, cg_s = w[i]
        y = _mul_shoup(x[..., i, :], y_w, y_s, q)
        st = _add(st, _mul_shoup(y, ct, ct_s, t), t)
        sg = _add(sg, _mul_shoup(y, cg, cg_s, g), g)
    d = _sub(st, sg % t, t)
    d = np.where(sg > g // np.uint64(2), _add(d, g_mod_t, t), d)
    return _mul_shoup(d, inv, inv_s, t).astype(np.int64)


# --- fixtures ----------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    jctx, ctx = _ctx_pair(CHAIN)
    rsk, rpk = make_sk_pk_jit(jctx, 33)
    sk, _ = keys_from_reference(
        ctx, _np(rsk.s_ntt), _np(rsk.s_shoup), _np(rpk.pk0_ntt), _np(rpk.pk1_ntt),
        _np(rpk.pk0_shoup), _np(rpk.pk1_shoup))
    steps = {}

    def ref_step(values, packed):  # each reference step jitted once
        if (values, packed) not in steps:
            steps[values, packed] = jax.jit(rpipe.build_batched_pipeline(
                jctx, rsk, *values, packed=packed))
        return steps[values, packed]

    return dict(jctx=jctx, ctx=ctx, rsk=rsk, sk=sk, ref_step=ref_step,
                ref_decode=jax.jit(RRnsDecoder(jctx).decode_mod_t))


def _residues(ctx, rows, kind, seed):
    """Six polynomials [rows, L, n]: random residues, or 0 and q - 1 in
    runs of 1 to 6 coefficients (every polynomial holds both in every limb)."""
    qs = np.array([m.value for m in ctx.moduli], np.int64)[:, None]
    rng = np.random.default_rng(seed)
    polys = []
    for i in range(6):
        if kind == "random":
            p = rng.integers(0, 1 << 62, (rows, ctx.L, ctx.n)) % qs
        else:
            top = (np.arange(ctx.n)[None, None, :] // (1 + i) + np.arange(rows)[:, None, None]) % 2
            p = top * (qs - 1)
        polys.append(p.astype(np.int64))
    return polys


def _model_x(ctx, sk, polys, blinding, packed):
    """x by the model: the plain forward transforms, the model's combine on
    the packed constants, the plain inverse."""
    tb = ctx.tables
    z, sr, m_ntt, m_shoup = pipeline.step_constants(ctx, *blinding, packed)
    consts = pipeline_cuda.combine_constants(tb, z, sr, m_ntt, m_shoup, sk.s_ntt, sk.s_shoup)
    order = [0, 2, 4, 1, 3, 5]  # (c1_0, c1_1, c2_0, ...) -> the kernel's planes
    spec = np.stack([ntt.forward_plain(torch.from_numpy(polys[i]), tb).numpy() for i in order])
    val = model_combine(spec, consts.numpy(), [m.value for m in ctx.moduli])
    return ntt.inverse_plain(torch.from_numpy(val.astype(np.int64)), tb)


# --- the model against the plain chain and the reference -----------------------

@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("rows,blinding", [(1, "baseline"), (3, "ends"), (3, "ends2")])
def test_model_step_matches_plain_and_reference(env, kind, packed, rows, blinding):
    ctx, sk = env["ctx"], env["sk"]
    values = BLINDINGS[blinding]
    polys = _residues(ctx, rows, kind, seed=rows + sum(values) % 1000)
    cts = [(torch.from_numpy(polys[2 * m]), torch.from_numpy(polys[2 * m + 1]))
           for m in range(3)]
    plain = pipeline.build_batched_pipeline(ctx, sk, *values, packed=packed).plain(*cts)
    got = _model_x(ctx, sk, polys, values, packed)
    assert torch.equal(got, plain)
    ref_cts = [tuple(jnp.asarray(p.astype(np.uint32)) for p in pair) for pair in
               [(polys[2 * m], polys[2 * m + 1]) for m in range(3)]]
    want = env["ref_step"](values, packed)(*ref_cts)
    assert (got.numpy() == _np(want)).all()
    # The decode of the same values, by the model, the plain chain and the reference.
    dec = get_decoder(ctx)
    bd = model_decode(got.numpy(), *_decode_consts(dec))
    assert (bd == dec.decode_mod_t_plain(got).numpy()).all()
    rdec = env["ref_decode"](jnp.asarray(got.numpy().astype(np.uint32)))
    assert (bd == _np(rdec)).all()


def _decode_consts(dec: RnsDecoder):
    limbs, scalars = dec.kernel_constants
    return limbs.numpy(), scalars


@pytest.mark.parametrize("t", [T, 65537, (1 << 29) - 3, 3])
def test_model_decode_matches_plain_and_reference(t):
    jctx, ctx = _ctx_pair(CHAIN, t=t)
    qs = np.array([m.value for m in ctx.moduli], np.uint64)[:, None]
    rng = np.random.default_rng(t % 1000)
    x = rng.integers(0, 1 << 62, (3, ctx.L, ctx.n), dtype=np.uint64) % qs
    x[0] = qs - np.uint64(1)
    x[1, :, : ctx.n // 2] = 0
    dec = RnsDecoder(ctx)
    got = model_decode(x, *_decode_consts(dec))
    assert (got == dec.decode_mod_t_plain(torch.from_numpy(x.astype(np.int64))).numpy()).all()
    want = jax.jit(RRnsDecoder(jctx).decode_mod_t)(jnp.asarray(x.astype(np.uint32)))
    assert (got == _np(want)).all()


def test_decode_constants_match_the_decoder(env):
    """The kernel's table holds the plain decode's constants, each beside
    floor(c 2^32 / m) for its modulus m."""
    dec = get_decoder(env["ctx"])
    limbs, (t, g, g_mod_t, inv, inv_s) = _decode_consts(dec)
    limbs = limbs.astype(np.uint32).astype(object)
    qs = [m.value for m in env["ctx"].moduli]
    assert list(limbs[:, 0]) == qs
    assert list(limbs[:, 1]) == dec.ymul[0].reshape(-1).tolist()
    assert list(limbs[:, 2]) == dec.ymul[1].reshape(-1).tolist()
    assert list(limbs[:, 3]) == dec.c_t.reshape(-1).tolist()
    assert list(limbs[:, 5]) == dec.c_g.reshape(-1).tolist()
    for c, cs, m in [(3, 4, t), (5, 6, g)]:
        assert all(int(s) == (int(v) << 32) // m for v, s in zip(limbs[:, c], limbs[:, cs]))
    assert (t, g, g_mod_t, inv) == (T, dec.gamma, dec.gamma % T, dec.inv_gamma)
    assert inv_s == (inv << 32) // t


def test_decoder_without_kernel_constants_on_m62():
    _, ctx = _ctx_pair(list(get_primes(36, 2, N)) + list(get_primes(37, 1, N)))
    assert RnsDecoder(ctx).kernel_constants is None


# --- the forward transforms' runs -------------------------------------------------

def test_forward_runs():
    """Back-to-back polynomials of one storage make one run (one forward
    launch): make_packed_inputs' ciphertexts two, separate tensors one each."""
    L, n, rows = 4, 8, 3
    c0, c1 = torch.zeros(3, rows, L, n, dtype=torch.int64), torch.ones(3, rows, L, n,
                                                                       dtype=torch.int64)
    polys = (c0[0], c0[1], c0[2], c1[0], c1[1], c1[2])
    runs = pipeline_cuda.forward_runs(polys)
    assert [s for s, _ in runs] == [0, 3]
    for (start, run), base in zip(runs, (c0, c1)):
        assert run.shape == (3 * rows, L, n) and run.is_contiguous()
        assert run.data_ptr() == base.data_ptr()
        assert torch.equal(run, base.reshape(3 * rows, L, n))
    apart = [torch.full((rows, L, n), i, dtype=torch.int64) for i in range(6)]
    assert [s for s, _ in pipeline_cuda.forward_runs(apart)] == list(range(6))
    one = torch.arange(6 * rows * L * n, dtype=torch.int64).reshape(6, rows, L, n)
    (start, run), = pipeline_cuda.forward_runs(list(one))
    assert start == 0 and torch.equal(run, one.reshape(6 * rows, L, n))
    # Out of order: no run across them; a strided view: a copy, alone.
    assert [s for s, _ in pipeline_cuda.forward_runs([one[1], one[0], one[2]])] == [0, 1, 2]
    wide = torch.arange(rows * L * 2 * n, dtype=torch.int64).reshape(rows, L, 2 * n)
    runs = pipeline_cuda.forward_runs([one[0], wide[:, :, ::2], one[1]])
    assert [s for s, _ in runs] == [0, 1, 2]
    assert torch.equal(runs[1][1], wide[:, :, ::2]) and runs[1][1].is_contiguous()


# --- the route --------------------------------------------------------------------

class _Card:
    """A stand-in residue tensor that says it is on a card."""
    is_cuda = True


def test_route_rule():
    """Only CUDA residues of an m31 chain outside a mesh take the fused
    route."""
    _, m31_ctx = _ctx_pair(CHAIN)
    _, m62_ctx = _ctx_pair(list(get_primes(36, 2, N)) + list(get_primes(37, 1, N)))
    assert m62_ctx.tables.profile == "m62"
    cpu = torch.zeros(1, m31_ctx.L, N, dtype=torch.int64)
    assert pipeline_cuda.route(_Card(), m31_ctx.tables) == "fused"
    assert pipeline_cuda.route(cpu, m31_ctx.tables) == "plain"
    assert pipeline_cuda.route(_Card(), m62_ctx.tables) == "plain"
    assert pipeline_cuda.route(_Card(), m31_ctx.tables, mesh=object()) == "plain"


@pytest.mark.parametrize("profile", ["m31", "m62"])
def test_packed_step_spans_name_the_plain_route(env, profile):
    """On the CPU (both profiles) the packed step's evaluate and decode
    spans say "plain", and its verdicts equal ``fn.plain``'s."""
    if profile == "m31":
        ctx, sk = env["ctx"], env["sk"]
    else:
        from pplp_tpu_torch import bfv

        _, ctx = _ctx_pair(list(get_primes(36, 2, N)) + list(get_primes(37, 1, N)))
        sk = bfv.KeyGenerator(ctx, torch.Generator().manual_seed(3)).secret_key()
    polys = _residues(ctx, 1, "random", seed=5)
    cts = [(torch.from_numpy(polys[2 * m]), torch.from_numpy(polys[2 * m + 1]))
           for m in range(3)]
    fn = pipeline.build_packed_pipeline(ctx, sk, *BLINDINGS["baseline"])
    profiling.enable()
    try:
        profiling.drain()
        got = fn(*cts)
        spans = profiling.drain()
    finally:
        profiling.disable()
    routes = {s.name: s.attrs.get("route") for s in spans}
    assert routes == {"pipeline.evaluate": "plain", "pipeline.decode": "plain"}
    assert torch.equal(got, fn.plain(*cts))
