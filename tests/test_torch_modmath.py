"""The port's m31 arithmetic against the reference's and against Python ints.

Same residues, made from a numpy seed, go through
``pplp_tpu.ops.modmath.m31`` (u32 lanes) and ``pplp_tpu_torch.ops.modmath``
(int64 tensors). Every comparison is bit-exact (tolerance 0): all of it is
exact integer arithmetic. Lazy inputs reach up to 4q - 1, where the Shoup
estimate w_shoup * x passes 2^63.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu.ops import modmath as ref
from pplp_tpu.ops.primes import tpu_default
from pplp_tpu_torch.ops import modmath as port

PRIMES = tpu_default(4096)  # 28- and 27-bit primes
N = 4096


def _draw(rng, q, hi):
    """N values in [0, hi) with the top of the range forced in."""
    v = rng.integers(0, hi, size=N, dtype=np.uint64)
    v[:4] = [0, 1, hi - 2, hi - 1]
    return v


def _as_port(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def _as_ref(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


def _mu(q):
    mu = (1 << 64) // q
    return jnp.uint32(mu & 0xFFFFFFFF), jnp.uint32(mu >> 32)


def _same(port_out, ref_out, ints):
    p = port_out.numpy().astype(np.uint64)
    r = np.asarray(ref_out).astype(np.uint64)
    assert (p == r).all()
    assert p.tolist() == [int(v) for v in ints]


@pytest.fixture(params=PRIMES[:2])
def q(request):
    return request.param


@pytest.fixture
def rng(q):
    return np.random.default_rng(q % 1000)


@pytest.mark.parametrize("op", ["add", "sub", "mulmod"])
def test_binary_canonical(op, q, rng):
    x, y = _draw(rng, q, q), _draw(rng, q, q)
    rng.shuffle(y)
    xi, yi = [int(v) for v in x], [int(v) for v in y]
    if op == "add":
        want = [(a + b) % q for a, b in zip(xi, yi)]
        _same(port.m31.add(_as_port(x), _as_port(y), q),
              ref.m31.add(_as_ref(x), _as_ref(y), jnp.uint32(q)), want)
    elif op == "sub":
        want = [(a - b) % q for a, b in zip(xi, yi)]
        _same(port.m31.sub(_as_port(x), _as_port(y), q),
              ref.m31.sub(_as_ref(x), _as_ref(y), jnp.uint32(q)), want)
    else:
        want = [a * b % q for a, b in zip(xi, yi)]
        _same(port.m31.mulmod(_as_port(x), _as_port(y), q),
              ref.m31.mulmod(_as_ref(x), _as_ref(y), jnp.uint32(q), *_mu(q)), want)


@pytest.mark.parametrize("op,bound", [("neg", 1), ("csub", 2), ("csub2q", 4)])
def test_unary_reductions(op, bound, q, rng):
    x = _draw(rng, q, bound * q)
    xi = [int(v) for v in x]
    if op == "neg":
        want = [(-a) % q for a in xi]
        _same(port.m31.neg(_as_port(x), q), ref.m31.neg(_as_ref(x), jnp.uint32(q)), want)
    elif op == "csub":
        _same(port.m31.csub(_as_port(x), q), ref.m31.csub(_as_ref(x), jnp.uint32(q)),
              [a % q for a in xi])
    else:
        want = [a - 2 * q if a >= 2 * q else a for a in xi]
        _same(port.m31.csub2q(_as_port(x), 2 * q),
              ref.m31.csub2q(_as_ref(x), jnp.uint32(2 * q)), want)


def test_lazy_add_sub(q, rng):
    x, y = _draw(rng, q, 2 * q), _draw(rng, q, 2 * q)
    rng.shuffle(y)
    xi, yi = [int(v) for v in x], [int(v) for v in y]
    _same(port.m31.lazy_add(_as_port(x), _as_port(y)),
          ref.m31.lazy_add(_as_ref(x), _as_ref(y)), [a + b for a, b in zip(xi, yi)])
    _same(port.m31.lazy_sub2q(_as_port(x), _as_port(y), 2 * q),
          ref.m31.lazy_sub2q(_as_ref(x), _as_ref(y), jnp.uint32(2 * q)),
          [a + 2 * q - b for a, b in zip(xi, yi)])


@pytest.mark.parametrize("lazy", [False, True])
def test_mulmod_shoup(lazy, q, rng):
    """x up to 4q - 1 (Harvey lazy range) for the lazy form."""
    x = _draw(rng, q, 4 * q if lazy else q)
    w = _draw(rng, q, q)
    rng.shuffle(w)
    ws = np.asarray([(int(v) << 32) // q for v in w], dtype=np.uint64)
    fn_p = port.m31.mulmod_shoup_lazy if lazy else port.m31.mulmod_shoup
    fn_r = ref.m31.mulmod_shoup_lazy if lazy else ref.m31.mulmod_shoup
    got = fn_p(_as_port(x), _as_port(w), _as_port(ws), q)
    want_ref = fn_r(_as_ref(x), _as_ref(w), _as_ref(ws), jnp.uint32(q))
    ints = []
    for a, b, bs in zip(x, w, ws):
        a, b, bs = int(a), int(b), int(bs)
        r = (a * b - ((a * bs) >> 32) * q) % (1 << 32)
        ints.append(r if lazy else r % q)
    _same(got, want_ref, ints)
    assert all(v < 2 * q for v in ints)
    assert [v % q for v in ints] == [int(a) * int(b) % q for a, b in zip(x, w)]


def test_mulhi32_past_int64():
    """w_shoup * x reaches 2^64: the high word must still be exact."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, size=N, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=N, dtype=np.uint64)
    a[:2] = b[:2] = (1 << 32) - 1
    lo, hi = port.mul32(_as_port(a), _as_port(b))
    r_lo, r_hi = ref.mul32(_as_ref(a), _as_ref(b))
    prods = [int(x) * int(y) for x, y in zip(a, b)]
    _same(lo, r_lo, [p & 0xFFFFFFFF for p in prods])
    _same(hi, r_hi, [p >> 32 for p in prods])
    _same(port.mulhi32(_as_port(a), _as_port(b)), ref.mulhi32(_as_ref(a), _as_ref(b)),
          [p >> 32 for p in prods])


def test_reduce64(q, rng):
    lo = rng.integers(0, 1 << 32, size=N, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=N, dtype=np.uint64)
    lo[0] = hi[0] = (1 << 32) - 1
    want = [((int(h) << 32) | int(v)) % q for v, h in zip(lo, hi)]
    _same(port.m31.reduce64(_as_port(lo), _as_port(hi), q),
          ref.m31.reduce64(_as_ref(lo), _as_ref(hi), jnp.uint32(q), *_mu(q)), want)


def test_shoup_precompute(q, rng):
    w = _draw(rng, q, q)
    want = [(int(v) << 32) // q for v in w]
    _same(port.m31.shoup_precompute(_as_port(w), q),
          ref.m31.shoup_precompute(_as_ref(w), jnp.uint32(q), *_mu(q)), want)


# ---------------------------------------------------------------------------
# m62: one int64 per residue against the reference's (lo, hi) u32 pairs
# ---------------------------------------------------------------------------

from pplp_tpu.ops.primes import bfv_default, get_primes  # noqa: E402

# The widest primes of the seal chains at n = 4096, 8192 and 32768 (37, 44
# and 56 bits) and a 61-bit prime, where 4q approaches 2^63.
M62_PRIMES = [bfv_default(4096)[-1], bfv_default(8192)[-1], bfv_default(32768)[-1],
              get_primes(61, 1, 4096)[0]]
M62_OPS = ["add", "sub", "neg", "csub", "csub2q", "lazy_add", "lazy_sub2q",
           "mulmod_shoup_lazy", "mulmod_shoup", "mulmod", "reduce128",
           "shoup_precompute"]


def _pair(a):
    a = np.asarray(a, dtype=np.uint64)
    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32)))


def _unpair(p):
    lo, hi = (np.asarray(x).astype(np.uint64) for x in p)
    return lo | (hi << np.uint64(32))


def _limbs(v, k):
    return tuple(jnp.uint32((v >> (32 * i)) & 0xFFFFFFFF) for i in range(k))


def _draw62(rng, hi):
    """N values in [0, hi) with 0, 1, hi - 2 and hi - 1 forced in."""
    v = np.array([int(x) % hi for x in rng.integers(0, 1 << 63, size=N, dtype=np.uint64)],
                 dtype=np.uint64)
    v[:4] = [0, 1, hi - 2, hi - 1]
    return v


def _same62(port_out, ref_out, ints):
    p = port_out.numpy().view(np.uint64)
    assert (p == _unpair(ref_out)).all()
    assert p.tolist() == [int(v) for v in ints]


@pytest.mark.parametrize("op", M62_OPS)
@pytest.mark.parametrize("q", M62_PRIMES)
def test_m62_op_matches_reference(op, q):
    rng = np.random.default_rng(q % 997)
    r62, p62 = ref.m62, port.m62
    qp, qt = _limbs(q, 2), q
    ratio = (1 << 128) // q
    ratio_ref, ratio_port = _limbs(ratio, 3), tuple(int(x) for x in _limbs(ratio, 3))
    bound = {"csub": 2, "csub2q": 4, "lazy_add": 2, "lazy_sub2q": 2,
             "mulmod_shoup_lazy": 4}.get(op, 1)
    x = _draw62(rng, bound * q)
    y = _draw62(rng, bound * q)
    rng.shuffle(y)
    xi, yi = [int(v) for v in x], [int(v) for v in y]
    X, Y = _as_port(x.view(np.int64)), _as_port(y.view(np.int64))
    if op in ("add", "sub"):
        fn = {"add": lambda a, b: (a + b) % q, "sub": lambda a, b: (a - b) % q}[op]
        _same62(getattr(p62, op)(X, Y, qt), getattr(r62, op)(_pair(x), _pair(y), qp),
                [fn(a, b) for a, b in zip(xi, yi)])
    elif op == "neg":
        _same62(p62.neg(X, qt), r62.neg(_pair(x), qp), [(-a) % q for a in xi])
    elif op == "csub":
        _same62(p62.csub(X, qt), r62.csub(_pair(x), qp), [a % q for a in xi])
    elif op == "csub2q":
        _same62(p62.csub2q(X, 2 * q), r62.csub2q(_pair(x), _limbs(2 * q, 2)),
                [a - 2 * q if a >= 2 * q else a for a in xi])
    elif op == "lazy_add":
        _same62(p62.lazy_add(X, Y), r62.lazy_add(_pair(x), _pair(y)),
                [a + b for a, b in zip(xi, yi)])
    elif op == "lazy_sub2q":
        _same62(p62.lazy_sub2q(X, Y, 2 * q), r62.lazy_sub2q(_pair(x), _pair(y), _limbs(2 * q, 2)),
                [a + 2 * q - b for a, b in zip(xi, yi)])
    elif op in ("mulmod_shoup_lazy", "mulmod_shoup"):
        w = _draw62(rng, q)
        ws = np.array([(int(v) << 64) // q for v in w], dtype=np.uint64)
        got = getattr(p62, op)(X, _as_port(w.view(np.int64)), _as_port(ws.view(np.int64)), qt)
        want = getattr(r62, op)(_pair(x), _pair(w), _pair(ws), qp)
        ints = [(a * int(b) - ((a * int(bs)) >> 64) * q) % (1 << 64)
                for a, b, bs in zip(xi, w, ws)]
        if op == "mulmod_shoup":
            ints = [v % q for v in ints]
        _same62(got, want, ints)
        assert all(v < 2 * q for v in ints)
    elif op == "mulmod":
        _same62(p62(ratio_port).mulmod(X, Y, qt), r62.mulmod(_pair(x), _pair(y), qp, ratio_ref),
                [a * b % q for a, b in zip(xi, yi)])
    elif op == "reduce128":
        z = [int(v) for v in rng.integers(0, 1 << 63, size=N, dtype=np.uint64)]
        z = [(a << 65) ^ (b << 1) ^ (a >> 3) for a, b in zip(z, z[::-1])]
        z[:3] = [0, q - 1, (1 << 128) - 1]
        words = [np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in z], dtype=np.uint64)
                 for i in range(4)]
        got = p62(ratio_port).reduce128(tuple(_as_port(w) for w in words), qt)
        want = r62.reduce128(tuple(_as_ref(w) for w in words), qp, ratio_ref)
        _same62(got, want, [v % q for v in z])
    else:  # shoup_precompute: floor(w 2^64 / q) reaches 2^64 - 1, an int64 bit pattern
        _same62(p62(ratio_port).shoup_precompute(X, qt),
                r62.shoup_precompute(_pair(x), qp, ratio_ref),
                [(a << 64) // q for a in xi])


def test_m62_tensor_constants_broadcast():
    """q and the ratio words as [L, 1] tensors against residues [L, n], as
    the NTT tables and the context pass them."""
    qs = M62_PRIMES
    rng = np.random.default_rng(2)
    x = np.stack([_draw62(rng, q) for q in qs]).view(np.int64)
    y = np.stack([_draw62(rng, q) for q in qs]).view(np.int64)
    q_col = torch.tensor([[q] for q in qs])
    ratio = tuple(torch.tensor([[((1 << 128) // q >> (32 * i)) & 0xFFFFFFFF] for q in qs])
                  for i in range(3))
    got = port.m62(ratio).mulmod(_as_port(x), _as_port(y), q_col).numpy()
    for li, q in enumerate(qs):
        assert got[li].tolist() == [int(a) * int(b) % q for a, b in zip(x[li], y[li])]


# ---------------------------------------------------------------------------
# m62's route: CPU residues run the plain chain, never the CUDA kernels
# ---------------------------------------------------------------------------

from pplp_tpu_torch.ops import modmath_cuda  # noqa: E402

M62_ROUTED = list(modmath_cuda.OPS)
M62_LAZY = ["csub", "csub2q", "lazy_sub2q", "mulmod_shoup_lazy"]  # no kernel


def _m62_case(op, L=3, n=64, seed=0):
    """(m62, m62_plain, operands of ``op``) on CPU residues [2, L, n] of the
    n = 8192 seal chain's primes, with per-limb [L, 1] constants and ratio."""
    qs = bfv_default(8192)[:L]
    rng = np.random.default_rng(seed)
    q_col = torch.tensor([[q] for q in qs])
    ratio = tuple(torch.tensor([[((1 << 128) // q >> (32 * i)) & 0xFFFFFFFF] for q in qs])
                  for i in range(3))
    p = port.m62(ratio)

    def res(bound):
        return torch.from_numpy(np.stack([np.stack([_draw62(rng, bound * q)[:n] for q in qs])
                                          for _ in range(2)]).view(np.int64))

    w = res(1)
    ws = torch.from_numpy(np.array([[[(int(v) << 64) // q for v in row]
                                     for row, q in zip(plane, qs)] for plane in w.numpy()],
                                   dtype=np.uint64).view(np.int64))
    words = tuple(torch.from_numpy(rng.integers(0, 1 << 32, (2, L, n), dtype=np.int64))
                  for _ in range(4))
    two_q = 2 * q_col
    args = {"add": (res(1), res(1), q_col), "sub": (res(1), res(1), q_col),
            "neg": (res(1), q_col), "csub": (res(2), q_col), "csub2q": (res(4), two_q),
            "lazy_sub2q": (res(2), res(2), two_q),
            "mulmod_shoup_lazy": (res(4), w, ws, q_col), "mulmod_shoup": (res(4), w, ws, q_col),
            "mulmod": (res(1), res(1), q_col), "reduce128": (words, q_col),
            "shoup_precompute": (res(1), q_col)}[op]
    return p, port.m62_plain(ratio), args


@pytest.mark.parametrize("op", M62_ROUTED)
def test_m62_cpu_route_runs_the_plain_chain(op, monkeypatch):
    """On the CPU every routed op is the plain chain, bit for bit, and no
    kernel is launched (``launch`` is never reached)."""
    modmath_cuda.reset_launches()

    def refuse(*args):
        raise AssertionError("a CPU residue reached the CUDA launch")

    monkeypatch.setattr(modmath_cuda, "launch", refuse)
    routed, plain, args = _m62_case(op)
    assert torch.equal(getattr(routed, op)(*args), getattr(plain, op)(*args))
    assert not any(modmath_cuda.launches_by_kernel.values())


def test_m62_reduce_words_pads_on_the_cpu():
    """reduce_words of two words (a u64 as (lo, hi), the plaintexts' form)
    is reduce128 with two zero words, on the plain chain."""
    p, _, (words, q_col) = _m62_case("reduce128")
    got = p.reduce_words(words[:2], q_col)
    want = [[[(int(lo) + (int(hi) << 32)) % int(q) for lo, hi in zip(rl, rh)]
             for rl, rh, q in zip(pl, ph, q_col[:, 0])] for pl, ph in zip(words[0], words[1])]
    assert got.tolist() == want


def _model_offsets(layout_words, count):
    """csrc/modmath64.cu's indexing of a layout: each operand's element
    offset (or its immediate) for every output index, in numpy."""
    numel, ndim = layout_words[0], layout_words[1]
    shape = layout_words[2:2 + ndim]
    idx = np.arange(numel, dtype=np.int64)
    offs, imms = [], []
    for k in range(count):
        base = 2 + ndim + k * (1 + ndim)
        imms.append(layout_words[base])
        strides = layout_words[base + 1:base + 1 + ndim]
        rest, off = idx.copy(), np.zeros(numel, dtype=np.int64)
        for d in range(ndim - 1, -1, -1):
            off += (rest % shape[d]) * strides[d]
            rest //= shape[d]
        offs.append(off)
    return offs, imms


@pytest.mark.parametrize("case", ["limb_column", "spectrum", "batch", "strided_words", "expanded",
                                  "immediate", "scalar_q", "ntt_stage"])
def test_m62_layout_reads_each_operand_where_it_lies(case):
    """The kernels' broadcast layout (``modmath_cuda._layout``) against
    PyTorch's broadcasting: read through the model of the kernel's
    indexing, every operand's storage gives the expanded operand, element
    for element, and the output has the broadcast shape. Dimensions that
    every operand walks alike are merged."""
    L, n, B = 5, 16, 3
    col = torch.arange(L).reshape(L, 1) + 100
    spec = torch.arange(L * n).reshape(L, n) + 1000
    batch = torch.arange(B * L * n).reshape(B, L, n) + 5000
    words = torch.arange(B * 4 * L * n).reshape(B, 4, L, n)
    operands, merged = {
        "limb_column": ((spec, col), [L, n]),
        "spectrum": ((batch, spec, col), [B, L, n]),
        "batch": ((batch, batch + 1, col), [B, L, n]),
        "strided_words": ((words[:, 0], words[:, 1], col), [B, L, n]),
        "expanded": ((spec[0].expand(B, L, n), batch), [B * L, n]),
        "immediate": ((batch, 7, spec), [B, L * n]),
        "scalar_q": ((batch, batch, 12345), [B * L * n]),
        "ntt_stage": ((batch.reshape(B, L, 4, 2, 2)[..., 0, :], col.reshape(L, 1, 1),
                       spec.reshape(L, n)[:, :4, None]), [B, L, 4, 2]),
    }[case]
    shape, layout = modmath_cuda._layout(operands)
    want_shape = torch.broadcast_shapes(*(a.shape for a in operands if torch.is_tensor(a)))
    assert shape == tuple(want_shape)
    words_ = list(layout)
    assert words_[1] == len(merged) and words_[2:2 + len(merged)] == merged
    offs, imms = _model_offsets(words_, len(operands))
    for a, off, imm in zip(operands, offs, imms):
        if torch.is_tensor(a):
            storage = torch.as_strided(a, (a.untyped_storage().nbytes() // 8 - a.storage_offset(),),
                                       (1,))
            got = storage[torch.from_numpy(off)]
            assert torch.equal(got, a.expand(shape).reshape(-1))
        else:
            assert imm == a


def test_m62_launch_takes_cuda_int64_tensors_only():
    """The launch path refuses what the kernels cannot read: CPU residues,
    another dtype, a wrong number of operands; it never falls back."""
    x = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        modmath_cuda.launch("add", x, x, 7)
    with pytest.raises(TypeError, match="int64"):
        modmath_cuda.launch("add", x.to(torch.int32), x, 7)
    with pytest.raises(TypeError, match="operands"):
        modmath_cuda.launch("add", x, 7)
    with pytest.raises(ValueError, match="broadcast"):
        modmath_cuda._layout((torch.zeros(2, 4), torch.zeros(3, 4)))
    big = torch.zeros(1, dtype=torch.int64).expand(modmath_cuda.MAX_NUMEL)  # the 32-bit index
    assert modmath_cuda._layout((big[1:], 7))[0] == (modmath_cuda.MAX_NUMEL - 1,)
    with pytest.raises(ValueError, match="fewer than"):
        modmath_cuda._layout((big, 7))
    assert not any(modmath_cuda.launches_by_kernel.values())


@pytest.mark.parametrize("profile", ["seal", "tpu"])
def test_bfv_stage_spans_say_the_plain_route_on_the_cpu(profile):
    """kGen, enc and homoCalc's spans carry ``route``: "plain" on the CPU
    (the kernels run only for an m62 chain on a CUDA device)."""
    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.protocol import stages
    from pplp_tpu_torch.utils import profiling

    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(4096, 1 << 20, profile=profile),
                               "cpu")
    assert port.m62_route(ctx.tables) == "plain"
    g = torch.Generator().manual_seed(3)
    profiling.enable()
    try:
        profiling.drain()
        sk, pk = stages.keygen(ctx, g)
        lo, hi = stages.plain_pair(5, ctx.t, ctx.n)
        ct = stages.encrypt_batch(ctx, pk, lo[None], hi[None], g)
        one = bfv.Ciphertext((ct.polys[0][0], ct.polys[1][0]), "coeff")
        pair = stages.plain_pair(1, ctx.t, ctx.n)
        stages.blind_distance(ctx, one, one, one, pair, pair, pair, pair, pair)
        got = {s.name: s.attrs for s in profiling.drain() if s.name.startswith("bfv.")
               and s.name in ("bfv.keygen", "bfv.encrypt", "bfv.evaluate")}
    finally:
        profiling.disable()
    assert got == {name: {"route": "plain"}
                   for name in ("bfv.keygen", "bfv.encrypt", "bfv.evaluate")}


# ---------------------------------------------------------------------------
# The card's route emulated on the CPU: which ops launch, and how often
# ---------------------------------------------------------------------------


class _EmulatedCard:
    """``modmath._on_card`` true for every tensor and ``modmath_cuda.launch``
    running the plain op in its place, counted by kernel as the card counts
    it. The plain NTT's own elementwise ops are not counted: on the card a
    transform is one launch of ``csrc/ntt.cu``."""

    def __init__(self, mp):
        from pplp_tpu_torch.ops import ntt

        self.launches = {kernel: 0 for kernel, _ in modmath_cuda.OPS.values()}
        self.in_ntt = 0
        mp.setattr(port, "_on_card", torch.is_tensor)
        mp.setattr(modmath_cuda, "launch", self.launch)
        for name in ("forward_plain", "inverse_plain"):
            mp.setattr(ntt, name, self._uncounted(getattr(ntt, name)))

    def _uncounted(self, fn):
        def transform(*args):
            self.in_ntt += 1
            try:
                return fn(*args)
            finally:
                self.in_ntt -= 1
        return transform

    def launch(self, op, *operands):
        if op == "reduce128":
            got = port.m62_plain(operands[5:]).reduce128(operands[:4], operands[4])
        elif op in ("mulmod", "shoup_precompute"):
            got = getattr(port.m62_plain(operands[-3:]), op)(*operands[:-3])
        else:
            got = getattr(port.m62_plain, op)(*operands)
        if not self.in_ntt:
            self.launches[modmath_cuda.OPS[op][0]] += 1
        return got

    def take(self) -> dict:
        got = {k: v for k, v in self.launches.items() if v}
        self.launches = dict.fromkeys(self.launches, 0)
        return got


@pytest.fixture(scope="module")
def emulated_stage_launches():
    """The m62 launches under kGen, enc and homoCalc (``stages.keygen``,
    ``encrypt_batch`` of the demo's three messages, ``blind_distance``) at
    the demo cell's shape, seal n = 8192 and t = 2^56, with the card's route
    emulated on the CPU (``_EmulatedCard``)."""
    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.ops.primes import bfv_default
    from pplp_tpu_torch.protocol import stages

    parms = bfv.EncryptionParameters.bfv(8192, 1 << 56, coeff_modulus=bfv_default(8192))
    ctx = bfv.BFVContext.build(parms, "cpu")
    g = torch.Generator().manual_seed(8)
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        card = _EmulatedCard(mp)
        sk, pk = stages.keygen(ctx, g)
        counts["kGen"] = card.take()
        pairs = [stages.plain_pair(v, ctx.t, ctx.n) for v in (5, 6, 7)]
        ct = stages.encrypt_batch(ctx, pk, np.stack([p[0] for p in pairs]),
                                  np.stack([p[1] for p in pairs]), g)
        counts["enc"] = card.take()
        c = [port_ct(ct, i) for i in range(3)]
        plains = [stages.plain_pair(v, ctx.t, ctx.n) for v in (5, 6, 7, 8, 9)]
        stages.blind_distance(ctx, *c, *plains)
        counts["homoCalc"] = card.take()
    return counts


def port_ct(ct, i):
    from pplp_tpu_torch import bfv

    return bfv.Ciphertext((ct.polys[0][i], ct.polys[1][i]), "coeff")


# What one demo test launches on the card, stage by stage: 9, 12 and 23.
# kGen: the samplers' two centred lifts, the uniform a's reduce_words, the
# three keys' Shoup companions and pk0 = -(a s + e) (a product, an add and a
# negation); enc: the samplers' three lifts, the products u pk0 and u pk1,
# scale_plain (two reduce_words, a Shoup product by delta, an add) and four
# adds.
# homoCalc: two add_plain (a reduce_words, a Shoup product by delta and an
# add each), the plaintext spectra (reduce_words, the centred lift's sub,
# their companions), six Shoup products by the spectra, two adds and two
# subs; the card's own count is ``test_torch_cuda.py::test_blind_distance_launches``.
M62_STAGE_LAUNCHES = {
    "kGen": {"m62_add": 1, "m62_neg": 3, "m62_reduce128": 1, "m62_shoup": 1,
             "m62_shoup_pre": 3},
    "enc": {"m62_add": 4, "m62_neg": 3, "m62_reduce128": 2, "m62_shoup": 3},
    "homoCalc": {"m62_add": 6, "m62_sub": 3, "m62_shoup": 8, "m62_reduce128": 5,
                 "m62_shoup_pre": 1},
}


@pytest.mark.parametrize("stage", list(M62_STAGE_LAUNCHES))
def test_m62_launches_under_each_bfv_stage(stage, emulated_stage_launches):
    """Each BFV stage of the demo launches the m62 kernels it is counted
    with on the card (``M62_STAGE_LAUNCHES``), by the card's route emulated
    on the CPU: tens of launches a stage where the int64 chain took
    hundreds of torch ops."""
    assert emulated_stage_launches[stage] == M62_STAGE_LAUNCHES[stage]


@pytest.mark.parametrize("op", M62_LAZY)
def test_m62_lazy_ops_run_the_plain_chain_on_either_route(op, monkeypatch):
    """The lazy ops have no kernel: with the card's route emulated they are
    still the plain chain's, bit for bit, and launch nothing."""
    routed, plain, args = _m62_case(op)
    card = _EmulatedCard(monkeypatch)
    assert getattr(port.m62, op) is getattr(port.m62_plain, op)
    assert torch.equal(getattr(routed, op)(*args), getattr(plain, op)(*args))
    assert card.take() == {}
