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
