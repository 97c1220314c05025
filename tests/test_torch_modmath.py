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
