"""The port's NTT against the reference's stage engine and its Pallas kernel.

* Tables, forward, inverse and polymul are bit-equal to ``pplp_tpu.ops.ntt``
  with ``engine="stage"`` (tolerance 0: exact integer arithmetic).
* Against the Pallas kernel (``ntt_vmem.forward_vmem``/``inverse_vmem``, in
  interpret mode as ``tests/test_ntt_vmem.py`` runs it on the CPU): the
  permutation between the two spectrum orders is derived from the spectra
  of the monomial X, then ``port_forward(x)[..., perm] == forward_vmem(x)``.
* m62 (seal-style chains of 36-61-bit primes): tables, forward, inverse
  and polymul bit-equal to the stage engine on (lo, hi) pairs, and the
  round trip.
* On the CPU the dispatch takes the plain version; the CUDA wrapper refuses
  CPU tensors, and building the kernel without nvcc raises. The kernels
  themselves are compared with the plain versions on a card by
  ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu.ops import ntt as ref_ntt
from pplp_tpu.ops import ntt_vmem
from pplp_tpu.ops.primes import Modulus, bfv_default, get_primes, tpu_default
from pplp_tpu_torch.ops import ntt, ntt_cuda
from pplp_tpu_torch.ops.primes import Modulus as PortModulus


def _chain(n):
    """tpu_default chain where one exists, else two primes of 28/27 bits."""
    if n >= 1024:
        return list(tpu_default(n))
    return list(get_primes(28, 1, n)) + list(get_primes(27, 1, n))


def _tables(n, engine="stage"):
    chain = _chain(n)
    tb_ref = ref_ntt.build_tables([Modulus(q) for q in chain], n, engine=engine)
    tb = ntt.build_tables([PortModulus(q) for q in chain], n, "cpu")
    return chain, tb_ref, tb


def _rand(rng, chain, n, batch=()):
    qs = np.array(chain, np.uint64).reshape((1,) * len(batch) + (-1, 1))
    v = rng.integers(0, 1 << 62, size=batch + (len(chain), n)).astype(np.uint64) % qs
    return v.astype(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n", [64, 4096])
def test_tables_match_reference(n):
    _, tb_ref, tb = _tables(n)
    for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s"):
        assert (getattr(tb, name).numpy() == _np(getattr(tb_ref, name))).all(), name


@pytest.mark.parametrize("n", [64, 256, 4096, 8192])
def test_forward_inverse_match_stage_engine(n):
    rng = np.random.default_rng(n)
    chain, tb_ref, tb = _tables(n)
    x = _rand(rng, chain, n, batch=(3,))
    spec_ref = jax.jit(lambda v: ref_ntt.forward(v, tb_ref))(jnp.asarray(x.astype(np.uint32)))
    spec = ntt.forward(_t(x), tb)
    assert (spec.numpy() == _np(spec_ref)).all()
    back_ref = jax.jit(lambda v: ref_ntt.inverse(v, tb_ref))(spec_ref)
    back = ntt.inverse(spec, tb)
    assert (back.numpy() == _np(back_ref)).all()
    assert (back.numpy() == x).all()


@pytest.mark.parametrize("n", [64, 4096])
def test_polymul_matches_stage_engine(n):
    rng = np.random.default_rng(n + 1)
    chain, tb_ref, tb = _tables(n)
    a, b = _rand(rng, chain, n), _rand(rng, chain, n)
    want = jax.jit(lambda u, v: ref_ntt.negacyclic_polymul(u, v, tb_ref))(
        jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    got = ntt.negacyclic_polymul(_t(a), _t(b), tb)
    assert (got.numpy() == _np(want)).all()
    # Schoolbook negacyclic product on limb 0, small n only.
    if n == 64:
        q = chain[0]
        c = [0] * n
        for i in range(n):
            for j in range(n):
                k, sign = (i + j, 1) if i + j < n else (i + j - n, -1)
                c[k] += sign * int(a[0, i]) * int(b[0, j])
        assert got[0].tolist() == [v % q for v in c]


@pytest.mark.parametrize("n", [256, 4096])
def test_matches_pallas_kernel_up_to_order(n):
    rng = np.random.default_rng(n + 2)
    chain, tb_vmem, tb = _tables(n, engine="vmem")
    tb4 = tb_vmem.four_step
    mono = np.zeros((len(chain), n), np.uint32)
    mono[:, 1] = 1
    x_spec = np.asarray(ntt_vmem.forward_vmem(jnp.asarray(mono), tb4))
    perm = ntt.order_permutation(x_spec, tb)
    assert sorted(perm.tolist()) == list(range(n))

    x = _rand(rng, chain, n, batch=(2,))
    spec_vmem = _np(ntt_vmem.forward_vmem(jnp.asarray(x.astype(np.uint32)), tb4))
    spec = ntt.forward(_t(x), tb)
    assert (spec[..., perm].numpy() == spec_vmem).all()
    # The inverse maps back either way round.
    back_vmem = ntt_vmem.inverse_vmem(
        jnp.asarray(spec[..., perm].numpy().astype(np.uint32)), tb4)
    assert (_np(back_vmem) == x).all()
    ours = torch.empty_like(spec)
    ours[..., torch.from_numpy(perm)] = _t(spec_vmem)
    assert (ntt.inverse(ours, tb).numpy() == x).all()


def test_dispatch_rejects_bad_input():
    _, _, tb = _tables(64)
    with pytest.raises(TypeError):
        ntt.forward(torch.zeros((2, 64), dtype=torch.int32), tb)
    with pytest.raises(ValueError):
        ntt.forward(torch.zeros((3, 64), dtype=torch.int64), tb)
    with pytest.raises(ValueError):
        ntt.build_tables([PortModulus(q) for q in _chain(64)], 32, "cpu")
    # A 36-bit prime alone is m62; mixed with a prime below 2^30, or a prime
    # of 62 bits or more, is refused (as the reference's profile rule does).
    assert ntt.build_tables([PortModulus((1 << 36) - 0x1FFF)], 64, "cpu").profile == "m62"
    with pytest.raises(ValueError, match="m62"):
        ntt.build_tables([PortModulus((1 << 36) - 0x1FFF), PortModulus(_chain(64)[0])],
                         64, "cpu")
    with pytest.raises(ValueError, match="m62"):
        ntt.build_tables([PortModulus(get_primes(63, 1, 64)[0])], 64, "cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor raises."""
    for tb in (_tables(64)[2], _tables62(64)[2]):
        x = torch.zeros((2, tb.L, 64), dtype=torch.int64)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ntt_cuda.forward(x, tb)
        with pytest.raises(ValueError, match="CUDA tensors"):
            ntt_cuda.inverse(x, tb)
    assert ntt_cuda.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    from pplp_tpu_torch.ops import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build([ntt_cuda.SOURCE], tmp_path / "build")
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# m62: seal-style chains against the stage engine on (lo, hi) pairs
# ---------------------------------------------------------------------------


def _chain62(n):
    """bfv_default where it is m62 (n >= 4096), else 36-, 44- and 61-bit primes."""
    if n >= 4096:
        return list(bfv_default(n))
    return [get_primes(b, 1, n)[0] for b in (36, 44, 61)]


def _tables62(n):
    chain = _chain62(n)
    tb_ref = ref_ntt.build_tables([Modulus(q) for q in chain], n)
    tb = ntt.build_tables([PortModulus(q) for q in chain], n, "cpu")
    assert tb_ref.profile == tb.profile == "m62"
    return chain, tb_ref, tb


def _pair(x):
    x = np.asarray(x).astype(np.uint64)
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _unpair(p):
    lo, hi = (np.asarray(a).astype(np.uint64) for a in p)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def _rand62(rng, chain, n, batch=()):
    v = np.array([[int(a) % q for a in rng.integers(0, 1 << 63, size=n, dtype=np.uint64)]
                  for q in chain for _ in range(int(np.prod(batch, dtype=np.int64)))],
                 dtype=np.int64)
    v = v.reshape((len(chain),) + batch + (n,))
    v = np.moveaxis(v, 0, -2)
    v[(0,) * len(batch) + (slice(None), slice(0, 2))] = np.array(chain)[:, None] - 1
    return v


@pytest.mark.parametrize("n", [64, 4096])
def test_m62_tables_match_reference(n):
    _, tb_ref, tb = _tables62(n)
    for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s"):
        assert (getattr(tb, name).numpy() == _unpair(getattr(tb_ref, name))).all(), name
    assert (tb.mu.numpy() == np.stack([_np(m) for m in tb_ref.mu])).all()


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_m62_forward_inverse_match_stage_engine(n):
    rng = np.random.default_rng(n + 62)
    chain, tb_ref, tb = _tables62(n)
    x = _rand62(rng, chain, n, batch=(2,))
    spec_ref = jax.jit(lambda v: ref_ntt.forward(v, tb_ref))(_pair(x))
    spec = ntt.forward(_t(x), tb)
    assert (spec.numpy() == _unpair(spec_ref)).all()
    back_ref = jax.jit(lambda v: ref_ntt.inverse(v, tb_ref))(spec_ref)
    back = ntt.inverse(spec, tb)
    assert (back.numpy() == _unpair(back_ref)).all()
    assert (back.numpy() == x).all()


def test_m62_polymul_matches_stage_engine():
    n = 64
    rng = np.random.default_rng(65)
    chain, tb_ref, tb = _tables62(n)
    a, b = _rand62(rng, chain, n), _rand62(rng, chain, n)
    want = jax.jit(lambda u, v: ref_ntt.negacyclic_polymul(u, v, tb_ref))(_pair(a), _pair(b))
    got = ntt.negacyclic_polymul(_t(a), _t(b), tb)
    assert (got.numpy() == _unpair(want)).all()
    for li, q in enumerate(chain):  # schoolbook negacyclic product
        c = [0] * n
        for i in range(n):
            for j in range(n):
                k, sign = (i + j, 1) if i + j < n else (i + j - n, -1)
                c[k] += sign * int(a[li, i]) * int(b[li, j])
        assert got[li].tolist() == [v % q for v in c]
