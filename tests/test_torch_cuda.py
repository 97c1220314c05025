"""The port on a CUDA card: the NTT kernel against its plain version.

Every test here is marked ``cuda`` and skips without a card. This file
imports neither jax nor the JAX package, so it also runs where jax is not
installed; on the card run it without the suite's conftest (which imports
jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Comparisons are bit-exact (tolerance 0): all arithmetic is exact integer
arithmetic.
"""

import pytest
import torch

from pplp_tpu_torch.ops import ntt, ntt_cuda
from pplp_tpu_torch.ops.primes import Modulus, get_primes, tpu_default

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
