"""The port's distributed NTT (``parallel/ntt_dist.py``) against the reference.

n = 1024 on three 28-bit primes, batch 4, so the limbs split unevenly: 2 + 1
over 2 ranks, 1 + 1 + 1 + 0 over 4. The ranks are gloo processes on the CPU
(``parallel/multiproc_smoke.py``): 2 ranks on coeff = 2, and 4 ranks on
coeff = 4, dp = 2 x coeff = 2 and limb = 2 x coeff = 2. Bit for bit
(tolerance 0, all exact integer arithmetic):

* every rank's R rows equal ``ntt.forward_plain`` of its limbs (the port's
  spectrum order; spectra are compared only there);
* forward then inverse gives the rank's coefficient block back;
* a run of two forward and two inverse transforms makes four exchanges,
  and a rank sends every word of its blocks but those it keeps;
* forward, ``pointwise_mul_dist``, inverse equals the reference's
  ``make_dist_ntt`` + ``pointwise_mul_dist`` + inverse on an 8-device mesh
  (dp = 2, coeff = 4) in the coefficient domain, and the host negacyclic
  product (numpy, exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from pplp_tpu.ops import ntt4
from pplp_tpu.ops.primes import Modulus as RModulus
from pplp_tpu.ops.primes import get_primes
from pplp_tpu.parallel import mesh as rmesh
from pplp_tpu.parallel import ntt_dist as rntt_dist
from pplp_tpu_torch.ops import ntt
from pplp_tpu_torch.ops.primes import Modulus
from pplp_tpu_torch.parallel import ntt_dist
from pplp_tpu_torch.parallel.multiproc_smoke import launch

N, L, B = 1024, 3, 4
MESHES = {"coeff2": (2, (1, 1, 2), {}),
          "coeff4": (4, (1, 1, 4), {}),
          "dp2xcoeff2": (4, (2, 1, 2), {"batch_axis": "dp"}),
          "limb2xcoeff2": (4, (1, 2, 2), {"limb_axis": "limb"})}


def _negacyclic(a, b, q):
    """a * b mod (x^n + 1, q) for residues below 2^28, exactly in int64:
    14-bit halves keep every convolution sum below 2^39."""
    n = len(a)
    a0, a1, b0, b1 = a & 0x3FFF, a >> 14, b & 0x3FFF, b >> 14
    conv = np.convolve
    full = (conv(a0, b0) % q + (conv(a0, b1) + conv(a1, b0)) % q * (1 << 14) % q
            + conv(a1, b1) % q * ((1 << 28) % q) % q) % q
    full = np.concatenate([full, [0]])
    return (full[:n] - full[n:]) % q


@pytest.fixture(scope="module")
def case():
    moduli = get_primes(28, L, N)
    rng = np.random.default_rng(17)
    qs = np.array(moduli, np.int64)[None, :, None]
    x = rng.integers(0, 1 << 62, size=(B, L, N)) % qs
    y = rng.integers(0, 1 << 62, size=(B, L, N)) % qs
    x[0, :, :2] = qs[0] - 1  # the largest residues

    # The reference's distributed product on the 8-device CPU mesh.
    tb4 = ntt4.build_tables4([RModulus(q) for q in moduli], N)
    jmesh = rmesh.make_mesh(jax.devices(), dp=2, limb=1, coeff=4)
    fwd, inv = rntt_dist.make_dist_ntt(tb4, jmesh, batch_axis="dp")
    sh = NamedSharding(jmesh, P("dp", None, None, "coeff"))
    view = lambda a: jax.device_put(  # noqa: E731
        rntt_dist.coeff_view(jnp.asarray(a.astype(np.uint32)), tb4), sh)
    spec = rntt_dist.pointwise_mul_dist(jax.jit(fwd)(view(x)), jax.jit(fwd)(view(y)), tb4)
    ref_prod = np.asarray(rntt_dist.flat_view(jax.jit(inv)(spec))).astype(np.int64)
    host = np.stack([[_negacyclic(x[b, i], y[b, i], moduli[i]) for i in range(L)]
                     for b in range(B)])

    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    runs = {}
    for nproc in (2, 4):
        names = [k for k, v in MESHES.items() if v[0] == nproc]
        jobs = [dict(kind="ntt", mesh=MESHES[k][1], moduli=moduli, n=N, x=tx, y=ty,
                     **MESHES[k][2]) for k in names]
        res = launch({"device": "cpu", "jobs": jobs}, nproc, timeout_s=120)
        for j, k in enumerate(names):
            runs[k] = [r["results"][j] for r in res]
    tb = ntt.build_tables([Modulus(q) for q in moduli], N, "cpu")
    return dict(moduli=moduli, x=tx, tb=tb, ref_prod=ref_prod, host=host, runs=runs)


def _blocks(out):
    b, c, k = (slice(*out[key]) for key in ("batch", "coeffs", "limb_block"))
    return b, k, c


def test_reference_product_is_the_host_product(case):
    assert (case["ref_prod"] == case["host"]).all()


def test_limb_splits_are_uneven():
    assert ntt_dist.limb_splits(L, 2) == [(0, 2), (2, 3)]
    assert ntt_dist.limb_splits(L, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]


@pytest.mark.parametrize("name", list(MESHES))
def test_rows_equal_the_plain_transform(case, name):
    want = ntt.forward_plain(case["x"], case["tb"])
    covered = torch.zeros(B, L, dtype=torch.int64)
    for out in case["runs"][name]:
        b, _, _ = _blocks(out)
        limbs = slice(*out["limbs"])
        assert torch.equal(out["spec"], want[b, limbs])
        covered[b, limbs] += 1
    assert (covered == 1).all()  # every (row, limb) on exactly one rank


@pytest.mark.parametrize("name", list(MESHES))
def test_round_trip_is_the_identity(case, name):
    for out in case["runs"][name]:
        assert torch.equal(out["back"], case["x"][_blocks(out)])


@pytest.mark.parametrize("name", list(MESHES))
def test_product_equals_the_reference(case, name):
    ref = torch.from_numpy(case["ref_prod"])
    for out in case["runs"][name]:
        assert torch.equal(out["prod"], ref[_blocks(out)])


@pytest.mark.parametrize("name", list(MESHES))
def test_exchanges_of_the_planned_volume(case, name):
    """Forward sends a C block's words of the other ranks' limbs, inverse
    the rank's rows but its own n/S columns: int64 words on the CPU."""
    S = MESHES[name][1][2]
    for out in case["runs"][name]:
        b, k, c = _blocks(out)
        rows, kept, w = b.stop - b.start, out["limbs"][1] - out["limbs"][0], c.stop - c.start
        words = rows * w * ((k.stop - k.start - kept) + kept * (S - 1))
        assert out["exchanges"] == 4
        assert out["bytes_sent"] == 2 * words * 8
