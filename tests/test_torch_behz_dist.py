"""The port's distributed multiply + relinearization against the reference.

``pplp_tpu_torch.parallel.behz_dist.DistMultiplier`` at n = 1024 on three
28-bit primes (|B_sk| = 6: the limbs split 2 + 1 and 3 + 3 over 2 ranks,
1 + 1 + 1 + 0 and 2 + 2 + 1 + 1 over 4), t = 2^16, in gloo processes on
the CPU (``parallel/multiproc_smoke.py``), bit for bit (tolerance 0: exact
integer arithmetic):

* against the reference's single-device
  ``relinearize(ctx, RnsMultiplier(ctx).multiply(ct1, ct2), rlk)`` with the
  reference's keys carried over by ``relin_keys_from_reference``, at gadget
  widths 1 and 2, batch 2 on coeff = 2 (2 ranks), batch 4 on coeff = 4 and
  on dp = 2 x coeff = 2 (4 ranks);
* against the reference's own ``DistMultiplier`` (four-step engine, an
  8-device mesh dp = 2 x coeff = 4), its keys moved into the port's
  spectrum order by ``ntt.order_permutation``, on dp = 2 x coeff = 2;
* four exchanges a call, each of the words the C/R layouts say;
* an m62 context and a slice narrower than the kernels' rows are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pplp_tpu import bfv as rbfv
from pplp_tpu.bfv import behz as rbehz
from pplp_tpu.ops import ntt4
from pplp_tpu.ops.primes import get_primes
from pplp_tpu.parallel import behz_dist as rbehz_dist
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.ops import ntt
from pplp_tpu_torch.parallel import mesh as pmesh
from pplp_tpu_torch.parallel import ntt_dist
from pplp_tpu_torch.parallel.behz_dist import DistMultiplier
from pplp_tpu_torch.parallel.multiproc_smoke import launch

N, T, B = 1024, 1 << 16, 4
MOD = get_primes(28, 3, N)
# name -> (ranks, mesh, batch rows, extra job keys)
CASES = {"coeff2": (2, (1, 1, 2), 2, {}),
         "coeff4": (4, (1, 1, 4), 4, {}),
         "dp2xcoeff2": (4, (2, 1, 2), 4, {"batch_axis": "dp"})}


def _np(x):
    return np.asarray(x).astype(np.int64)


def _leaves(keys):
    return {"k0": keys.k0, "k0_shoup": keys.k0_shoup, "k1": keys.k1,
            "k1_shoup": keys.k1_shoup, "groups": [list(g) for g in keys.groups]}


@pytest.fixture(scope="module")
def env():
    parms = rbfv.EncryptionParameters.bfv(N, T, coeff_modulus=MOD)
    jctx = rbfv.BFVContext.build(parms)
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, coeff_modulus=MOD), "cpu")
    rng = np.random.default_rng(7)
    qs = np.asarray(MOD, np.int64)[:, None]
    polys = [rng.integers(0, 1 << 62, size=(B, len(MOD), N)) % qs for _ in range(4)]
    polys[0][0, :, :3] = qs - 1  # the largest residues
    jct = lambda a, b: rbfv.Ciphertext(  # noqa: E731
        (jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))), "coeff")
    j1, j2 = jct(*polys[:2]), jct(*polys[2:])

    # The reference's single-device product at both widths.
    rsk, _ = rbehz.make_keys_jit(jctx, 3)
    j3 = jax.jit(rbehz.RnsMultiplier(jctx).multiply)(j1, j2)
    want, keys = {}, {}
    for width in (1, 2):
        rlk = jax.jit(lambda k, w=width: rbehz.create_relin_keys(jctx, rsk, k, width=w))(
            jax.random.key(5 + width))
        rel = jax.jit(lambda c, r=rlk: rbehz.relinearize(jctx, c, r))(j3)
        want[width] = np.stack([_np(p) for p in rel.polys])
        keys[width] = behz.relin_keys_from_reference(
            ctx, *(_np(x) for x in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)), rlk.groups)
    assert [len(keys[w].groups) for w in (1, 2)] == [3, 2]

    # The reference's DistMultiplier on its four-step engine.
    jctx4 = rbfv.BFVContext.build(parms, engine="four")
    _, rlk4 = rbehz.make_keys_jit(jctx4, 11)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "coeff"))
    want4 = rbehz_dist.DistMultiplier(jctx4, rlk4, jmesh, batch_axis="dp"
                                      ).multiply_relinearize(j1, j2)
    mono = np.zeros((len(MOD), N), np.uint32)
    mono[:, 1] = 1
    perm = ntt.order_permutation(_np(ntt4.forward4(jnp.asarray(mono), jctx4.tables.four_step)),
                                 ctx.tables)
    keys4 = behz.relin_keys_from_reference(
        ctx, *(_np(x) for x in (rlk4.k0, rlk4.k0_shoup, rlk4.k1, rlk4.k1_shoup)), rlk4.groups,
        perm=perm)

    cts = [torch.from_numpy(p) for p in polys]
    common = dict(kind="behz", n=N, t=T, moduli=MOD)
    runs = {}
    for nproc in (2, 4):
        names = [(k, w) for k, v in CASES.items() if v[0] == nproc for w in (1, 2)]
        jobs = [dict(common, mesh=CASES[k][1], keys=_leaves(keys[w]),
                     ct1=[p[:CASES[k][2]] for p in cts[:2]],
                     ct2=[p[:CASES[k][2]] for p in cts[2:]], **CASES[k][3]) for k, w in names]
        if nproc == 4:
            names.append(("four", 0))
            jobs.append(dict(common, mesh=(2, 1, 2), keys=_leaves(keys4), ct1=cts[:2],
                             ct2=cts[2:], batch_axis="dp"))
        res = launch({"device": "cpu", "jobs": jobs}, nproc, timeout_s=150)
        for j, name in enumerate(names):
            runs[name] = [r["results"][j] for r in res]
    want[0] = np.stack([_np(p) for p in want4.polys])
    return dict(ctx=ctx, want=want, runs=runs, keys=keys)


def _assemble(outs, rows):
    got = torch.full((2, rows, len(MOD), N), -1, dtype=torch.int64)
    for out in outs:
        got[:, slice(*out["batch"]), :, slice(*out["coeffs"])] = out["out"]
    return got


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_matches_single_device_reference(env, name, width):
    rows = CASES[name][2]
    got = _assemble(env["runs"][name, width], rows)
    assert (got.numpy() == env["want"][width][:, :rows]).all()


def test_matches_reference_dist_multiplier(env):
    got = _assemble(env["runs"]["four", 0], B)
    assert (got.numpy() == env["want"][0]).all()


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_four_exchanges_a_call(env, name, width):
    """to_bsk's Q and B_sk blocks to R, the three tensor rows back, the
    digits to R, the two switched rows back: a rank sends every word of its
    blocks but those it keeps (int64 words on the CPU)."""
    S, K = CASES[name][1][2], behz.multiplier(env["ctx"]).K
    D = len(env["keys"][width].digit_groups(len(MOD)))
    for out in env["runs"][name, width]:
        rows = out["batch"][1] - out["batch"][0]
        w = out["coeffs"][1] - out["coeffs"][0]
        me = out["coeffs"][0] // w
        (qlo, qhi), (blo, bhi) = (ntt_dist.limb_splits(m, S)[me] for m in (len(MOD), K))
        lq, lb = qhi - qlo, bhi - blo
        words = rows * w * (4 * (len(MOD) - lq + K - lb) + 3 * (lq + lb) * (S - 1)
                            + D * (len(MOD) - lq) + 2 * lq * (S - 1))
        assert out["exchanges"] == 4
        assert out["bytes_sent"] == words * 8


def test_single_rank_mesh_is_the_plain_multiply(env):
    """S = 1 in this process: no exchange, the same product."""
    ctx, keys = env["ctx"], env["keys"]
    dm = DistMultiplier(ctx, keys[2], pmesh.make_mesh(1))
    polys = [torch.from_numpy(p) for p in env["want"][2][:, :1]]
    ct = bfv.Ciphertext(tuple(polys))
    out = dm.multiply_relinearize(ct, ct)
    want = behz.relinearize(ctx, behz.RnsMultiplier(ctx).multiply(ct, ct), keys[2])
    assert all(torch.equal(a, b) for a, b in zip(out.polys, want.polys))


def test_refuses_m62_and_narrow_slices(env):
    wide = bfv.BFVContext.build(
        bfv.EncryptionParameters.bfv(256, T, coeff_modulus=get_primes(36, 2, 256)), "cpu")
    assert wide.tables.profile == "m62"
    with pytest.raises(ValueError, match="m31"):
        DistMultiplier(wide, env["keys"][1], pmesh.make_mesh(2, 1, 1, 2, rank=0))
    with pytest.raises(ValueError, match="at least 64"):
        DistMultiplier(env["ctx"], env["keys"][1], pmesh.make_mesh(32, 1, 1, 32, rank=0))
