"""A numpy model of the Hopper m31 NTT kernel's index schedule (``csrc/ntt.cu``).

The kernel cannot run on the CPU, so its schedule is modelled here op for op
and held bit-exact against ``ops/ntt.forward_plain``/``inverse_plain`` and,
for a few sizes, against ``pplp_tpu.ops.ntt``'s stage engine:

* rounds: the forward runs ``logn mod k`` stages first, then rounds of k;
  the inverse runs rounds of k, then the remainder (``round_sizes``). The
  kernel is built with k = 4 (``kRadixLog`` in ``csrc/ntt_block.cuh``); the
  model also runs k = 3, the round size it was measured against;
* which elements each thread's group holds in registers in each round
  (``group_indices``) and which twiddle index each butterfly reads;
* the shared-memory exchange: the row lives in shared memory under the
  16-byte XOR swizzle ``swizzle``, every round reads and writes each element
  exactly once, and the warp's accesses are at most 2-way bank conflicted
  (the stride-1 rounds use 16-byte vector accesses, conflict-free);
* the fused relinearization kernel's digit loop (lift -> forward -> key
  products into two spectral accumulators -> inverse -> add), against
  ``bfv.behz.relinearize`` at widths 1 and 2;
* the fused tensor kernel (forward x 4 -> Karatsuba -> inverse x 3) against
  ``RnsMultiplier.tensor_spectra``, the plain multiply's spectra products;
* ``measure_multiply``'s shape-derived counts.

Tolerance 0 throughout: exact integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu.ops import ntt as ref_ntt
from pplp_tpu.ops.primes import Modulus
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.measure_multiply import kernel_counts, work_counts
from pplp_tpu_torch.ops import ntt
from pplp_tpu_torch.ops.primes import Modulus as PortModulus
from pplp_tpu_torch.ops.primes import get_primes, tpu_default

M32 = np.uint64(0xFFFFFFFF)
WARP = 32


def _chain(n):
    if n >= 1024:
        return list(tpu_default(n))
    return list(get_primes(28, 1, n)) + list(get_primes(27, 1, n))


def _tables(n):
    return ntt.build_tables([PortModulus(q) for q in _chain(n)], n, "cpu")


# ---------------------------------------------------------------------------
# The schedule (mirrors csrc/ntt.cu: ntt_fwd_block / ntt_inv_block)
# ---------------------------------------------------------------------------


def round_sizes(logn, k, inverse):
    """Stages per round: the remainder first (forward) or last (inverse), so
    that the stride-1 round always has k stages."""
    r = logn % k
    full = [k] * (logn // k)
    if not r:
        return full
    return full + [r] if inverse else [r] + full


def swizzle(i):
    """Shared-memory word of logical element i: 16-byte units XOR-permuted
    within each 128-byte line (keeps 4-word units whole for vector access)."""
    return i ^ (((i >> 5) & 7) << 2)


def group_indices(logn, s, kk, inverse, groups):
    """Row indices [G, 2^kk] held by each group of a round at stage s, the
    group's twiddle node r, and log2 of the element stride."""
    n = 1 << logn
    logt = s if inverse else logn - s - kk
    lo = groups & ((1 << logt) - 1)
    hi = groups >> logt
    base = (hi << (logt + kk)) + lo
    idx = base[:, None] + (np.arange(1 << kk)[None, :] << logt)
    r = ((n >> (s + kk)) if inverse else (1 << s)) + hi
    return idx, r, logt


def _shoup_lazy(x, w, ws, q):
    """w x - umulhi(ws, x) q in wrapping u32 (the kernel's product)."""
    hi = (ws * x) >> np.uint64(32)
    return (w * x - hi * q) & M32


def _csub(x, m):
    return np.where(x >= m, x - m, x)


def fwd_block(a, logn, k, w, ws, q):
    """Forward transform of the rows of ``a`` [R, n] (physical, swizzled),
    canonical in, canonical out; ``w``/``ws`` the limb's tables [n]."""
    n = 1 << logn
    q = np.uint64(q)
    two_q = np.uint64(2) * q
    s = 0
    for kk in round_sizes(logn, k, inverse=False):
        idx, r, _ = group_indices(logn, s, kk, False, np.arange(n >> kk))
        phys = swizzle(idx)
        for row in a:
            x = row[phys].copy()  # the group's registers
            for j in range(kk):
                half = 1 << (kk - 1 - j)
                for i in range(1 << j):
                    t = (r << j) + i  # twiddle index of this butterfly
                    for mm in range(half):
                        u, v = i * 2 * half + mm, i * 2 * half + mm + half
                        xu = _csub(x[:, u], two_q)
                        mv = _shoup_lazy(x[:, v], w[t], ws[t], q)
                        x[:, u] = xu + mv
                        x[:, v] = xu + two_q - mv
            if s + kk == logn:
                x = _csub(_csub(x, two_q), q)
            row[phys] = x
        s += kk


def inv_block(a, logn, k, iw, iws, n_inv, n_inv_s, q):
    """Inverse transform of the rows of ``a``; the n^-1 product runs in the
    last round's registers."""
    n = 1 << logn
    q = np.uint64(q)
    two_q = np.uint64(2) * q
    s = 0
    for kk in round_sizes(logn, k, inverse=True):
        idx, r, _ = group_indices(logn, s, kk, True, np.arange(n >> kk))
        phys = swizzle(idx)
        for row in a:
            x = row[phys].copy()
            for j in range(kk):
                half = 1 << j
                for i in range(1 << (kk - 1 - j)):
                    t = (r << (kk - 1 - j)) + i
                    for mm in range(half):
                        u, v = i * 2 * half + mm, i * 2 * half + mm + half
                        xu, xv = x[:, u].copy(), x[:, v].copy()
                        x[:, u] = _csub(xu + xv, two_q)
                        x[:, v] = _shoup_lazy(xu + two_q - xv, iw[t], iws[t], q)
            if s + kk == logn:
                x = _csub(_shoup_lazy(x, np.uint64(n_inv), np.uint64(n_inv_s), q), q)
            row[phys] = x
        s += kk


def _limb_tables(tb, limb):
    get = lambda name: getattr(tb, name).numpy().astype(np.uint64)  # noqa: E731
    return (get("w")[limb], get("ws")[limb], get("iw")[limb], get("iws")[limb],
            int(tb.n_inv[limb]), int(tb.n_inv_s[limb]), int(tb.q[limb]))


def _to_smem(rows):
    """Rows [R, n] in logical order -> the swizzled shared-memory image."""
    rows = np.asarray(rows, dtype=np.uint64)
    a = np.empty_like(rows)
    a[:, swizzle(np.arange(rows.shape[1]))] = rows
    return a


def _from_smem(a):
    return a[:, swizzle(np.arange(a.shape[1]))]


def model_forward(x, tb, k):
    """The kernel's forward on int64 [..., L, n] (one block per row)."""
    lead = x.shape[:-2]
    xs = x.reshape((-1, tb.L, tb.n)).numpy()
    out = np.empty_like(xs)
    for limb in range(tb.L):
        w, ws, _, _, _, _, q = _limb_tables(tb, limb)
        a = _to_smem(xs[:, limb])
        fwd_block(a, tb.logn, k, w, ws, q)
        out[:, limb] = _from_smem(a)
    return torch.from_numpy(out.reshape(lead + (tb.L, tb.n)))


def model_inverse(x, tb, k):
    lead = x.shape[:-2]
    xs = x.reshape((-1, tb.L, tb.n)).numpy()
    out = np.empty_like(xs)
    for limb in range(tb.L):
        _, _, iw, iws, ni, nis, q = _limb_tables(tb, limb)
        a = _to_smem(xs[:, limb])
        inv_block(a, tb.logn, k, iw, iws, ni, nis, q)
        out[:, limb] = _from_smem(a)
    return torch.from_numpy(out.reshape(lead + (tb.L, tb.n)))


def _rand(rng, tb, batch):
    qs = tb.q.numpy().astype(np.uint64)[:, None]
    v = rng.integers(0, 1 << 62, size=batch + (tb.L, tb.n)).astype(np.uint64) % qs
    v[(0,) * len(batch) + (slice(None), slice(0, 3))] = qs - 1  # largest canonical
    return torch.from_numpy(v.astype(np.int64))


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------

SIZES = [64, 128, 256, 512, 1024, 2048, 4096]


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("n", SIZES)
def test_schedule_matches_plain(n, k):
    tb = _tables(n)
    x = _rand(np.random.default_rng(n + k), tb, (2,))
    spec = model_forward(x, tb, k)
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    back = model_inverse(spec, tb, k)
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("n", [64, 4096])
def test_schedule_matches_stage_engine(n, k):
    chain = _chain(n)
    tb_ref = ref_ntt.build_tables([Modulus(q) for q in chain], n, engine="stage")
    tb = _tables(n)
    x = _rand(np.random.default_rng(7 * n + k), tb, (1,))
    want = np.asarray(jax.jit(lambda v: ref_ntt.forward(v, tb_ref))(
        jnp.asarray(x.numpy().astype(np.uint32)))).astype(np.int64)
    assert (model_forward(x, tb, k).numpy() == want).all()
    back = np.asarray(jax.jit(lambda v: ref_ntt.inverse(v, tb_ref))(
        jnp.asarray(want.astype(np.uint32)))).astype(np.int64)
    assert (model_inverse(torch.from_numpy(want), tb, k).numpy() == back).all()


def _bank_degree(words):
    """Shared-memory wavefronts of one warp-wide 4-byte access."""
    banks = {}
    for wd in words:
        banks.setdefault(int(wd) % 32, set()).add(int(wd))
    return max(len(v) for v in banks.values())


def _vector_degree(words4):
    """Wavefronts per quarter-warp of a 16-byte access (first word of each
    lane's unit): the 8 lanes of a phase must cover 8 distinct bank quads."""
    worst = 1
    for ph in range(0, WARP, 8):
        quads = {}
        for wd in words4[ph:ph + 8]:
            quads.setdefault((int(wd) >> 2) % 8, set()).add(int(wd))
        worst = max([worst] + [len(v) for v in quads.values()])
    return worst


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("logn", range(6, 16))
def test_exchange_pattern(logn, k):
    """Each round reads and writes every element once; scalar rounds are at
    most 2-way bank conflicted, the stride-1 rounds vectorise conflict-free."""
    n = 1 << logn
    for inverse in (False, True):
        s = 0
        for kk in round_sizes(logn, k, inverse):
            groups = np.arange(n >> kk)
            idx, r, logt = group_indices(logn, s, kk, inverse, groups)
            assert sorted(idx.ravel().tolist()) == list(range(n))
            phys = swizzle(idx)
            assert sorted(phys.ravel().tolist()) == list(range(n))
            if logt == 0:
                assert kk >= 2 and (idx[:, 0] % 4 == 0).all()
                # 4-word units stay whole and in order under the swizzle.
                assert (phys[:, 1::4] == phys[:, 0::4] + 1).all()
            # Twiddle nodes: one per group, inside the table's [1, n) range.
            top = (r << (kk - 1)) + (1 << (kk - 1)) - 1
            assert r.min() >= 1 and top.max() < n
            for w0 in range(0, min(len(groups), 8 * WARP), WARP):
                warp = phys[w0:w0 + WARP]
                if logt == 0:
                    for c in range(0, 1 << kk, 4):
                        assert _vector_degree(warp[:, c]) == 1
                else:
                    for m in range(1 << kk):
                        assert _bank_degree(warp[:, m]) <= 2
            s += kk


# ---------------------------------------------------------------------------
# The fused BEHZ kernels' flows
# ---------------------------------------------------------------------------


def _ctx(n):
    chain = (268432897, 268428161, 134217089) if n == 64 else tpu_default(n)
    return bfv.BFVContext.build(
        bfv.EncryptionParameters.bfv(n, 1 << 16, coeff_modulus=chain), "cpu")


def _cts(ctx, batch, seed):
    rng = np.random.default_rng(seed)
    return [_rand(rng, ctx.tables, batch) for _ in range(4)]


def _mulmod(a, b, q):
    """Exact a * b mod q (the kernel's Barrett reduction is exact)."""
    return (a.astype(object) * b.astype(object) % int(q)).astype(np.uint64)


def model_tensor_ntt(polys, tbx, k):
    """One block per (batch, limb): forward x 4 in shared memory, the
    Karatsuba products, inverse x 3 -> [3, B, Lx, n]."""
    xs = [p.reshape((-1, tbx.L, tbx.n)).numpy().astype(np.uint64) for p in polys]
    B = xs[0].shape[0]
    out = np.empty((3, B, tbx.L, tbx.n), dtype=np.uint64)
    for b in range(B):
        for limb in range(tbx.L):
            w, ws, iw, iws, ni, nis, q = _limb_tables(tbx, limb)
            a = _to_smem([x[b, limb] for x in xs])
            fwd_block(a, tbx.logn, k, w, ws, q)
            a0, a1, b0, b1 = a  # the same swizzled positions in every row
            e0, e2 = _mulmod(a0, b0, q), _mulmod(a1, b1, q)
            cross = _mulmod((a0 + a1) % np.uint64(q), (b0 + b1) % np.uint64(q), q)
            e1 = (cross + 2 * np.uint64(q) - e0 - e2) % np.uint64(q)
            e = np.stack([e0, e1, e2])
            inv_block(e, tbx.logn, k, iw, iws, ni, nis, q)
            out[:, b, limb] = _from_smem(e)
    return torch.from_numpy(out.astype(np.int64))


@pytest.mark.parametrize("k", [3, 4])
def test_fused_tensor_flow_matches_plain(k):
    ctx = _ctx(64)
    mul = behz.multiplier(ctx)
    polys = _cts(ctx, (2,), 11)
    x = torch.stack(polys)
    xb = mul._to_bsk(x)
    for src, tbx in ((x, ctx.tables), (xb, mul.bsk_tables)):
        got = model_tensor_ntt(list(src), tbx, k)
        spec = ntt.forward_plain(src, tbx)
        assert torch.equal(got, ntt.inverse_plain(mul.tensor_spectra(spec, tbx), tbx))


def model_relin_ntt(c0, c1, c2, ctx, rlk, k):
    """One block per (batch, limb d): for each digit g, lift into limb d,
    forward, accumulate the key products; inverse both accumulators, add."""
    tb = ctx.tables
    groups = rlk.digit_groups(ctx.L)
    qs = [m.value for m in ctx.moduli]
    keys = [t.numpy().astype(np.uint64) for t in (rlk.k0, rlk.k0_shoup, rlk.k1,
                                                   rlk.k1_shoup)]
    cs = [c.reshape((-1, ctx.L, ctx.n)).numpy().astype(np.uint64) for c in (c0, c1, c2)]
    B = cs[0].shape[0]
    out = np.empty((2, B, ctx.L, ctx.n), dtype=np.uint64)
    for b in range(B):
        for d in range(ctx.L):
            w, ws, iw, iws, ni, nis, q = _limb_tables(tb, d)
            qd = np.uint64(q)
            acc = np.zeros((2, ctx.n), dtype=np.uint64)  # spectral, swizzled
            for g, group in enumerate(groups):
                r0 = cs[2][b, group[0]]
                if len(group) == 1:
                    dig = r0 % qd
                else:
                    q0, q1 = qs[group[0]], qs[group[1]]
                    r1 = cs[2][b, group[1]]
                    inv01 = pow(q0, -1, q1)
                    diff = (r1 + np.uint64(q1) - r0 % np.uint64(q1)) % np.uint64(q1)
                    t = _csub(_shoup_lazy(diff, np.uint64(inv01),
                                          np.uint64((inv01 << 32) // q1), np.uint64(q1)),
                              np.uint64(q1))
                    qm = q0 % q
                    dig = (r0 % qd + _csub(_shoup_lazy(t, np.uint64(qm),
                                                       np.uint64((qm << 32) // q), qd),
                                           qd)) % qd
                a = _to_smem([dig])
                fwd_block(a, ctx.tables.logn, k, w, ws, q)
                key = [kk_[g, d][swizzle(np.arange(ctx.n))] for kk_ in keys]
                for j in range(2):
                    prod = _csub(_shoup_lazy(a[0], key[2 * j], key[2 * j + 1], qd), qd)
                    acc[j] = _csub(acc[j] + prod, qd)
            inv_block(acc, ctx.tables.logn, k, iw, iws, ni, nis, q)
            dd = _from_smem(acc)
            for j in range(2):
                out[j, b, d] = _csub(cs[j][b, d] + dd[j], qd)
    return torch.from_numpy(out.astype(np.int64))


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("width", [1, 2])
def test_fused_relin_digit_loop_matches_plain(width, k):
    ctx = _ctx(64)  # 3 limbs: width 2 has a two-limb and a one-limb digit
    g = torch.Generator().manual_seed(width)
    sk, _ = behz.make_keys(ctx, g)
    rlk = behz.create_relin_keys(ctx, sk, g, width=width)
    assert len(rlk.digit_groups(ctx.L)) == -(-ctx.L // width)
    c0, c1, c2, _ = _cts(ctx, (2,), 3 + width)
    want = behz.relinearize(ctx, bfv.Ciphertext((c0, c1, c2), "coeff"), rlk)
    got = model_relin_ntt(c0, c1, c2, ctx, rlk, k)
    assert torch.equal(got[0], want.polys[0])
    assert torch.equal(got[1], want.polys[1])


# ---------------------------------------------------------------------------
# measure_multiply's shape-derived counts
# ---------------------------------------------------------------------------


def test_work_counts_give_the_issue_figures():
    """Batch 256, n = 4096, L = 4, |B_sk| = 6, D = 2 (width-2 keys)."""
    w = work_counts(n=4096, L=4, K=6, D=2, batch=256)
    assert w["ntt_forward"]["rows"] == 12_288
    assert w["ntt_inverse"]["rows"] == 9_728
    assert round(w["ntt_forward"]["mulmods"] / 1e6, 1) == 302.0
    assert round(w["ntt_inverse"]["mulmods"] / 1e6, 1) == 278.9
    assert round(w["ntt_forward"]["bytes"] / 1e6, 1) == 402.7
    assert round(w["ntt_inverse"]["bytes"] / 1e6, 1) == 318.8
    assert round(w["to_bsk"]["bytes"] / 1e6, 1) == 167.8
    assert round(w["floor_sk"]["bytes"] / 1e6, 1) == 176.2
    assert round(w["tensor"]["bytes"] / 1e6, 1) == 293.6
    assert [round(w[p]["bytes"] / 1e6, 1) for p in ("keyprod", "add", "lift")] == [
        67.1, 100.7, 50.3]


@pytest.mark.parametrize("n,fused", [(4096, ("behz_tensor_ntt", "behz_relin_ntt")),
                                     (16384, ("behz_relin_ntt",)), (32768, ())])
def test_kernel_counts_follow_the_route(n, fused):
    """Per-kernel counts sum to the logical work, whichever route runs."""
    L, K, D, B = 4, 6, 2, 8
    w = work_counts(n=n, L=L, K=K, D=D, batch=B)
    kc = kernel_counts(n=n, L=L, K=K, D=D, batch=B)
    assert set(fused) <= set(kc)
    assert sum(v["mulmods"] for v in kc.values()) == sum(v["mulmods"] for v in w.values())
    assert all(v["bound_ms"] > 0 and v["bound_by"] in ("bytes", "operations")
               for v in kc.values())
    if not fused:
        assert kc["ntt_forward_u32"]["rows"] == w["ntt_forward"]["rows"]
