"""A numpy model of the Hopper NTT kernels' index schedule (``csrc/ntt.cu``):
the m31 kernels on u32 words and the m62 kernels on u64 words.

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
* ``measure_multiply``'s shape-derived counts;
* the u64 kernels (``csrc/ntt_block64.cuh``): the same rounds on 8-byte
  words under ``swizzle64``, interleaved twiddle pairs, lazy values below 4q
  (forward) and 2q (inverse) with 4q < 2^64, several rows of a limb per block
  with a tail block, and a row spread over a cluster of 2^cl blocks (the
  forward's first round from device memory into the blocks' shared memory,
  each block's part as the sub-transform 2^cl + rank; the inverse mirrored),
  against ``forward_plain``/``inverse_plain`` on m62 tables and the stage
  engine on (lo, hi) pairs.

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
from pplp_tpu_torch.ops.primes import bfv_default, get_primes, tpu_default

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


def group_indices(logn, s, kk, inverse, groups, top=1):
    """Row indices [G, 2^kk] held by each group of a round at stage s, the
    group's twiddle node r, and log2 of the element stride. ``top`` is the
    part of a larger transform that the 2^logn points are (1: the whole)."""
    logt = s if inverse else logn - s - kk
    lo = groups & ((1 << logt) - 1)
    hi = groups >> logt
    base = (hi << (logt + kk)) + lo
    idx = base[:, None] + (np.arange(1 << kk)[None, :] << logt)
    r = (top << (logn - s - kk if inverse else s)) + hi
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


def swizzle64(i):
    """Shared-memory u64 word of logical element i: 16-byte units (two words)
    XOR-permuted within each 128-byte line."""
    return i ^ (((i >> 4) & 7) << 1)


def _degree64(words):
    """Wavefronts of one warp-wide 8-byte access: the warp goes as two
    half-warps, each conflict-free when its 16 lanes touch 16 distinct
    8-byte bank pairs."""
    worst = 1
    for ph in range(0, WARP, 16):
        pairs = {}
        for wd in words[ph:ph + 16]:
            pairs.setdefault(int(wd) % 16, set()).add(int(wd))
        worst = max([worst] + [len(v) for v in pairs.values()])
    return worst


def _vector_degree64(words2):
    """Wavefronts per quarter-warp of a 16-byte access (first u64 word of
    each lane's unit): 8 lanes must cover the 8 distinct 16-byte bank groups."""
    worst = 1
    for ph in range(0, WARP, 8):
        units = {}
        for wd in words2[ph:ph + 8]:
            units.setdefault((int(wd) >> 1) % 8, set()).add(int(wd))
        worst = max([worst] + [len(v) for v in units.values()])
    return worst


# bytes of a word -> (swizzle, words per 16-byte unit, scalar and vector conflict degree)
WORDS = {4: (swizzle, 4, _bank_degree, _vector_degree),
         8: (swizzle64, 2, _degree64, _vector_degree64)}


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("logn", range(6, 16))
def test_exchange_pattern(logn, k, word):
    """Each round reads and writes every element once; scalar rounds are at
    most 2-way bank conflicted, the stride-1 rounds vectorise conflict-free.
    On 4-byte words (m31) and on 8-byte words (m62, up to the 16,384 points
    a block's shared memory takes)."""
    if word == 8 and logn == 15:
        logn = 14
    swz, unit, degree, vector_degree = WORDS[word]
    n = 1 << logn
    for inverse in (False, True):
        s = 0
        for kk in round_sizes(logn, k, inverse):
            groups = np.arange(n >> kk)
            idx, r, logt = group_indices(logn, s, kk, inverse, groups)
            assert sorted(idx.ravel().tolist()) == list(range(n))
            phys = swz(idx)
            assert sorted(phys.ravel().tolist()) == list(range(n))
            if logt == 0:
                assert (1 << kk) >= unit and (idx[:, 0] % unit == 0).all()
                # 16-byte units stay whole and in order under the swizzle.
                for c in range(1, unit):
                    assert (phys[:, c::unit] == phys[:, 0::unit] + c).all()
            # Twiddle nodes: one per group, inside the table's [1, n) range.
            top = (r << (kk - 1)) + (1 << (kk - 1)) - 1
            assert r.min() >= 1 and top.max() < n
            for w0 in range(0, min(len(groups), 8 * WARP), WARP):
                warp = phys[w0:w0 + WARP]
                if logt == 0:
                    for c in range(0, 1 << kk, unit):
                        assert vector_degree(warp[:, c]) == 1
                else:
                    for m in range(1 << kk):
                        assert degree(warp[:, m]) <= 2
            s += kk


# ---------------------------------------------------------------------------
# The u64 (m62) schedule (mirrors csrc/ntt_block64.cuh and csrc/ntt.cu)
# ---------------------------------------------------------------------------

K64 = 3  # kRadixLog64, the radix the kernels are built with
CLUSTER_LOG = {12: 1, 13: 1, 14: 1, 15: 2}  # cluster_log: log2 of the blocks a row takes
MIN_GROUPS = 256  # kMinGroups: a block's least work, where the batch has it


def _umul64hi(a, b):
    """High 64 bits of a 64 x 64-bit product, from 32-bit halves (exact)."""
    a0, a1, b0, b1 = a & M32, a >> np.uint64(32), b & M32, b >> np.uint64(32)
    p01, p10 = a0 * b1, a1 * b0
    mid = ((a0 * b0) >> np.uint64(32)) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (mid >> np.uint64(32))


def _u64(v):
    """An int64 bit pattern (a Shoup companion may reach 2^64 - 1) as u64."""
    return np.uint64(int(v) % (1 << 64))


def _shoup_lazy64(x, w, ws, q):
    """w x - umul64hi(ws, x) q in wrapping u64 (the kernel's product)."""
    return np.asarray(w) * x - _umul64hi(np.asarray(ws), x) * q


def fwd_stages64(x, kk, r, w, ws, q):
    """kk forward stages on the groups' registers x [G, 2^kk] (twiddle node
    r per group), in place: every value stays below 4q < 2^64."""
    two_q = np.uint64(2) * q
    for j in range(kk):
        half = 1 << (kk - 1 - j)
        for i in range(1 << j):
            t = (r << j) + i
            for mm in range(half):
                u, v = i * 2 * half + mm, i * 2 * half + mm + half
                assert x[:, u].max() < 2 * two_q
                xu = _csub(x[:, u], two_q)
                mv = _shoup_lazy64(x[:, v], w[t], ws[t], q)
                assert mv.max() < two_q
                x[:, u] = xu + mv
                x[:, v] = xu + two_q - mv


def inv_stages64(x, kk, r, iw, iws, q):
    """kk inverse stages, in place: every value stays below 2q."""
    two_q = np.uint64(2) * q
    for j in range(kk):
        half = 1 << j
        for i in range(1 << (kk - 1 - j)):
            t = (r << (kk - 1 - j)) + i
            for mm in range(half):
                u, v = i * 2 * half + mm, i * 2 * half + mm + half
                xu, xv = x[:, u].copy(), x[:, v].copy()
                assert max(xu.max(), xv.max()) < two_q
                x[:, u] = _csub(xu + xv, two_q)
                x[:, v] = _shoup_lazy64(xu + two_q - xv, iw[t], iws[t], q)


def fwd_block64(a, logm, k, w, ws, q, top=1, s_begin=0):
    """ntt_fwd_block64: forward stages s_begin .. logm - 1 of the part
    ``top`` on the rows of ``a`` [R, 2^logm] (physical, swizzled)."""
    q = np.uint64(q)
    assert 4 * int(q) < 1 << 64
    s = s_begin
    for kk in round_sizes(logm - s_begin, k, inverse=False):
        idx, r, logt = group_indices(logm, s, kk, False, np.arange((1 << logm) >> kk), top)
        phys = swizzle64(idx)
        for row in a:
            x = row[phys].copy()
            fwd_stages64(x, kk, r, w, ws, q)
            if logt == 0:
                x = _csub(_csub(x, np.uint64(2) * q), q)
            row[phys] = x
        s += kk


def inv_block64(a, logm, k, iw, iws, n_inv, n_inv_s, q, top=1, s_end=None):
    """ntt_inv_block64: inverse stages 0 .. s_end - 1 of the part ``top``;
    the last round of a whole transform (top = 1) multiplies by n^-1."""
    q = np.uint64(q)
    s = 0
    for kk in round_sizes(logm if s_end is None else s_end, k, inverse=True):
        idx, r, _ = group_indices(logm, s, kk, True, np.arange((1 << logm) >> kk), top)
        phys = swizzle64(idx)
        for row in a:
            x = row[phys].copy()
            inv_stages64(x, kk, r, iw, iws, q)
            if top == 1 and s + kk == logm:
                x = _csub(_shoup_lazy64(x, _u64(n_inv), _u64(n_inv_s), q), q)
            row[phys] = x
        s += kk


def _to_smem64(rows):
    rows = np.asarray(rows, dtype=np.uint64)
    a = np.empty_like(rows)
    a[:, swizzle64(np.arange(rows.shape[1]))] = rows
    return a


def _from_smem64(a):
    return a[:, swizzle64(np.arange(a.shape[1]))]


def rows_per_block64(n, batch, k=K64):
    """shape_u64: rows of one limb per block."""
    groups = n >> k
    return min(1 if groups >= MIN_GROUPS else MIN_GROUPS // groups, batch)


def block_rows64(block, batch, L, rpb):
    """The limb of a block of the row kernels and the rows [batch * L, n] it
    holds: batch entries b0 .. of limb block % L, L rows apart; the tail
    block has fewer."""
    limb, b0 = block % L, (block // L) * rpb
    rows = min(rpb, batch - b0)
    return limb, (b0 * L + limb) + L * np.arange(rows)


def cluster_shape64(logn, k=K64):
    """shape_u64's choice for a row of 2^logn: (stages of the cluster round,
    log2 of the cluster's blocks), or None for the row kernels."""
    if logn < 12:
        return None
    return (logn - 1) % k + 1, CLUSTER_LOG[logn]


def cluster_exchange(logn, kk, cl, rank):
    """The cluster-round groups of block ``rank`` of a 2^cl-block cluster:
    the row indices [G, 2^kk] it reads from device memory, and for each
    element the block whose shared memory holds it and the (swizzled) word
    there."""
    logt = logn - kk
    lo = rank * (1 << (logt - cl)) + np.arange(1 << (logt - cl))
    m = np.arange(1 << kk)
    idx = lo[:, None] + (m[None, :] << logt)
    part = np.broadcast_to(m >> (kk - cl), idx.shape)
    word = swizzle64(((m[None, :] & ((1 << (kk - cl)) - 1)) << logt) + lo[:, None])
    return idx, part, word


def cluster_forward64(x, logn, k, kk, cl, w, ws, q):
    """ntt_forward_u64_cluster_kernel on one row [n]: the first kk stages
    from device memory into the blocks' shared memory, then each block's
    part 2^cl + rank, beginning at its local stage kk - cl."""
    q = np.uint64(q)
    h = 1 << (logn - cl)
    smem = np.zeros((1 << cl, h), dtype=np.uint64)
    for rank in range(1 << cl):
        idx, part, word = cluster_exchange(logn, kk, cl, rank)
        v = x[idx].copy()
        fwd_stages64(v, kk, np.ones(len(idx), dtype=np.int64), w, ws, q)
        smem[part, word] = v
    out = np.empty(h << cl, dtype=np.uint64)
    for rank in range(1 << cl):
        a = smem[rank][None, :]
        fwd_block64(a, logn - cl, k, w, ws, q, top=(1 << cl) + rank, s_begin=kk - cl)
        out[rank * h:(rank + 1) * h] = _from_smem64(a)[0]
    return out


def cluster_inverse64(x, logn, k, kk, cl, iw, iws, n_inv, n_inv_s, q):
    """ntt_inverse_u64_cluster_kernel on one row: each block's part through
    its local stages 0 .. logn - kk - 1, then the last kk stages and the
    n^-1 product from the blocks' shared memory to device memory."""
    q = np.uint64(q)
    h = 1 << (logn - cl)
    smem = np.concatenate([_to_smem64(x[None, r * h:(r + 1) * h]) for r in range(1 << cl)])
    for rank in range(1 << cl):
        inv_block64(smem[rank][None, :], logn - cl, k, iw, iws, n_inv, n_inv_s, q,
                    top=(1 << cl) + rank, s_end=logn - kk)
    out = np.empty(h << cl, dtype=np.uint64)
    for rank in range(1 << cl):
        idx, part, word = cluster_exchange(logn, kk, cl, rank)
        v = smem[part, word]
        inv_stages64(v, kk, np.ones(len(idx), dtype=np.int64), iw, iws, q)
        out[idx] = _csub(_shoup_lazy64(v, _u64(n_inv), _u64(n_inv_s), q), q)
    return out


def model_transform64(x, tb, k, inverse, cluster=None):
    """The u64 kernels on int64 [..., L, n]: the row kernels block by block,
    or every row through a cluster ``(kk, cl)``; the kernels' own choice
    (``cluster_shape64``) unless one is given."""
    lead = x.shape[:-2]
    flat = x.reshape((-1, tb.n)).numpy().astype(np.uint64)
    batch = flat.shape[0] // tb.L
    out = np.zeros_like(flat)
    done = np.zeros(len(flat), dtype=np.int64)
    if cluster is None:
        cluster = cluster_shape64(tb.logn, k)
    if cluster:
        blocks = [(r % tb.L, np.array([r])) for r in range(len(flat))]
    else:
        rpb = rows_per_block64(tb.n, batch, k)
        blocks = [block_rows64(b, batch, tb.L, rpb) for b in range(-(-batch // rpb) * tb.L)]
    for limb, rows in blocks:
        w, ws, iw, iws, ni, nis, q = _limb_tables(tb, limb)
        if cluster and inverse:
            out[rows[0]] = cluster_inverse64(flat[rows[0]], tb.logn, k, *cluster, iw, iws,
                                             ni, nis, q)
        elif cluster:
            out[rows[0]] = cluster_forward64(flat[rows[0]], tb.logn, k, *cluster, w, ws, q)
        else:
            a = _to_smem64(flat[rows])
            if inverse:
                inv_block64(a, tb.logn, k, iw, iws, ni, nis, q)
            else:
                fwd_block64(a, tb.logn, k, w, ws, q)
            out[rows] = _from_smem64(a)
        done[rows] += 1
    assert (done == 1).all()  # every row in exactly one block
    return torch.from_numpy(out.astype(np.int64).reshape(lead + (tb.L, tb.n)))


def _chain62(n):
    """The seal chain where there is one (n >= 4096), else 36-, 44- and
    61-bit primes (4q just below 2^64)."""
    if n >= 4096:
        return list(bfv_default(n))
    return [get_primes(b, 1, n)[0] for b in (36, 44, 61)]


def _tables62(n):
    tb = ntt.build_tables([PortModulus(q) for q in _chain62(n)], n, "cpu")
    assert tb.profile == "m62"
    return tb


ROW_KERNEL = False  # model_transform64's ``cluster`` for the row kernels


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("n", SIZES)
def test_u64_schedule_matches_plain(n, k):
    """The in-block transform on whole rows, at both radices."""
    tb = _tables62(n)
    x = _rand(np.random.default_rng(62 * n + k), tb, (2,))
    spec = model_transform64(x, tb, k, False, ROW_KERNEL)
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    back = model_transform64(spec, tb, k, True, ROW_KERNEL)
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)


@pytest.mark.parametrize("n,batch", [(64, 35), (64, 5), (256, 9), (1024, 3)])
def test_u64_rows_per_block_and_tail(n, batch):
    """Several rows of one limb per block; the last block of a limb takes the
    rows that are left; extreme inputs (all q - 1, all 0) in two entries."""
    tb = _tables62(n)
    assert cluster_shape64(tb.logn) is None
    rpb = rows_per_block64(n, batch)
    assert rpb == min(MIN_GROUPS // (n >> K64), batch) and rpb > 1
    assert (batch % rpb != 0) == ((n, batch) != (64, 5))  # a tail, but for one case
    x = _rand(np.random.default_rng(n + batch), tb, (batch,))
    x[1] = tb.q_b(1) - 1
    x[2] = 0
    spec = model_transform64(x, tb, K64, inverse=False)
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    assert torch.equal(model_transform64(spec, tb, K64, inverse=True), x)


# (stages of the cluster round, log2 of the blocks): what the kernels run at
# logn = 12 .. 15, and a cluster of 8.
CLUSTERS = [(3, 1), (1, 1), (2, 1), (3, 2), (3, 3)]


@pytest.mark.parametrize("cluster", CLUSTERS, ids=str)
@pytest.mark.parametrize("n", [64, 512, 4096])
def test_u64_cluster_matches_plain(n, cluster):
    """A row over a cluster of blocks, the code path of n = 4096 .. 32768, at
    every cluster shape the kernels use."""
    tb = _tables62(n)
    x = _rand(np.random.default_rng(n + sum(cluster)), tb, (2,))
    spec = model_transform64(x, tb, K64, False, cluster)
    assert torch.equal(spec, ntt.forward_plain(x, tb))
    back = model_transform64(spec, tb, K64, True, cluster)
    assert torch.equal(back, ntt.inverse_plain(spec, tb))
    assert torch.equal(back, x)


@pytest.mark.parametrize("logn", range(12, 16))
def test_u64_cluster_exchange_indices(logn):
    """After the cluster round block r holds the part r of the row (the
    sub-blocks r 2^(kk-cl) .. of its 2^kk), each word written once, a share
    1 - 2^-cl of a block's elements going to its peers; every later round has
    k stages and reads twiddle nodes inside the limb's table."""
    n = 1 << logn
    kk, cl = cluster_shape64(logn)
    assert (cl, (n << 3) >> cl) == (CLUSTER_LOG[logn], min(n << 2, 1 << 16))  # <= 64 KB a block
    assert (logn - kk) % K64 == 0 and kk >= cl
    h = n >> cl
    seen = np.zeros((1 << cl, h), dtype=np.int64)
    read = np.zeros(n, dtype=np.int64)
    for rank in range(1 << cl):
        idx, part, word = cluster_exchange(logn, kk, cl, rank)
        read[idx] += 1
        assert (idx // h == part).all()  # the block that holds the element's part
        assert (swizzle64(idx - part * h) == word).all()
        assert ((idx // (n >> kk)) >> (kk - cl) == part).all()
        assert (part != rank).mean() == 1 - 1 / (1 << cl)
        np.add.at(seen, (part, word), 1)
        # neighbouring threads read neighbouring device-memory words
        assert (np.diff(idx, axis=0) == 1).all()
    assert (seen == 1).all() and (read == 1).all()
    for inverse in (False, True):
        for rank in range(1 << cl):
            s = 0 if inverse else kk - cl
            for size in round_sizes(logn - kk, K64, inverse):
                assert size == K64
                groups = np.arange(h >> size)
                idx, r, _ = group_indices(logn - cl, s, size, inverse, groups,
                                          top=(1 << cl) + rank)
                assert sorted(idx.ravel().tolist()) == list(range(h))
                top = (r << (size - 1)) + (1 << (size - 1)) - 1
                assert r.min() >= 1 and top.max() < n
                s += size


@pytest.mark.parametrize("n", [64, 4096])
def test_u64_schedule_matches_stage_engine(n):
    """Against ``pplp_tpu.ops.ntt`` on (lo, hi) u32 pairs: the row kernels
    and the cluster path (at n = 4096 the kernels' own choice; the cluster
    of four at both)."""
    chain = _chain62(n)
    tb_ref = ref_ntt.build_tables([Modulus(q) for q in chain], n)
    tb = _tables62(n)
    assert tb_ref.profile == "m62"
    x = _rand(np.random.default_rng(9 * n), tb, (1,))

    def pair(v):
        v = v.numpy().astype(np.uint64)
        return (jnp.asarray((v & M32).astype(np.uint32)),
                jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))

    def unpair(p):
        lo, hi = (np.asarray(a).astype(np.uint64) for a in p)
        return torch.from_numpy((lo | (hi << np.uint64(32))).view(np.int64))

    want = unpair(jax.jit(lambda v: ref_ntt.forward(v, tb_ref))(pair(x)))
    back = unpair(jax.jit(lambda v: ref_ntt.inverse(v, tb_ref))(pair(want)))
    for cluster in (ROW_KERNEL, None, (3, 2)):
        assert torch.equal(model_transform64(x, tb, K64, False, cluster), want)
        assert torch.equal(model_transform64(want, tb, K64, True, cluster), back)


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
