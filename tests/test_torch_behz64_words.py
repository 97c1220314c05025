"""A word-level model of the m62 base-conversion kernels' arithmetic
(``pplp_tpu_torch/csrc/behz64.cu``: ``to_bsk64_kernel``,
``floor_sk64_kernel``), held against exact Python integers.

The model mirrors the kernels operation for operation in Python integers
masked to 32 or 64 bits where the kernel's registers are that wide:

* ``split2`` / ``Cols.mac`` / ``Sum2``: a value split into two words at bit
  31 (a residue mod q) or 30 (below 2^60), its constant split at 61 minus
  that, four 32 x 32 + 64-bit multiply-adds into u64 columns of weight 1,
  2^30, 2^31 and 2^61, folded into a 128-bit total every eight terms;
* ``reduce128``: z mod q for z < 2^128 by r = floor(2^128 / q) with its
  high word below 2^32, from 11 partial products and two conditional
  subtracts;
* the kernels' per-coefficient dataflow on the constants that
  ``ops.behz64_cuda._pack_constants`` folds, read through the kernels'
  buffer layouts, against the plain ``RnsMultiplier`` steps;
* the tile schedule (``conv_shape``, ``tile_pos``): every coefficient of
  every row exactly once.

Exact comparisons; no card and no JAX needed.
"""

import random

import numpy as np
import pytest
import torch

from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz
from pplp_tpu_torch.ops import behz64_cuda, primes
from pplp_tpu_torch.ops.primes import bfv_default, get_primes

M32, M64, M128 = (1 << 32) - 1, (1 << 64) - 1, (1 << 128) - 1
FOLD_TERMS = 8  # kFoldTerms
PAIR_THREADS = 128  # kPairThreads
CONV_SMEM = 100 * 1024  # kConvSmem


# ---------------------------------------------------------------------------
# The kernels' arithmetic, word for word
# ---------------------------------------------------------------------------


def mad_wide(x, y, acc):
    """IMAD.WIDE.U32: x y + acc for 32-bit x, y, wrapping at 64 bits."""
    assert 0 <= x <= M32 and 0 <= y <= M32 and 0 <= acc <= M64
    return (x * y + acc) & M64


def split(y, q_kind):
    s = 31 if q_kind else 30
    return y & ((1 << s) - 1), (y >> s) & M32


class Cols:
    """The four u64 columns of a sum, by weight 1, 2^30, 2^31, 2^61."""

    def __init__(self):
        self.a = self.w30 = self.w31 = self.d = 0

    def mac(self, ya, yb, c, q_kind):
        cx, cy = c & M32, c >> 32
        self.a = mad_wide(ya, cx, self.a)
        if q_kind:
            self.w30 = mad_wide(ya, cy, self.w30)
            self.w31 = mad_wide(yb, cx, self.w31)
        else:
            self.w31 = mad_wide(ya, cy, self.w31)
            self.w30 = mad_wide(yb, cx, self.w30)
        self.d = mad_wide(yb, cy, self.d)

    def fold(self):
        return (self.a + (self.w30 << 30) + (self.w31 << 31) + (self.d << 61)) & M128


class Sum:
    """One coefficient's ``Sum2``: a 128-bit total and the open columns."""

    def __init__(self):
        self.t, self.s, self.open = 0, Cols(), 0

    def add(self, y_words, c, q_kind):
        if self.open == FOLD_TERMS:
            self.flush()
        self.s.mac(*y_words, c, q_kind)
        self.open += 1

    def flush(self):
        self.t = (self.t + self.s.fold()) & M128
        self.s, self.open = Cols(), 0
        return self.t


def reduce128(z, q, r0, rh):
    """behz64.cu's reduce128: z mod q, z < 2^128, r = rh 2^64 + r0."""
    assert 0 <= z <= M128 and rh <= M32
    z0, z1 = z & M64, z >> 64
    z00, z01, z10, z11 = z0 & M32, z0 >> 32, z1 & M32, z1 >> 32
    r00, r01 = r0 & M32, r0 >> 32
    u = z00 * rh
    v = mad_wide(z01, rh, u >> 32)
    s_lo, s_hi = ((v << 32) | (u & M32)) & M64, v >> 32
    p = z10 * r00
    m1 = mad_wide(z10, r01, p >> 32)
    m2 = mad_wide(z11, r00, m1 & M32)
    c_lo = ((m2 << 32) | (p & M32)) & M64
    c_hi = mad_wide(z11, r01, (m1 >> 32) + (m2 >> 32))
    w1 = (s_lo + c_lo) & M64
    z1rh = mad_wide(z10, rh, ((z11 * rh) & M32) << 32)
    est = (s_hi + c_hi + (1 if w1 < s_lo else 0) + z1rh) & M64
    x = (z0 - est * q) & M64
    assert x < 3 * q, "the estimate is the quotient or at most two less"
    for _ in range(2):
        x = x - q if x >= q else x
    return x


def ratio_words(q):
    r = (1 << 128) // q
    return r & M64, r >> 64


def shoup64(x, w, ws, q):
    """csub64(shoup_lazy64(x, w, w', q), q)."""
    v = (w * x - ((ws * x) >> 64) * q) & M64
    return v - q if v >= q else v


def exact_dot(terms):
    return sum(y * c for y, c, _ in terms)


def model_dot(terms):
    """sum y c over (y, c, q_kind) terms through ``Sum``: c is split here
    at 61 minus y's split, as ``behz64_cuda._split`` packs it."""
    s = Sum()
    for y, c, q_kind in terms:
        (packed,) = behz64_cuda._split([c], 30 if q_kind else 31)
        s.add(split(y, q_kind), packed, q_kind)
    return s.flush()


# ---------------------------------------------------------------------------
# Sums of products
# ---------------------------------------------------------------------------


def _term(rng, q_kind, top=False):
    """A term's (source, constant): a residue mod q below 2^62 with a constant
    below 2^60, or a value below 2^60 with a constant below 2^62."""
    y_bits, c_bits = (62, 60) if q_kind else (60, 62)
    if top:
        return (1 << y_bits) - 1, (1 << c_bits) - 1, q_kind
    return rng.getrandbits(y_bits), rng.getrandbits(c_bits), q_kind


def test_sums_match_exact_on_random_terms():
    rng = random.Random(7)
    for _ in range(300):
        count = rng.randint(1, 88)
        terms = [_term(rng, rng.random() < 0.5) for _ in range(count)]
        if exact_dot(terms) > M128:
            continue
        assert model_dot(terms) == exact_dot(terms)


# (source, constant, q_kind) at their largest: a residue mod q times a
# constant mod a B_sk prime; a B_sk value times a constant mod a B_sk prime;
# a B_sk value times a constant mod q.
Q_TOP = ((1 << 62) - 1, (1 << 60) - 1, True)
B_TOP_B = ((1 << 60) - 1, (1 << 60) - 1, False)
B_TOP_Q = ((1 << 60) - 1, (1 << 62) - 1, False)


@pytest.mark.parametrize("shape", ["to_bsk", "y_prime", "alpha", "out"])
def test_sums_at_the_bounds(shape):
    """The widest sums at L = 40, K = 48 with every factor at its largest:
    up to 1.625 x 2^127, exact."""
    L, K = behz64_cuda.MAX_L, behz64_cuda.MAX_K
    terms = {"to_bsk": [Q_TOP] * L + [((1 << 16) - 1, (1 << 60) - 1, True)],
             "y_prime": [Q_TOP] * L + [B_TOP_B],
             "alpha": [B_TOP_B] * K + [Q_TOP] * L,
             "out": [B_TOP_Q] * K}[shape]
    want = exact_dot(terms)
    assert want < 1.625 * 2 ** 127
    assert model_dot(terms) == want
    if shape == "to_bsk":
        assert want > 2 ** 127.3  # 40 products of 62 and 60 bits


def test_eight_terms_fill_a_column():
    """Eight of the largest partial products fit a u64 column; a ninth
    would wrap it (kFoldTerms is the most that fits)."""
    top = ((1 << 31) - 1) * ((1 << 30) - 1)
    assert FOLD_TERMS * top <= M64 < (FOLD_TERMS + 1) * top


# ---------------------------------------------------------------------------
# The 128-bit reduction
# ---------------------------------------------------------------------------

_MODULI = [
    (1 << 32) + 15,  # the smallest prime above 2^32: r's high word at its largest
    (1 << 32) + 1,
    (1 << 36) - 5,
    (1 << 60) - 93,  # a 60-bit prime (the B_sk primes' width)
    (1 << 62) - 57,  # the largest prime below 2^62
    (1 << 62) - 1,
]


@pytest.mark.parametrize("q", _MODULI)
def test_reduce128_on_random_and_extreme_inputs(q):
    r0, rh = ratio_words(q)
    rng = random.Random(q)
    zs = [rng.getrandbits(128) for _ in range(2000)]
    zs += [rng.getrandbits(rng.randint(1, 127)) for _ in range(500)]
    zs += [M128, M128 - 1, M128 - q, 0, 1, q - 1, q, q + 1, 1 << 64, (1 << 64) - 1]
    k_top = M128 // q
    zs += [k * q + d for k in (1, 2, k_top - 1, k_top, 1 << 64, (1 << 64) - 1)
           for d in (-1, 0, 1, q - 1) if 0 <= k * q + d <= M128]
    for z in zs:
        assert reduce128(z, q, r0, rh) == z % q, (q, z)


def test_reduce128_needs_both_subtracts():
    """The estimate falls two below the quotient where both of its errors
    meet (z near 2^128 just above a multiple of q, r0 near 2^64), so the
    second conditional subtract is needed; reduce128 asserts it never falls
    further."""
    rng = random.Random(3)
    shortfall = []
    for _ in range(400):
        q = rng.randrange((1 << 32) + 1, 1 << 62) | 1
        r0, rh = ratio_words(q)
        z = (M128 // q - rng.randrange(1000)) * q + rng.randrange(3)
        assert reduce128(z, q, r0, rh) == z % q
        shortfall.append(z // q - _estimate(z, r0, rh))
    assert 2 in shortfall and set(shortfall) <= {0, 1, 2}


def _estimate(z, r0, rh):
    """The estimate reduce128 forms, from exact integers: floor((z0 rh +
    z1 r0) / 2^64) + z1 rh."""
    z0, z1 = z & M64, z >> 64
    return (z0 * rh + z1 * r0) // (1 << 64) + z1 * rh


# ---------------------------------------------------------------------------
# The kernels' dataflow on the packed, folded constants
# ---------------------------------------------------------------------------


def _take(buf, *sizes):
    out, off = [], 0
    for size in sizes:
        out.append(buf[off:off + size])
        off += size
    assert off == len(buf)
    return out


def model_to_bsk(x_col, buf, scalars, L, K):
    """to_bsk64_kernel for one coefficient: x_col [L] -> [K]."""
    q, mqh_w, mqh_ws, cqm, b, rb, xq = _take(buf, L, L, L, L, K, 2 * K, K * (L + 1))
    ys, acc = [], 0
    for i in range(L):
        y = shoup64(x_col[i], mqh_w[i], mqh_ws[i], q[i])
        acc = (acc + (y & 0xFFFF) * (cqm[i] & M32)) & M32
        ys.append(split(y, True))
    r = (acc * (scalars[0] & M32)) & 0xFFFF
    out = []
    for d in range(K):
        s = Sum()
        for i in range(L):
            s.add(ys[i], xq[d * (L + 1) + i], True)
        s.add((r, 0), xq[d * (L + 1) + L], True)
        out.append(reduce128(s.flush(), b[d], rb[2 * d], rb[2 * d + 1]))
    return out


def model_floor_sk(eq_col, eb_col, buf, scalars, L, K):
    """floor_sk64_kernel for one coefficient: eq [L], eb [K] -> [L]."""
    l = K - 1
    q, rq, fu_w, fu_ws, mskm, b, rb, fb, fa, fq = _take(
        buf, L, 2 * L, L, L, L, K, 2 * K, l * (L + 1), K + L, L * K)
    y = [split(shoup64(eq_col[j], fu_w[j], fu_ws[j], q[j]), True) for j in range(L)]
    bs = [split(e, False) for e in eb_col]
    for i in range(l):
        s = Sum()
        for j in range(L):
            s.add(y[j], fb[i * (L + 1) + j], True)
        s.add(bs[i], fb[i * (L + 1) + L], False)
        bs[i] = split(reduce128(s.flush(), b[i], rb[2 * i], rb[2 * i + 1]), False)
    s = Sum()
    for i in range(l + 1):
        s.add(bs[i], fa[i], False)
    for j in range(L):
        s.add(y[j], fa[K + j], True)
    alpha = reduce128(s.flush(), b[l], rb[2 * l], rb[2 * l + 1])
    out = []
    for d in range(L):
        s = Sum()
        for i in range(l):
            s.add(bs[i], fq[d * K + i], False)
        s.add(split(alpha, False), fq[d * K + l], False)
        z = s.flush() + (mskm[d] if alpha > scalars[1] else 0)
        out.append(reduce128(z, q[d], rq[2 * d], rq[2 * d + 1]))
    return out


_CHAINS = {
    "seal n=4096": (bfv_default(4096), 16),  # L = 3, |B_sk| = 5
    "seal n=8192": (bfv_default(8192), 56),  # L = 5, |B_sk| = 7: sums of 13 terms fold twice
    "62-bit": (get_primes(62, 3, 64), 16),   # the widest residues
}


@pytest.fixture(scope="module", params=list(_CHAINS))
def conversion(request):
    chain, t_bits = _CHAINS[request.param]
    parms = bfv.EncryptionParameters.bfv(64, 1 << t_bits, coeff_modulus=chain)
    ctx = bfv.BFVContext.build(parms, "cpu")
    assert ctx.tables.profile == "m62"
    # The conversions never read the B_sk transform tables, whose primitive
    # roots of 60-bit primes take seconds each to find: build this
    # multiplier (uncached) with a stand-in generator.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(primes, "_primitive_root", lambda q: 3)
        mul = behz.RnsMultiplier(ctx)
    bufs, scalars = behz64_cuda._pack_constants(mul)
    assert all(0 <= v <= M64 for part in bufs.values() for v in part)
    return ctx, mul, bufs, scalars


def _residues(moduli, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 62, shape + (len(moduli), 64), generator=g, dtype=torch.int64)
    x = x % torch.tensor([m.value for m in moduli], dtype=torch.int64)[:, None]
    x[..., :3] = torch.tensor([m.value - 1 for m in moduli], dtype=torch.int64)[:, None]
    x[..., 3] = 0
    return x


def test_to_bsk_model_matches_plain(conversion):
    ctx, mul, bufs, scalars = conversion
    L, K = ctx.L, mul.K
    x = _residues(ctx.moduli, (4, 1), 11)
    want = mul._to_bsk(x)
    for p in range(4):
        for c in range(0, 64, 3):
            got = model_to_bsk(x[p, 0, :, c].tolist(), bufs["to_bsk"], scalars, L, K)
            assert got == want[p, 0, :, c].tolist(), (p, c)


def test_floor_sk_model_matches_plain(conversion):
    ctx, mul, bufs, scalars = conversion
    L, K = ctx.L, mul.K
    eq = _residues(ctx.moduli, (3, 1), 12)
    eb = _residues(mul.bsk_moduli, (3, 1), 13)
    want = mul._sk_to_q(mul._fast_floor(eq, eb))
    for p in range(3):
        for c in range(0, 64, 3):
            got = model_floor_sk(eq[p, 0, :, c].tolist(), eb[p, 0, :, c].tolist(),
                                 bufs["floor_sk"], scalars, L, K)
            assert got == want[p, 0, :, c].tolist(), (p, c)


# ---------------------------------------------------------------------------
# The tile schedule
# ---------------------------------------------------------------------------


def to_bsk_words(L, K):
    return 4 * L + 3 * K + K * (L + 1)


def floor_sk_words(L, K):
    return 6 * L + 3 * K + (K - 1) * (L + 1) + (K + L) + L * K


def conv_shape(logn, rows, words, slots):
    """behz64.cu's conv_shape: (blocks, threads, shared memory bytes)."""
    log_t = 7
    while log_t > logn - 1:
        log_t -= 1

    def nbytes(lt):
        return ((words + 1) & ~1) * 8 + (slots << lt) * 16

    while log_t > 5 and nbytes(log_t) > CONV_SMEM:
        log_t -= 1
    return rows << (logn - 1 - log_t), 1 << log_t, nbytes(log_t)


@pytest.mark.parametrize("L,K", [(3, 5), (16, 18), (40, 44), (40, 48), (1, 2)])
def test_tile_schedule_covers_every_coefficient_once(L, K):
    rows = 5
    for logn in range(6, 16):
        n = 1 << logn
        for kernel, words, slots in (("to_bsk", to_bsk_words(L, K), L),
                                     ("floor_sk", floor_sk_words(L, K), L + K)):
            blocks, T, smem = conv_shape(logn, rows, words, slots)
            assert 32 <= T <= PAIR_THREADS and 2 * T <= n
            assert smem <= 232448, (kernel, L, K, logn, smem)  # the H100's per-block limit
            log_tiles = logn - 1 - (T.bit_length() - 1)
            blk = np.arange(blocks)[:, None]
            tid = np.arange(T)[None, :]
            row = blk >> log_tiles
            c = ((blk & ((1 << log_tiles) - 1)) * T + tid) * 2
            flat = np.concatenate([(row * n + c).ravel(), (row * n + c + 1).ravel()])
            assert np.array_equal(np.sort(flat), np.arange(rows * n)), (kernel, logn)
