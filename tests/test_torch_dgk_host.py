"""The port's DGK host code against the reference's, and a model of the
DGK kernels' arithmetic, on the CPU.

* the copies ``maurer``, ``gdsa``, ``ph`` and ``dgk``: the same seed gives
  the same primes, keys and decryption table, ``save_dgk_keys`` the same
  bytes, and the number-theory helpers the same answers;
* a numpy model of ``csrc/dgk_mont.cu``: the group product of every
  kernel, op for op (G threads a number, its shuffles, deferred carries,
  ballots and look-ahead), and on it each kernel's product sequence:
  ``dgk_mulmod`` in both forms (two products, or one by c R' mod n),
  ``dgk_powmod_lanes``/``dgk_powmod_shared`` with their windowed walks,
  ``dgk_blind_distance`` with its joint walk over xb and yb and the
  conversions folded into the chain; their product counts; and the
  groups' cover of a batch. Against ``pow`` at every compiled width
  (W = 17, 33, 65, 97, 129, at the built G and W' and the other group
  sizes weighed) with the edge cases (0, 1, 2, n - 1, n - 2,
  2^(bits - 1); exponents 0, 1, all ones, 800 bits). A carry mistake in a
  kernel's scheme shows here before a chip call; change model and kernel
  together.

Bit-exact throughout (tolerance 0): all arithmetic is exact integers.
"""

import importlib
import random

import numpy as np
import pytest

from pplp_tpu_torch.ops import dgk_cuda

# The packages export functions named like their modules (``maurer``).
rdgk, rgdsa, rmaurer, rph = (importlib.import_module(f"pplp_tpu.dgk.{m}")
                             for m in ("dgk", "gdsa", "maurer", "ph"))
dgk, gdsa, maurer, ph = (importlib.import_module(f"pplp_tpu_torch.dgk.{m}")
                         for m in ("dgk", "gdsa", "maurer", "ph"))

K, T, L = 512, 64, 12
# The group kernels' geometry, W -> (G threads a number, L limbs a thread,
# window bits), as dgk_mont.cu builds it (PPLP_DGK_GROUPS, kWindow);
# tests/test_torch_cuda.py holds the library's report (dgk_cuda.group)
# to it on the card.
GEOMETRY = {17: (4, 5, 3), 33: (3, 11, 3), 65: (5, 13, 3), 97: (8, 13, 3), 129: (10, 13, 3)}
KERNEL_BLOCK = 64  # threads a block (kGroupThreads)


@pytest.mark.parametrize("bits", [16, 24, 48, 80, 160])
def test_maurer_matches_reference(bits):
    got = maurer.maurer(bits, random.Random(bits))
    assert got == rmaurer.maurer(bits, random.Random(bits))
    assert got.bit_length() == bits
    assert maurer.prime_prod(bits) == rmaurer.prime_prod(bits)
    assert maurer.SMALL_PRIMES == rmaurer.SMALL_PRIMES


def test_gdsa_prime_matches_reference():
    q = maurer.maurer(40, random.Random(2))
    got = gdsa.gdsa_prime(q, 160, random.Random(3))
    assert got == rgdsa.gdsa_prime(q, 160, random.Random(3))
    assert (got - 1) % q == 0
    rng, rrng = random.Random(4), random.Random(4)
    assert gdsa.get_invertible_num(1 << 20, rng) == rgdsa.get_invertible_num(1 << 20, rrng)


def test_ph_helpers_match_reference():
    for x in (0, 1, 5, 57, 99):
        h = pow(2, x, 101)
        assert ph.pohlig_hellman(2, h, 101, 100) == rph.pohlig_hellman(2, h, 101, 100) == x
        assert ph.bsgs(2, h, 101, 100) == rph.bsgs(2, h, 101, 100) == x
    for m in (100, 2 * 3 * 5 * 7 * 7 * 97, 65521, 1 << 20):
        assert ph.factorize(m) == rph.factorize(m)
    assert ph.crt_solve([2, 3, 6], [3, 5, 7]) == rph.crt_solve([2, 3, 6], [3, 5, 7])
    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7, init_table=False)
    gv = pow(pub.g, priv.vpq, priv.n)
    for m in (0, 1, 77, pub.u - 1):
        c = dgk.dgk_encrypt(pub, m, 12345)
        cv = pow(c, priv.vpq, priv.n)
        assert ph.pohlig_hellman(gv, cv, priv.n, pub.u) == m


@pytest.mark.parametrize("k,t,l,seed", [(512, 64, 12, 7), (384, 48, 10, 3)])
def test_gen_keys_match_reference(k, t, l, seed):
    priv, pub = dgk.dgk_gen_keys(k, t, l, seed=seed)
    rpriv, rpub = rdgk.dgk_gen_keys(k, t, l, seed=seed)
    for name in ("n", "g", "h", "u", "t"):
        assert getattr(pub, name) == getattr(rpub, name), name
    for name in ("n", "g", "u", "p", "q", "vp", "vq", "vpq"):
        assert getattr(priv, name) == getattr(rpriv, name), name
    assert priv.rtab == rpriv.rtab
    rng, rrng = random.Random(seed), random.Random(seed)
    for _ in range(4):
        r = dgk.dgk_random_num(2 * t, rng)
        assert r == rdgk.dgk_random_num(2 * t, rrng)
        m = r % pub.u
        c = dgk.dgk_encrypt(pub, m, r)
        assert c == rdgk.dgk_encrypt(rpub, m, r)
        assert dgk.dgk_decrypt(priv, c) == rdgk.dgk_decrypt(rpriv, c) == m


def test_save_dgk_keys_bytes_match_reference():
    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7)
    rpriv, rpub = rdgk.dgk_gen_keys(K, T, L, seed=7)
    blob = dgk.save_dgk_keys(priv, pub)
    assert blob == rdgk.save_dgk_keys(rpriv, rpub)
    assert dgk.save_dgk_keys(None, pub) == rdgk.save_dgk_keys(None, rpub)
    priv2, pub2 = dgk.load_dgk_keys(blob)
    assert pub2 == pub and priv2.rtab == priv.rtab
    assert (priv2.p, priv2.q, priv2.vpq) == (priv.p, priv.q, priv.vpq)
    none, pub3 = dgk.load_dgk_keys(dgk.save_dgk_keys(None, pub))
    assert none is None and pub3 == pub


# -- a model of csrc/dgk_mont.cu ------------------------------------------

M32 = (1 << 32) - 1


def _limbs(v, W):
    return [(v >> (32 * j)) & M32 for j in range(W)]


def _value(limbs):
    return sum(x << (32 * j) for j, x in enumerate(limbs))


def _width(bits):
    """The compiled width a modulus of ``bits`` bits runs at (``dgk_cuda.width``)."""
    W = ((bits + 15) // 16 + 2) // 2
    return min(Wc for Wc in GEOMETRY if Wc >= W)


@pytest.mark.parametrize("bits", [497, 514, 528, 1033, 2033, 2057, 2064, 3081, 4105])
def test_kernel_model_against_pow(bits):
    """The widths a k = 512, 1024, 2048, 3072 or 4096 key gives (W = 17, 33,
    65, 97, 129): the products in both forms, the per-lane and the
    shared-exponent walks and the blind distance on the group model, per
    lane, against Python's."""
    rng = random.Random(bits)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    k = GroupKernel(n, _width(bits))
    edge = [0, 1, 2, n - 1, n - 2, (1 << (bits - 1)), rng.randrange(n)]
    b = [n - 1, 1, 0, rng.randrange(n)]
    a = [x for x in edge for _ in b]
    bb = b * len(edge)
    assert k.mulmod(a, bb) == [x * y % n for x, y in zip(a, bb)]
    for c in b:
        assert k.mulmod_const(edge, c) == [x * c % n for x in edge]
    exps = [0, 1, 37, (1 << 17) - 1] if k.W > 32 else [0, 1, 2, 37, rng.getrandbits(20),
                                                        (1 << 33) - 1]
    for a in edge[1:5:2] if k.W > 32 else edge[:5]:
        assert k.powmod_lanes([a] * len(exps), exps) == [pow(a, e, n) for e in exps]
    for e in exps:
        assert k.powmod_shared(edge[:5], e) == [pow(x, e, n) for x in edge[:5]]
    c = [[rng.randrange(n) for _ in range(3)] for _ in range(5)]
    for xb, yb, s in ((123321, 123654, 37), (0, 5, 0), (1, 0, 65535)):
        want = [pow(c1 * pow(c2, xb, n) * pow(c3, yb, n) % n, s, n) * cz * cr % n
                for c1, c2, c3, cz, cr in zip(*c)]
        assert k.blind_distance(*c, xb, yb, s)[0] == want


def test_kernel_model_at_a_full_decrypt_exponent():
    """c^vpq at k = 512 (vpq of 128 bits) and W = 17 on the group model,
    then the BSGS giant steps in their one-product form (``mulmod_const``
    by G^-m): each ciphertext's message is found in the baby-step table."""
    import math

    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7)
    k = GroupKernel(pub.n, _width(pub.n.bit_length()))
    m_steps = math.isqrt(pub.u) + 1
    G = pow(priv.g, priv.vpq, priv.n)
    baby = {pow(G, j, priv.n): j for j in range(m_steps)}
    giant = pow(G, -m_steps, priv.n)
    want = [0, 1, pub.u - 1]
    z = k.powmod_shared([dgk.dgk_encrypt(pub, m, 99991) for m in want], priv.vpq)
    found = [None] * len(want)
    for i in range((pub.u + m_steps - 1) // m_steps + 1):
        for lane, v in enumerate(z):
            if found[lane] is None and v in baby:
                found[lane] = i * m_steps + baby[v]
        z = k.mulmod_const(z, giant)
    assert found == want


# -- a model of the group kernels (dgk_powmod_lanes, dgk_powmod_shared) -----
#
# G threads work on one number, thread r holding limbs rL .. rL + L - 1 of
# each operand (W' = G L limbs). Arrays here are [numbers, G, L] (u32 in
# uint64); the G axis is the group's threads, and a shuffle is an index into
# it. Every product and sum below fits 64 bits exactly, as in the kernel.

U32 = np.uint64(M32)
S32 = np.uint64(32)


def _slices(vals, G, L):
    """Python ints -> [len(vals), G, L] limb slices."""
    return np.array([_limbs(v, G * L) for v in vals], np.uint64).reshape(len(vals), G, L)


def _slice_values(x):
    return [_value(row) for row in x.reshape(x.shape[0], -1).tolist()]


def _lookahead(gen, prop, G):
    """The kernel's carry look-ahead over a group's ballot bits: bit r of the
    result is the carry (or borrow) into thread r, bit G the one out of the
    group."""
    a = gen | prop
    return (a + gen) ^ a ^ gen


def _ballot(pred):
    """[numbers, G] booleans -> each group's bits (thread r at bit r)."""
    return (pred.astype(np.int64) << np.arange(pred.shape[1])).sum(axis=1)


def group_cios(a, b, n, n0inv):
    """dgk_mont.cu's group_mul, op for op: a b R'^-1 mod n for each number.
    a, b: [N, G, L] below n; n: [G, L]. A slice is a list of L [N, G]
    columns, limb j of every thread of every group."""
    N, G, L = a.shape
    b = [b[:, :, j] for j in range(L)]
    nj = [n[:, j] for j in range(L)]
    t = [np.zeros((N, G), np.uint64) for _ in range(L)]
    C = np.zeros((N, G), np.uint64)  # carry pending into limb (r + 1) L
    up = np.r_[1:G, 0]  # shfl(lane + 1): each thread reads its upper neighbour
    n0inv = np.uint64(n0inv)
    for o in range(G):  # the thread that owns a_i
        for l in range(L):
            ai = a[:, o, l][:, None]  # shfl(a[l], first + o)
            c = 0
            for j in range(L):  # mad_row: t += a_i b
                s = ai * b[j] + t[j] + c
                t[j], c = s & U32, s >> S32
            c1 = c
            q = ((t[0][:, 0] * n0inv) & U32)[:, None]  # shfl(t[0] n0inv, first)
            c = 0
            for j in range(L):  # mad_row: t += q n
                s = q * nj[j] + t[j] + c
                t[j], c = s & U32, s >> S32
            assert not t[0][:, 0].any()  # t + q n = 0 mod 2^32
            nx = t[0][:, up]
            nx[:, G - 1] = 0  # the top thread has no upper neighbour
            s = nx + C + c + c1
            t = t[1:] + [s & U32]  # the shift down one limb
            C = s >> S32
            assert (C <= 3).all()
    # The pending carries move up one thread; what they carry on is a bit per
    # thread, resolved by look-ahead over two ballots.
    t = np.stack(t, axis=2)
    cin = np.concatenate([np.zeros((N, 1), np.uint64), C[:, :G - 1]], axis=1)  # shfl(lane - 1)
    c = cin
    for j in range(L):
        s = t[:, :, j] + c
        t[:, :, j], c = s & U32, s >> S32
    assert not C[:, G - 1].any() and not c[:, G - 1].any()  # the value is below 2n < R'
    carries = _lookahead(_ballot(c[:, :G - 1] == 1), _ballot((t == U32).all(axis=2)), G)
    c = ((carries[:, None] >> np.arange(G)) & 1).astype(np.uint64)
    for j in range(L):
        s = t[:, :, j] + c
        t[:, :, j], c = s & U32, s >> S32
    assert not c[:, G - 1].any()
    # One conditional subtraction of n, its borrows by look-ahead likewise.
    d = np.zeros_like(t)
    bo = np.zeros((N, G), np.uint64)
    for j in range(L):
        s = t[:, :, j] + (np.uint64(1) << S32) - n[:, j] - bo
        d[:, :, j], bo = s & U32, np.uint64(1) - (s >> S32)
    borrows = _lookahead(_ballot(bo == 1), _ballot((d == 0).all(axis=2)), G)
    ge = ((borrows >> G) & 1) == 0  # no borrow out of the group: t >= n
    c = ((borrows[:, None] >> np.arange(G)) & 1).astype(np.uint64)
    for j in range(L):
        s = d[:, :, j] + (np.uint64(1) << S32) - c
        d[:, :, j], c = s & U32, np.uint64(1) - (s >> S32)
    return np.where(ge[:, None, None], d, t)


def _digit(words, d, k):
    """Window d (k bits) of an exponent's u32 words, as the kernels read it:
    one or two words, shifted."""
    bit = d * k
    i, off = bit >> 5, bit & 31
    v = words[i] | ((words[i + 1] << 32) if i + 1 < len(words) else 0)
    return (v >> off) & ((1 << k) - 1)


class GroupKernel:
    """The group kernels on the model, with dgk_cuda's constants at W'."""

    def __init__(self, n, W, G=None, L=None, k=None):
        G0, L0, k0 = GEOMETRY[W]
        self.G, self.L, self.k = G or G0, L or L0, k or k0
        Wp = self.G * self.L
        words = dgk_cuda._consts(n, Wp).tolist()
        self.n, self.r2, self.one = (np.array(words[j * Wp:(j + 1) * Wp], np.uint64)
                                     .reshape(self.G, self.L) for j in range(3))
        self.n0inv, self.W, self.n_int = words[3 * Wp], W, n
        self.count = 0  # products run since construction

    def mul(self, a, b):
        self.count += 1
        return group_cios(a, np.broadcast_to(b, a.shape), self.n, self.n0inv)

    def _sl(self, vals):
        return _slices(vals, self.G, self.L)

    def mulmod(self, a, b):
        """dgk_mulmod, two products a lane: a R', then by b."""
        return _slice_values(self.mul(self.mul(self._sl(a), self.r2), self._sl(b)))

    def mulmod_const(self, a, c):
        """dgk_mulmod's one-product form: by c R' mod n, made as the wrapper
        makes it."""
        Wp = self.G * self.L
        cm = np.array(dgk_cuda._mont_words(self.n_int, c, Wp).tolist(), np.uint64)
        return _slice_values(self.mul(self._sl(a), cm.reshape(self.G, self.L)))

    def _walk(self, tab, e1, e2):
        """A shared-exponent walk of dgk_blind_distance (Walk): left to right
        from the top bit of e1 and e2 together, x from the entry the top bit
        pair selects (R' mod n if both are 0), then per lower bit a squaring
        and, where the pair p is not 0, a product by entry p - 1."""
        top = max(e1.bit_length(), e2.bit_length())
        if top == 0:
            return np.broadcast_to(self.one, tab[0].shape).copy()

        def pair(i):
            return ((e1 >> i) & 1) | (((e2 >> i) & 1) << 1)

        x = tab[pair(top - 1) - 1]
        for i in range(top - 2, -1, -1):
            x = self.mul(x, x)
            if pair(i):
                x = self.mul(x, tab[pair(i) - 1])
        return x

    def blind_distance(self, c1, c2, c3, cz, cr, xb, yb, s):
        """dgk_blind_distance's steps (BlindStep), one product each; returns
        (the values, the products a lane)."""
        start = self.count
        tab = [self.mul(self._sl(c2), self.r2)]               # kC2Mont: c2 R'
        tab.append(self.mul(self._sl(c3), self.r2))           # kC3Mont: c3 R'
        tab.append(self.mul(tab[1], tab[0]))                  # kC23: c2 c3 R'
        x = self._walk(tab, xb, yb)                           # kJoint: T R'
        x = self.mul(self.mul(x, self._sl(c1)), self.r2)      # kC1, kC1Mont: c1 T R'
        tab[0] = x
        x = self._walk(tab, s, 0)                             # kWalkS: A R'
        x = self.mul(self.mul(x, self._sl(cz)), self.r2)      # kCz, kCzMont: A cz R'
        x = self.mul(x, self._sl(cr))                         # kCr: A cz cr
        return _slice_values(x), self.count - start

    def _pow(self, x, words, exp_bits):
        """pow_window: a table base^0 .. base^(2^k - 1) per number, then k
        squarings and one product by the entry each window selects."""
        N, k = x.shape[0], self.k
        tab = [np.broadcast_to(self.one, x.shape).copy(), x]
        for _ in range(2, 1 << k):
            tab.append(self.mul(tab[-1], x))
        tab = np.stack(tab)
        windows = -(-exp_bits // k)
        if windows == 0:
            return tab[0]
        lanes = np.arange(N)
        x = tab[[_digit(w, windows - 1, k) for w in words], lanes]
        for d in range(windows - 2, -1, -1):
            for _ in range(k):
                x = self.mul(x, x)
            x = self.mul(x, tab[[_digit(w, d, k) for w in words], lanes])
        return x

    def _finish(self, x):
        unit = np.zeros_like(x)
        unit[:, 0, 0] = 1
        return _slice_values(self.mul(x, unit))

    def powmod_lanes(self, bases, exps):
        """bases: one per number or a single shared one."""
        exps = [int(e) for e in exps]
        bits = max((e.bit_length() for e in exps), default=0)
        ew = max(1, (bits + 31) // 32)
        base = _slices(bases * (len(exps) if len(bases) == 1 else 1), self.G, self.L)
        r2 = np.broadcast_to(self.r2, base.shape)
        return self._finish(self._pow(self.mul(base, r2), [_limbs(e, ew) for e in exps], bits))

    def powmod_shared(self, bases, e):
        base = _slices(bases, self.G, self.L)
        x = self.mul(base, np.broadcast_to(self.r2, base.shape))
        words = _limbs(int(e), dgk_cuda.EXP_WORDS)
        return self._finish(self._pow(x, [words] * len(bases), int(e).bit_length()))

    def products(self, exp_bits):
        """Montgomery products a lane: to the domain, the table, the windows, back."""
        windows = -(-exp_bits // self.k)
        return 2 + (1 << self.k) - 2 + max(windows - 1, 0) * (self.k + 1)


def _modulus(bits, rng):
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.mark.parametrize("bits", [497, 528, 1033, 1040, 2033, 2064, 3081, 4105])
def test_group_product_against_pow(bits):
    """group_cios at the built (G, L) on the edge cases, per lane, against
    Python's products, at every compiled width; at W = 17, 33 and 65 also
    the other group sizes weighed."""
    rng = random.Random(bits)
    n = _modulus(bits, rng)
    W = _width(bits)
    shapes = [GEOMETRY[W][:2]] + {17: [(2, 9)], 33: [(4, 9)], 65: [(4, 17), (8, 9)]}.get(W, [])
    edge = [0, 1, 2, n - 1, n - 2, 1 << (bits - 1), rng.randrange(n)]
    a = edge * len(edge)
    b = [y for y in edge for _ in edge]
    for G, L in shapes:
        k = GroupKernel(n, W, G, L)
        Rp = 1 << (32 * G * L)
        got = _slice_values(k.mul(_slices(a, G, L), _slices(b, G, L)))
        assert got == [x * y * pow(Rp, -1, n) % n for x, y in zip(a, b)], (G, L)


@pytest.mark.parametrize("bits", [497, 2057])
def test_group_kernels_against_pow(bits):
    """The windowed walks of both kernels, per-lane and shared bases, on the
    edge cases and exponents 0, 1, all ones and 800 bits, against pow; and
    the products a lane runs, as the header states them."""
    rng = random.Random(bits + 1)
    n = _modulus(bits, rng)
    W = ((bits + 15) // 16 + 2) // 2
    k = GroupKernel(n, W)
    edge = [0, 1, 2, n - 1, n - 2, 1 << (bits - 1)]
    exps = [0, 1, 2, 37, (1 << 33) - 1, rng.getrandbits(800) | (1 << 799)]
    bases = [x for x in edge for _ in exps]
    lanes = exps * len(edge)  # every base with every exponent, in one launch
    assert k.powmod_lanes(bases, lanes) == [pow(x, e, n) for x, e in zip(bases, lanes)]
    assert k.powmod_lanes([n - 2], exps[:5]) == [pow(n - 2, e, n) for e in exps[:5]]
    assert k.powmod_lanes(edge[:2], [0, 0]) == [1, 1]
    for e in (0, 1, (1 << 64) - 1):
        assert k.powmod_shared(edge, e) == [pow(x, e, n) for x in edge]
    calls = []
    mul = k.mul
    k.mul = lambda a, b: calls.append(1) or mul(a, b)
    for bits in (0, 1, 3, 4, 16, 64):
        calls.clear()
        k.powmod_lanes([2], [(1 << bits) - 1])
        windows = -(-bits // 3)
        assert len(calls) == k.products(bits) == 8 + max(windows - 1, 0) * 4, bits


def test_group_shared_kernel_at_640_bits():
    """The decrypt's exponent width (640 bits), all ones and random, at
    W = 17 on the edge cases."""
    rng = random.Random(640)
    n = _modulus(520, rng)
    k = GroupKernel(n, 17)
    edge = [0, 1, 2, n - 1, n - 2, 1 << 519]
    for e in ((1 << 640) - 1, rng.getrandbits(640)):
        assert k.powmod_shared(edge, e) == [pow(x, e, n) for x in edge]


@pytest.mark.parametrize("bits", [384, 528, 1040, 2064, 3088, 4112])
def test_group_blind_distance_against_pow(bits):
    """dgk_blind_distance's product sequence on the group model at every
    compiled width, each at its widest modulus, and a 384-bit one (W = 13)
    at W = 17: ciphertexts 0, 1, 2, n - 1, n - 2, 2^(bits - 1) and random
    ones, exponents with 0 and 1 among them and bench.py's, against pow;
    the products a lane as ``measure_dgk.blind_distance_products`` counts
    them, no more than the reference chain's."""
    from pplp_tpu_torch.measure_dgk import blind_distance_products, dgk_products

    rng = random.Random(bits + 2)
    n = _modulus(bits, rng)
    k = GroupKernel(n, _width(bits))
    edge = [0, 1, 2, n - 1, n - 2, 1 << (bits - 1), rng.randrange(n)]
    cs = [edge[j:] + edge[:j] for j in range(5)]  # every lane a mix of the edge cases
    for xb, yb, s in ((0, 1, 0), (0, 5, 0), (1, 0, 65535), (6, 3, 2), (123321, 123654, 37)):
        got, products = k.blind_distance(*cs, xb, yb, s)
        assert got == [pow(c1 * pow(c2, xb, n) * pow(c3, yb, n) % n, s, n) * cz * cr % n
                       for c1, c2, c3, cz, cr in zip(*cs)], (xb, yb, s)
        assert products == blind_distance_products(xb, yb, s), (xb, yb, s)
        assert products <= 10 + sum(map(dgk_products, (xb, yb, s))), (xb, yb, s)
    assert blind_distance_products(123321, 123654, 37) == 43


@pytest.mark.parametrize("W", sorted(GEOMETRY))
def test_groups_cover_a_batch(W):
    """The kernels' Group and group_grid: at each geometry and batches of
    one number, part of a warp, a block and one past it, and B = 10,000,
    the active groups own every number below the batch once, with all G
    ranks, and nothing above it."""
    G = GEOMETRY[W][0]
    per_warp, warps = 32 // G, KERNEL_BLOCK // 32
    for batch in (1, 5, per_warp * warps, per_warp * warps + 1, 67, 10_000):
        ranks = {}
        for block in range(-(-batch // (per_warp * warps))):
            for t in range(KERNEL_BLOCK):
                lane = t & 31
                group, first = lane // G, lane // G * G
                num = (block * warps + (t >> 5)) * per_warp + group
                if group < per_warp and num < batch:
                    ranks.setdefault(num, []).append(lane - first)
        assert sorted(ranks) == list(range(batch)), (G, batch)
        assert all(sorted(r) == list(range(G)) for r in ranks.values()), (G, batch)


def test_group_model_at_a_full_decrypt_exponent():
    """c^vpq at k = 512 on the group model lands in the decryption table."""
    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7)
    k = GroupKernel(pub.n, (((pub.n.bit_length() + 15) // 16 + 1) + 1) // 2)
    cs = [dgk.dgk_encrypt(pub, m, 99991) for m in (0, 1, pub.u - 1)]
    assert [priv.rtab[v] for v in k.powmod_shared(cs, priv.vpq)] == [0, 1, pub.u - 1]


# -- the wrappers' checks (no card needed) ----------------------------------


def test_kernel_wrappers_refuse_cpu_tensors_and_other_widths():
    import torch

    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import MontgomeryCtx, to_digits

    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7, init_table=False)
    with pytest.raises(TypeError):
        DGKBatch.build(pub)  # the device is a required keyword
    mc = DGKBatch.build(pub, device="cpu").mc
    assert dgk_cuda.limbs(mc) == 17
    x = to_digits([1, 2], mc.D)
    for call in (lambda: dgk_cuda.mulmod_cuda(mc, x, x), lambda: dgk_cuda.powmod_cuda(mc, x, [1, 2]),
                 lambda: dgk_cuda.mulmod_const_cuda(mc, x, 5),
                 lambda: dgk_cuda.powmod_shared_exp_cuda(mc, x, 3),
                 lambda: dgk_cuda.blind_distance_cuda(mc, x, x, x, 1, 2, 3, x, x)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="no DGK"):
        dgk_cuda.mulmod(mc, x.to("meta"), x.to("meta"))
    # A modulus of a width not compiled runs at the next one up; only one
    # wider than the widest (129 limbs, 4,112 bits) is refused, by name.
    for bits, Wc in ((384, 17), (528, 17), (529, 33), (1040, 33), (2057, 65), (3088, 97),
                     (3089, 129), (4112, 129)):
        assert dgk_cuda.width(MontgomeryCtx.build((1 << (bits - 1)) | 12345, device="cpu")) == Wc
    with pytest.raises(ValueError, match="at most 129 32-bit limbs .* W = 130"):
        dgk_cuda.width(MontgomeryCtx.build((1 << 4112) | 12345, device="cpu"))
    y = to_digits([3, pub.n - 1], mc.D)
    for c in (0, 1, 77, pub.n - 1):
        assert torch.equal(dgk_cuda.mulmod_const(mc, y, c), mc.mulmod(y, to_digits([c], mc.D)))
    with pytest.raises(ValueError, match="shared exponent"):
        dgk_cuda._shared_exponents([1 << 2048])
    words, bits = dgk_cuda._shared_exponents([0, 5, (1 << 640) - 1])
    assert bits.tolist() == [0, 3, 640] and words[2, :20].tolist() == [(1 << 32) - 1] * 20
    assert torch.equal(dgk_cuda._to_digits(dgk_cuda._to_words(x, 17), mc.D), x)


def test_exponent_buffer_keeps_its_bytes():
    """``_pack_exponents``'s one pass writes the bytes the kernel read
    before: each exponent's u32 words little-endian at ceil(bits / 32)
    words a lane."""
    import torch

    rng = random.Random(9)
    for exps in ([rng.getrandbits(800) for _ in range(50)] + [0, 1, (1 << 800) - 1],
                 [rng.getrandbits(16) for _ in range(9)], [0, 0], [5], []):
        bits = max((e.bit_length() for e in exps), default=0)
        ew = max(1, (bits + 31) // 32)
        want = np.frombuffer(b"".join(e.to_bytes(4 * ew, "little") for e in exps), "<u4")
        host, got_ew, got_bits = dgk_cuda._pack_exponents(exps)
        assert (got_ew, got_bits) == (ew, bits) and host.dtype == torch.int32
        assert host.numpy().view(np.uint32).tolist() == want.tolist()
    with pytest.raises(ValueError, match="non-negative"):
        dgk_cuda._pack_exponents([3, -1])


def test_mad_probe_geometry_and_device():
    """The multiply-add probe's wrapper constants match the source's, and
    it runs only on a CUDA device."""
    from pplp_tpu_torch.ops import mulmod_chain

    text = mulmod_chain.SOURCE.read_text()
    assert f"constexpr int kMadChains = {mulmod_chain.MAD_CHAINS};" in text
    assert f"<<<blocks, {mulmod_chain.MAD_THREADS}, 0, s>>>" in text
    with pytest.raises(ValueError, match="CUDA device"):
        mulmod_chain.mad_probe("cpu", True, 1, 1)



def test_dgk_bound_counts_the_binary_method_at_two_slots():
    """measure_dgk's bound, which chip_smoke.py's kernels line reads: the
    binary method's products (a square per bit below the top one, a product
    per set bit below it), 2 W^2 + W multiply-adds each at two 32-bit
    multiply slots, against the bytes moved; the longer of the two binds."""
    from pplp_tpu_torch import measure_dgk
    from pplp_tpu_torch.measure_multiply import BYTES_PER_S, MULS_PER_S

    for e in (0, 1, 2, 3, 0b1011, (1 << 800) - 1, 1 << 799):
        want = 0 if e == 0 else (e.bit_length() - 1) + (bin(e).count("1") - 1)
        assert measure_dgk.dgk_products(e) == want, e
    assert measure_dgk.MAD_SLOTS == 2
    assert measure_dgk.dgk_bound(65, 1000, 40) == {
        "bound_ms": 1000 * 8515 * 2 / MULS_PER_S * 1e3, "bound_by": "operations",
        "products": 1000}
    c = measure_dgk.dgk_bound(17, 1, 4 * 10 ** 9)
    assert c["bound_by"] == "bytes" and c["bound_ms"] == 4 * 10 ** 9 / BYTES_PER_S * 1e3


def test_kernel_bounds_count_the_products_the_functions_need():
    """The bounds count what each function needs on its exponents: an
    exponentiation the fewer of the binary method's products and the
    window's (as the group model runs them), the blind distance the joint
    walk's 43 a lane at bench.py's exponents (the reference chain's 65 stand
    beside it), the product 2 and the giant step 1; bytes as the kernels'
    rows: int64 digits for the product, the giant step and the blind
    distance, u32 limbs for the exponentiations."""
    from pplp_tpu_torch import measure_dgk as md
    from pplp_tpu_torch.measure_multiply import BYTES_PER_S

    k = GroupKernel(_modulus(497, random.Random(1)), 17)
    assert md.WINDOW == k.k
    for bits in (0, 1, 3, 4, 16, 640, 800):
        assert md.window_products(bits) == k.products(bits), bits
    for e, want in ((0, 2), (1, 2), (37, 9), ((1 << 16) - 1, 28), (1 << 799, 801),
                    ((1 << 800) - 1, 1072)):
        assert md.exp_products(e) == want == min(2 + md.dgk_products(e),
                                                 md.window_products(e.bit_length())), e
    b = md.kernel_bounds(65, 130, 10, (1 << 640) - 1)
    assert {name: (c["products"], c["reference_products"]) for name, c in b.items()} == {
        "dgk_mulmod": (20, 20), "giant step": (10, 10), "dgk_powmod_shared": (8600, 12800),
        "dgk_blind_distance": (430, 650)}
    assert all(c["bound_by"] == "operations" for c in b.values())
    assert b["dgk_blind_distance"]["reference_bound_ms"] == md.dgk_bound(65, 650, 1)["bound_ms"]
    wide = md.kernel_bounds(1, 10 ** 6, 10, 3)  # one limb of n, rows of 10^6 digits: bytes
    for name, rows in (("dgk_mulmod", 3), ("giant step", 2), ("dgk_blind_distance", 6)):
        assert wide[name]["bound_by"] == "bytes"
        assert wide[name]["bound_ms"] == rows * 8 * 10 ** 6 * 10 / BYTES_PER_S * 1e3, name
    exps = [0, 37, (1 << 800) - 1]
    c = md.lanes_bound(65, exps)
    assert (c["products"], c["reference_products"]) == (2 + 9 + 1072, 2 + 9 + 1600)
    assert md.lanes_bound(10 ** 6, exps)["products"] == c["products"]
