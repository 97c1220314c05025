"""The port's DGK host code against the reference's, and a model of the
DGK kernel's arithmetic, on the CPU.

* the copies ``maurer``, ``gdsa``, ``ph`` and ``dgk``: the same seed gives
  the same primes, keys and decryption table, ``save_dgk_keys`` the same
  bytes, and the number-theory helpers the same answers;
* a Python model of ``csrc/dgk_mont.cu``: the one-thread CIOS on 32-bit
  limbs (``dgk_mulmod``, ``dgk_blind_distance``) with its carries, final
  subtraction and square-and-multiply order, limb for limb on Python ints;
  and the group product of ``dgk_powmod_lanes``/``dgk_powmod_shared``, op
  for op (G threads a number, its shuffles, deferred carries, ballots and
  look-ahead), with their windowed exponent walks and product counts.
  Both against ``pow`` at both compiled widths (W = 17 and 65, at the
  built G and W' and the other group sizes weighed) with the edge cases
  (0, 1, 2, n - 1, n - 2, 2^(bits - 1); exponents 0, 1, all ones, 800
  bits). A carry mistake in a kernel's scheme shows here before a chip
  call; change model and kernel together.

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
GEOMETRY = {17: (4, 5, 3), 65: (5, 13, 3)}


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


def cios(acc, a, n, n0inv):
    """dgk_mont.cu's mont_mul, limb for limb: acc <- a acc R'^-1 mod n."""
    W = len(n)
    t = [0] * (W + 1)
    for i in range(W):
        c = 0
        for j in range(W):  # t += a_i acc
            s = a[i] * acc[j] + t[j] + c
            assert s <= (1 << 64) - 1
            t[j], c = s & M32, s >> 32
        s = t[W] + c
        t[W], top = s & M32, s >> 32
        q = (t[0] * n0inv) & M32
        s = q * n[0] + t[0]
        assert s & M32 == 0
        c = s >> 32
        for j in range(1, W):  # t <- (t + q n) / 2^32
            s = q * n[j] + t[j] + c
            t[j - 1], c = s & M32, s >> 32
        s = t[W] + c
        t[W - 1] = s & M32
        t[W] = top + (s >> 32)
        assert t[W] <= M32
    borrow = 0
    for j in range(W):
        d = (t[j] - n[j] - borrow) & ((1 << 64) - 1)
        borrow = (d >> 32) & 1
    keep = 0 if (t[W] == 0 and borrow) else M32
    out, borrow = [], 0
    for j in range(W):
        d = (t[j] - (n[j] & keep) - borrow) & ((1 << 64) - 1)
        out.append(d & M32)
        borrow = (d >> 32) & 1
    return out


class Kernel:
    """The one-thread kernels (``dgk_mulmod``, ``dgk_blind_distance``) on
    the model, with dgk_cuda's constants; ``powmod_shared`` is the blind
    distance's exponentiation order."""

    def __init__(self, n, W):
        words = dgk_cuda._consts(n, W).tolist()
        self.n, self.r2, self.one, self.unit = (words[k * W:(k + 1) * W] for k in range(4))
        self.n0inv, self.W = words[4 * W], W

    def mul(self, acc, a):
        return cios(acc, a, self.n, self.n0inv)

    def pow_shared(self, x, e):
        if e == 0:
            return list(self.one)
        base = x
        for bit in bin(e)[3:]:
            x = self.mul(x, list(x))
            if bit == "1":
                x = self.mul(x, base)
        return x

    def mulmod(self, a, b):
        x = _limbs(a, self.W)
        for op in (self.r2, _limbs(b, self.W)):
            x = self.mul(x, op)
        return _value(x)

    def powmod_shared(self, base, e):
        x = self.pow_shared(self.mul(_limbs(base, self.W), self.r2), e)
        return _value(self.mul(x, self.unit))

    def blind_distance(self, c1, c2, c3, cz, cr, xb, yb, s):
        kept = [self.mul(_limbs(c, self.W), self.r2) for c in (c1, cz, cr)]
        t2 = self.pow_shared(self.mul(_limbs(c2, self.W), self.r2), xb)
        x = self.pow_shared(self.mul(_limbs(c3, self.W), self.r2), yb)
        for op in (t2, kept[0]):
            x = self.mul(x, op)
        x = self.pow_shared(x, s)
        for op in (kept[1], kept[2], self.unit):
            x = self.mul(x, op)
        return _value(x)


@pytest.mark.parametrize("bits", [497, 514, 528, 2033, 2057, 2064])
def test_kernel_model_against_pow(bits):
    """The widths are those a k = 512 or 2048 key gives (W = 17, 65)."""
    rng = random.Random(bits)
    n = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
    D = (bits + 15) // 16 + 1
    W = (D + 1) // 2
    assert W in dgk_cuda.WIDTHS
    k = Kernel(n, W)
    edge = [0, 1, 2, n - 1, n - 2, (1 << (bits - 1)), rng.randrange(n)]
    for a in edge:
        for b in (n - 1, 1, 0, rng.randrange(n)):
            assert k.mulmod(a, b) == a * b % n
    # Fewer cases at W = 65, where a product is 8,515 Python multiplies.
    exps = [0, 1, 37, (1 << 17) - 1] if W > 32 else [0, 1, 2, 37, rng.getrandbits(20),
                                                     (1 << 33) - 1]
    group = GroupKernel(n, W)
    for a in edge[1:5:2] if W > 32 else edge[:5]:
        assert group.powmod_lanes([a] * len(exps), exps) == [pow(a, e, n) for e in exps]
        for e in exps:
            assert k.powmod_shared(a, e) == pow(a, e, n)
    c = [rng.randrange(n) for _ in range(5)]
    for xb, yb, s in ((123321, 123654, 37), (0, 5, 0), (1, 0, 65535)):
        want = pow(c[0] * pow(c[1], xb, n) * pow(c[2], yb, n) % n, s, n) * c[3] * c[4] % n
        assert k.blind_distance(*c, xb, yb, s) == want


def test_kernel_model_at_a_full_decrypt_exponent():
    """c^vpq at k = 512 (vpq of 128 bits) and W = 17 in the one-thread
    model's order (the blind distance's) lands in the decryption table."""
    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7)
    D = (pub.n.bit_length() + 15) // 16 + 1
    k = Kernel(pub.n, (D + 1) // 2)
    for m in (0, 1, pub.u - 1):
        c = dgk.dgk_encrypt(pub, m, 99991)
        assert priv.rtab[k.powmod_shared(c, priv.vpq)] == m


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
        self.n0inv, self.W = words[4 * Wp], W

    def mul(self, a, b):
        return group_cios(a, b, self.n, self.n0inv)

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


@pytest.mark.parametrize("bits", [497, 528, 2033, 2064])
def test_group_product_against_pow(bits):
    """group_cios at the built (G, L) on the edge cases, per lane, against
    Python's products; at W = 65 also the other group sizes weighed."""
    rng = random.Random(bits)
    n = _modulus(bits, rng)
    W = ((bits + 15) // 16 + 2) // 2
    shapes = [GEOMETRY[W][:2]] + ([(4, 17), (8, 9)] if W == 65 else [(2, 9)])
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
                 lambda: dgk_cuda.powmod_shared_exp_cuda(mc, x, 3),
                 lambda: dgk_cuda.blind_distance_cuda(mc, x, x, x, 1, 2, 3, x, x)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    with pytest.raises(ValueError, match="no DGK"):
        dgk_cuda.mulmod(mc, x.to("meta"), x.to("meta"))
    n384 = (1 << 383) | 12345
    with pytest.raises(ValueError, match="W = 13"):
        dgk_cuda._width(MontgomeryCtx.build(n384, device="cpu"))
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
    multiply slots, against the words moved; the longer of the two binds."""
    from pplp_tpu_torch import measure_dgk
    from pplp_tpu_torch.measure_multiply import BYTES_PER_S, MULS_PER_S

    for e in (0, 1, 2, 3, 0b1011, (1 << 800) - 1, 1 << 799):
        want = 0 if e == 0 else (e.bit_length() - 1) + (bin(e).count("1") - 1)
        assert measure_dgk.dgk_products(e) == want, e
    assert measure_dgk.MAD_SLOTS == 2
    assert measure_dgk.dgk_bound(65, 1000, 10) == {
        "bound_ms": 1000 * 8515 * 2 / MULS_PER_S * 1e3, "bound_by": "operations",
        "products": 1000}
    c = measure_dgk.dgk_bound(17, 1, 10 ** 9)
    assert c["bound_by"] == "bytes" and c["bound_ms"] == 4 * 10 ** 9 / BYTES_PER_S * 1e3
