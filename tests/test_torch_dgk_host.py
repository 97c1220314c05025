"""The port's DGK host code against the reference's, and a model of the
DGK kernel's arithmetic, on the CPU.

* the copies ``maurer``, ``gdsa``, ``ph`` and ``dgk``: the same seed gives
  the same primes, keys and decryption table, ``save_dgk_keys`` the same
  bytes, and the number-theory helpers the same answers;
* a Python model of ``csrc/dgk_mont.cu``: CIOS on 32-bit limbs with its
  carries and its final subtraction, and the kernels' square-and-multiply
  orders, limb for limb on Python ints, against ``pow`` at both compiled
  widths (W = 17 and 65) with the edge cases (0, 1, n - 1, values just
  below n, exponent 0). A carry mistake in the kernel's scheme shows here
  before a chip call; change model and kernel together.

Bit-exact throughout (tolerance 0): all arithmetic is exact integers.
"""

import importlib
import random

import pytest

from pplp_tpu_torch.ops import dgk_cuda

# The packages export functions named like their modules (``maurer``).
rdgk, rgdsa, rmaurer, rph = (importlib.import_module(f"pplp_tpu.dgk.{m}")
                             for m in ("dgk", "gdsa", "maurer", "ph"))
dgk, gdsa, maurer, ph = (importlib.import_module(f"pplp_tpu_torch.dgk.{m}")
                         for m in ("dgk", "gdsa", "maurer", "ph"))

K, T, L = 512, 64, 12


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
    """The kernels' entry points on the model, with dgk_cuda's constants."""

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

    def powmod_lanes(self, base, e, exp_bits):
        base = self.mul(_limbs(base, self.W), self.r2)
        x, started = list(self.one), False
        for bit in range(exp_bits - 1, -1, -1):
            if started:
                x = self.mul(x, list(x))
            if (e >> bit) & 1:
                x, started = (self.mul(x, base), True) if started else (list(base), True)
        return _value(self.mul(x, self.unit))

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
    top = max(e.bit_length() for e in exps)
    for a in edge[1:5:2] if W > 32 else edge[:5]:
        for e in exps:
            assert k.powmod_lanes(a, e, top) == pow(a, e, n)
            assert k.powmod_shared(a, e) == pow(a, e, n)
    c = [rng.randrange(n) for _ in range(5)]
    for xb, yb, s in ((123321, 123654, 37), (0, 5, 0), (1, 0, 65535)):
        want = pow(c[0] * pow(c[1], xb, n) * pow(c[2], yb, n) % n, s, n) * c[3] * c[4] % n
        assert k.blind_distance(*c, xb, yb, s) == want


def test_kernel_model_at_a_full_decrypt_exponent():
    """c^vpq at k = 512 (vpq of 128 bits) and W = 17: the model of the
    decrypt kernel lands in the decryption table."""
    priv, pub = dgk.dgk_gen_keys(K, T, L, seed=7)
    D = (pub.n.bit_length() + 15) // 16 + 1
    k = Kernel(pub.n, (D + 1) // 2)
    for m in (0, 1, pub.u - 1):
        c = dgk.dgk_encrypt(pub, m, 99991)
        assert priv.rtab[k.powmod_shared(c, priv.vpq)] == m


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
