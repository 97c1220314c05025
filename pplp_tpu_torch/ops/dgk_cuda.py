"""Load and launch the DGK back-end's Montgomery kernels (``csrc/dgk_mont.cu``).

They replace no Pallas kernel: the reference's batched DGK runs its
Montgomery product as the XLA CIOS scan ``pplp_tpu/dgk/modexp.py:111``.
Four kernels, each one launch:

* ``mulmod``: a b mod n per lane, b per lane or one for all (encrypt's
  g^m h^r); ``mulmod_const``: a c mod n for one Python-int c, one
  Montgomery product a lane by c R' mod n made on the host (the BSGS giant
  step, as the reference runs it);
* ``powmod``: base^e mod n with per-lane exponents and a shared or
  per-lane base (encrypt's g^m and h^r);
* ``powmod_shared_exp``: base^e mod n with one exponent for every lane
  (the decrypt's c^vpq);
* ``blind_distance``: ((c1 c2^xb c3^yb)^s) cz cr mod n per lane, the
  server's whole DGK chain.

The port keeps numbers as rows of 16-bit digits in int64 tensors [B, D]
(``dgk.modexp``). Every kernel runs a group of G threads a number at
R' = 2^(32 W'), W' = G L, with the geometry the library was built with at
each compiled width (``WIDTHS``, ``group``). A modulus of W = ceil(D / 2)
32-bit limbs runs at the smallest compiled width at or above W, with zero
limbs above n; one wider than the widest raises. ``mulmod`` and
``blind_distance`` read and write the digit rows themselves; the two
exponentiations take rows of u32 limbs (int32 tensors holding the u32
bits) at the compiled width, and converting is this module's job. The
modulus' constants (made at W') and the shared exponents (at most 2048
bits) are packed here on the host and go to the kernel by value.

Each function takes CUDA tensors; the dispatchers (``mulmod``,
``mulmod_const``, ``powmod``, ``powmod_shared_exp``, ``blind_distance``)
send a CPU tensor to the plain version (``dgk.modexp.MontgomeryCtx``,
``mulmod_const_plain``, ``blind_distance_plain``) and raise on any other
device. ``launches_by_kernel`` counts launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools
from itertools import repeat

import numpy as np
import torch

from ..dgk.modexp import DIGIT_BITS, MontgomeryCtx, exp_to_bits, to_digits
from . import cuda_build

__all__ = ["mulmod", "mulmod_const", "powmod", "powmod_shared_exp", "blind_distance",
           "mulmod_const_plain", "powmod_plain", "blind_distance_plain",
           "mulmod_cuda", "mulmod_const_cuda", "powmod_cuda", "powmod_shared_exp_cuda",
           "blind_distance_cuda", "limbs", "width", "WIDTHS", "group", "launches_by_kernel",
           "reset_launches"]

SOURCE = cuda_build.CSRC / "dgk_mont.cu"
# The widths dgk_mont.cu is compiled for (PPLP_DGK_GROUPS): k = 512, 1024,
# 2048, 3072 and 4096 keys.
WIDTHS = (17, 33, 65, 97, 129)
EXP_WORDS = 64  # a shared exponent's 32-bit words (at most 2048 bits)

launches_by_kernel = {"dgk_mulmod": 0, "dgk_powmod_lanes": 0, "dgk_powmod_shared": 0,
                      "dgk_blind_distance": 0}


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _count(name: str):
    launches_by_kernel[name] += 1


def _declare(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pplp_dgk_mulmod.argtypes = [vp, vp, ll, vp, i, i, i, vp, vp]
    lib.pplp_dgk_mulmod_mont.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.pplp_dgk_powmod_lanes.argtypes = [vp, ll, vp, i, i, vp, i, i, vp, vp]
    lib.pplp_dgk_powmod_shared.argtypes = [vp, vp, i, i, vp, vp, vp, vp]
    lib.pplp_dgk_blind_distance.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, vp, vp, vp, vp]
    lib.pplp_dgk_group.argtypes = [i, vp]
    for fn in (lib.pplp_dgk_mulmod, lib.pplp_dgk_mulmod_mont, lib.pplp_dgk_powmod_lanes,
               lib.pplp_dgk_powmod_shared, lib.pplp_dgk_blind_distance, lib.pplp_dgk_group):
        fn.restype = ctypes.c_int


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def limbs(mc: MontgomeryCtx) -> int:
    """W, the 32-bit limbs of a number of ``mc``'s D digits."""
    return (mc.D + 1) // 2


def width(mc: MontgomeryCtx) -> int:
    """The compiled width ``mc``'s modulus runs at: the smallest of
    ``WIDTHS`` at or above its W limbs (the limbs above n are zero). Raises
    for a modulus wider than the widest."""
    W = limbs(mc)
    for Wc in WIDTHS:
        if Wc >= W:
            return Wc
    raise ValueError(f"the DGK kernels take moduli of at most {WIDTHS[-1]} 32-bit limbs "
                     f"({32 * WIDTHS[-1] - 16} bits); n has {mc.n_int.bit_length()} bits, "
                     f"W = {W}")


@functools.lru_cache(maxsize=None)
def group(W: int) -> tuple[int, int, int]:
    """The group kernels' geometry at width W, as the library was built:
    (G threads a number, L limbs a thread, window bits); W' = G L."""
    lib, geometry = load(), (ctypes.c_int * 3)()
    cuda_build.check(lib.pplp_dgk_group(W, geometry), lib, "dgk_group")
    return tuple(geometry)


def _words(v: int, W: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(4 * W, "little"), "<u4")


@functools.lru_cache(maxsize=16)
def _consts(n: int, W: int) -> np.ndarray:
    """n, R'^2 mod n, R' mod n (W words each) and -n^-1 mod 2^32, R' = 2^(32 W)."""
    R = 1 << (32 * W)
    parts = [_words(v, W) for v in (n, R * R % n, R % n)]
    return np.concatenate(parts + [np.array([(-pow(n, -1, 1 << 32)) % (1 << 32)], "<u4")])


def _mont_words(n: int, c: int, W: int) -> np.ndarray:
    """c R' mod n as W words, R' = 2^(32 W)."""
    return _words(c * (1 << (32 * W)) % n, W)


def _shared_exponents(exps) -> tuple[np.ndarray, np.ndarray]:
    """Up to three exponents -> ([3, EXP_WORDS] u32 words, [3] int32 bit lengths)."""
    words = np.zeros((3, EXP_WORDS), "<u4")
    bits = np.zeros(3, np.int32)
    for k, e in enumerate(exps):
        e = int(e)
        if e < 0 or e.bit_length() > 32 * EXP_WORDS:
            raise ValueError(f"a shared exponent must lie in [0, 2^{32 * EXP_WORDS}), got {e}")
        words[k] = _words(e, EXP_WORDS)
        bits[k] = e.bit_length()
    return words, bits


def _pack_exponents(exps, pin: bool = False) -> tuple[torch.Tensor, int, int]:
    """Per-lane exponents -> (int32 [B * ew] host tensor of their u32 words,
    ew words a lane, little-endian; ew; the widest exponent's bits), in one
    pass of ``int.to_bytes`` into one buffer, page-locked if ``pin``: PyTorch
    waits for the stream's queued kernels before a copy from pageable
    memory returns, and not before a non-blocking one from page-locked
    memory (whose block the caching host allocator keeps until the copy is
    done)."""
    exps = list(map(int, exps))
    if exps and min(exps) < 0:
        raise ValueError("exponents must be non-negative")
    bits = max(map(int.bit_length, exps), default=0)
    ew = max(1, (bits + 31) // 32)
    raw = b"".join(map(int.to_bytes, exps, repeat(4 * ew), repeat("little")))
    host = torch.empty(len(exps) * ew, dtype=torch.int32, pin_memory=pin)
    host.numpy()[:] = np.frombuffer(raw, "<i4")
    return host, ew, bits


def _to_words(digs: torch.Tensor, W: int) -> torch.Tensor:
    """[B, D] int64 16-bit digits -> contiguous int32 [B, W] holding the u32 limbs."""
    pad = 2 * W - digs.shape[-1]
    if pad:
        digs = torch.nn.functional.pad(digs, (0, pad))
    words = digs[..., 0::2] | (digs[..., 1::2] << DIGIT_BITS)
    return words.to(torch.int32).contiguous()


def _to_digits(words: torch.Tensor, D: int) -> torch.Tensor:
    """int32 [B, W] u32 limbs -> int64 [B, D] 16-bit digits."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    digs = torch.stack([w & 0xFFFF, w >> DIGIT_BITS], dim=-1)
    return digs.reshape(w.shape[0], -1)[:, :D].contiguous()


def _check(mc: MontgomeryCtx, *tensors) -> int:
    """The compiled width, once the tensors are CUDA int64 [B, D] digit rows
    on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the DGK kernels take CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[-1] != mc.D:
            raise ValueError(f"numbers must be int64 [B, {mc.D}] digit rows, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return width(mc)


def _launch(name, fn, *args):
    code = fn(*args)
    cuda_build.check(code, load(), name)
    _count(name)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _inner(Wc: int) -> int:
    """W' = G L, the kernels' width inside at compiled width Wc."""
    G, L, _ = group(Wc)
    return G * L


def mulmod_cuda(mc: MontgomeryCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b mod n: a [B, D], b [B, D] or [1, D] (one for every lane)."""
    Wc = _check(mc, a, b)
    B = a.shape[0]
    if b.shape[0] not in (1, B):
        raise ValueError(f"b has {b.shape[0]} rows for {B} lanes")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((B, mc.D), dtype=torch.int64, device=a.device)
    if B:
        consts = _consts(mc.n_int, _inner(Wc))
        _launch("dgk_mulmod", load().pplp_dgk_mulmod, a.data_ptr(), b.data_ptr(),
                mc.D if b.shape[0] == B else 0, out.data_ptr(), B, mc.D, Wc,
                consts.ctypes.data, _stream(a))
    return out


def mulmod_const_cuda(mc: MontgomeryCtx, a: torch.Tensor, c: int) -> torch.Tensor:
    """a c mod n for a [B, D] and one Python int c: one Montgomery product a
    lane by c R' mod n, made here."""
    Wc = _check(mc, a)
    B = a.shape[0]
    a = a.contiguous()
    out = torch.empty((B, mc.D), dtype=torch.int64, device=a.device)
    if B:
        Wp = _inner(Wc)
        consts, bm = _consts(mc.n_int, Wp), _mont_words(mc.n_int, int(c), Wp)
        _launch("dgk_mulmod", load().pplp_dgk_mulmod_mont, a.data_ptr(), out.data_ptr(), B,
                mc.D, Wc, consts.ctypes.data, bm.ctypes.data, _stream(a))
    return out


def powmod_cuda(mc: MontgomeryCtx, base: torch.Tensor, exps) -> torch.Tensor:
    """base^e mod n for per-lane Python-int exponents ``exps`` (B of them):
    base [B, D] or [1, D] (one for every lane) -> [B, D]."""
    Wc = _check(mc, base)
    host, ew, bits = _pack_exponents(exps, pin=True)
    B = host.numel() // ew
    if base.shape[0] not in (1, B):
        raise ValueError(f"base has {base.shape[0]} rows for {B} exponents")
    ebuf = host.to(base.device, non_blocking=True)
    bw = _to_words(base, Wc)
    out = torch.empty((B, Wc), dtype=torch.int32, device=base.device)
    if B:
        consts = _consts(mc.n_int, _inner(Wc))
        _launch("dgk_powmod_lanes", load().pplp_dgk_powmod_lanes, bw.data_ptr(),
                Wc if base.shape[0] == B else 0, ebuf.data_ptr(), ew, bits, out.data_ptr(), B,
                Wc, consts.ctypes.data, _stream(base))
    return _to_digits(out, mc.D)


def powmod_shared_exp_cuda(mc: MontgomeryCtx, base: torch.Tensor, exp: int) -> torch.Tensor:
    """base^exp mod n for per-lane bases [B, D] and one Python-int exponent."""
    Wc = _check(mc, base)
    words, bits = _shared_exponents([exp])
    bw = _to_words(base, Wc)
    out = torch.empty_like(bw)
    if base.shape[0]:
        consts = _consts(mc.n_int, _inner(Wc))
        _launch("dgk_powmod_shared", load().pplp_dgk_powmod_shared, bw.data_ptr(),
                out.data_ptr(), base.shape[0], Wc, consts.ctypes.data,
                words.ctypes.data, bits.ctypes.data, _stream(base))
    return _to_digits(out, mc.D)


def blind_distance_cuda(mc: MontgomeryCtx, c1, c2, c3, xb: int, yb: int, s_blind: int,
                        cz, cr) -> torch.Tensor:
    """((c1 c2^xb c3^yb)^s) cz cr mod n over [B, D] ciphertexts, one launch."""
    Wc = _check(mc, c1, c2, c3, cz, cr)
    B = c1.shape[0]
    if any(c.shape[0] != B for c in (c2, c3, cz, cr)):
        raise ValueError("the five ciphertext batches differ in size")
    words, bits = _shared_exponents([xb, yb, s_blind])
    cs = [c.contiguous() for c in (c1, c2, c3, cz, cr)]
    out = torch.empty((B, mc.D), dtype=torch.int64, device=c1.device)
    if B:
        consts = _consts(mc.n_int, _inner(Wc))
        _launch("dgk_blind_distance", load().pplp_dgk_blind_distance,
                *(c.data_ptr() for c in cs), out.data_ptr(), B, mc.D, Wc,
                consts.ctypes.data, words.ctypes.data, bits.ctypes.data, _stream(c1))
    return out


def mulmod_const_plain(mc: MontgomeryCtx, a: torch.Tensor, c: int) -> torch.Tensor:
    """``mulmod_const``'s plain version, the reference's giant step: one
    Montgomery product by c R mod n (``to_mont`` of c, made on the host)."""
    R = 1 << (DIGIT_BITS * mc.D)
    return mc.mont_mul(a, to_digits([int(c) * R % mc.n_int], mc.D, a.device))


def powmod_plain(mc: MontgomeryCtx, base: torch.Tensor, exps) -> torch.Tensor:
    """``powmod``'s plain version: the reference's bit-array form."""
    exps = [int(e) for e in exps]
    bits = max((e.bit_length() for e in exps), default=0) or 1
    return mc.powmod(base, exp_to_bits(exps, bits))


def blind_distance_plain(mc: MontgomeryCtx, c1, c2, c3, xb: int, yb: int, s_blind: int,
                         cz, cr) -> torch.Tensor:
    """``blind_distance``'s plain version, the reference's chain: five
    conversions in, one out, the products in the Montgomery domain."""
    c1m, c2m, c3m = mc.to_mont(c1), mc.to_mont(c2), mc.to_mont(c3)
    czm, crm = mc.to_mont(cz), mc.to_mont(cr)
    t2 = mc.powmod_shared_exp_mont(c2m, xb)
    t3 = mc.powmod_shared_exp_mont(c3m, yb)
    acc = mc.mont_mul(mc.mont_mul(c1m, t2), t3)
    acc = mc.powmod_shared_exp_mont(acc, s_blind)
    return mc.from_mont(mc.mont_mul(mc.mont_mul(acc, czm), crm))


def _on(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on other devices."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no DGK {what} for device {t.device}")
    return False


def mulmod(mc: MontgomeryCtx, a, b):
    """a b mod n: the kernel for CUDA tensors, the plain version for CPU ones."""
    return mulmod_cuda(mc, a, b) if _on(a, "product") else mc.mulmod(a, b)


def mulmod_const(mc: MontgomeryCtx, a, c: int):
    """a c mod n for one Python int c: the kernel or the plain version."""
    fn = mulmod_const_cuda if _on(a, "product") else mulmod_const_plain
    return fn(mc, a, c)


def powmod(mc: MontgomeryCtx, base, exps):
    """base^e mod n with per-lane exponents: the kernel or the plain version."""
    return powmod_cuda(mc, base, exps) if _on(base, "exponentiation") else powmod_plain(
        mc, base, exps)


def powmod_shared_exp(mc: MontgomeryCtx, base, exp: int):
    """base^exp mod n, one exponent: the kernel or the plain version."""
    if _on(base, "exponentiation"):
        return powmod_shared_exp_cuda(mc, base, exp)
    return mc.powmod_shared_exp(base, exp)


def blind_distance(mc: MontgomeryCtx, c1, c2, c3, xb, yb, s_blind, cz, cr):
    """The blind-distance chain: the kernel or the plain version."""
    fn = blind_distance_cuda if _on(c1, "blind distance") else blind_distance_plain
    return fn(mc, c1, c2, c3, xb, yb, s_blind, cz, cr)
