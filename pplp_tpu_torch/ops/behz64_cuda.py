"""Load and launch the m62 BEHZ multiply + relinearization (``csrc/behz64.cu``).

The u64 route of the seal chains (2^32 <= q < 2^62). It replaces no Pallas
kernel: the reference runs the m62 multiply through XLA
(``pplp_tpu/bfv/behz.py:388``, ``RnsMultiplier.multiply``, and ``:772``,
``relinearize``). Separate launches around the u64 transforms of
``ntt_cuda`` (one launch per base and direction):

* ``multiply``: ``to_bsk``, the forward transforms over Q and B_sk,
  ``tensor_spectra`` (both bases, one launch), the inverse transforms,
  ``floor_sk``: 7 launches;
* ``relinearize``: ``lift_digits`` (width 1 or 2, read from the keys'
  groups), the forward transform of the digits, ``key_products``, the
  inverse transform, ``add_switched``: 5 launches.

Every intermediate is u64 (int64 tensors holding the same bits,
[component, batch, limb, n]) and canonical, so each step equals its plain
step of ``bfv.behz`` bit for bit: ``RnsMultiplier._to_bsk``,
``tensor_spectra``, ``_fast_floor`` + ``_sk_to_q``, ``lift_digit_grouped``,
``key_products`` and the profile's ``add``. ``bfv.behz_fused`` dispatches
an m62 CUDA context here; these wrappers take CUDA tensors only and raise on
anything else, and a launch error raises. Bounds: L <= 40, |B_sk| <= 48
(the source's header).

``launches`` counts launches of ``behz64.cu`` (the transforms are counted by
``ntt_cuda``); ``launches_by_kernel`` splits them. The packed constants are
cached here, keyed by the multiplier and keys objects they were packed from.
The conversions' constants fold the steps between two conversions that
stay in one modulus, and are split into 32-bit words for the kernels'
multiply-adds (``_pack_constants``, behz64.cu's header).
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import cuda_build, ntt_cuda
from .modmath import shoup_ints

__all__ = ["multiply", "relinearize", "to_bsk", "tensor_spectra", "floor_sk", "lift_digits",
           "key_products", "add_switched", "launches", "launches_by_kernel", "reset_launches",
           "MAX_L", "MAX_K"]

SOURCE = cuda_build.CSRC / "behz64.cu"
MAX_L = 40
MAX_K = 48
_NO_LIMB = (1 << 64) - 1
_BITS = 64  # Shoup companions floor(w 2^64 / q)
_BSK_BITS = 60  # B_sk primes below 2^60 keep every conversion sum below 2^128
_Q_SPLIT = 31  # a residue mod q (< 2^62) is split into words at bit 31
_B_SPLIT = 30  # a value below 2^60 (mod a B_sk prime) at bit 30

launches = 0
launches_by_kernel = {"behz64_to_bsk": 0, "behz64_tensor": 0, "behz64_floor_sk": 0,
                      "behz64_lift": 0, "behz64_keyprod": 0, "behz64_add": 0}

# multiplier -> ({kernel: constants' device address}, host scalars, the
# device tensor holding them); keys -> {(moduli, device): (lift buffer,
# packed keys)}
_mul_buffers: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_key_buffers: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def reset_launches():
    global launches
    launches = 0
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _count(name: str):
    global launches
    launches += 1
    launches_by_kernel[name] += 1


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pplp_behz64_to_bsk.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pplp_behz64_tensor.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.pplp_behz64_floor_sk.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.pplp_behz64_lift.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    lib.pplp_behz64_keyprod.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.pplp_behz64_add.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    for name in ("to_bsk", "tensor", "floor_sk", "lift", "keyprod", "add"):
        getattr(lib, f"pplp_behz64_{name}").restype = ci


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def _ratios(moduli) -> list[int]:
    """floor(2^128 / q) per modulus as (low, high) 64-bit words."""
    out = []
    for m in moduli:
        r = (1 << 128) // m.value
        out += [r & ((1 << 64) - 1), r >> 64]
    return out


def _split(values, s: int) -> list[int]:
    """Conversion constants as one u64 each: the bits below ``s`` in the low
    word, the rest (below 2^32) in the high word. A constant is split at 61
    minus its source's split (``_Q_SPLIT``, ``_B_SPLIT``), so each of a
    term's four partial products stays below 2^61 (behz64.cu's header)."""
    out = []
    for c in values:
        if c >> (s + 32):
            raise ValueError(f"constant {c} too wide for a split at bit {s}")
        out.append((c & ((1 << s) - 1)) | ((c >> s) << 32))
    return out


def _pack_constants(mul) -> tuple[dict, list[int]]:
    """The multiplier's constants in the layouts of behz64.cu, as values below
    2^64: {kernel: its buffer} for ``tensor`` (``Consts``), ``to_bsk``
    (``ToBsk``) and ``floor_sk`` (``FloorSk``), and the two scalars the
    kernels take from host memory (-q^-1 mod m~, m_sk // 2).

    The conversions' constants fold every step that stays in one modulus
    (behz64.cu's header): to_bsk's (q / q_i) m~^-1 and (q m~^-1) mod b_d;
    floor_sk's t qhat_i^-1 mod q_i, then -(q / q_j) q^-1 bhat_i^-1 and
    t q^-1 bhat_i^-1 mod b_i, alpha's (M / b_i) M^-1, -t q^-1 M^-1 and
    (q / q_j) q^-1 M^-1 mod m_sk, and (M / b_i), -M mod q_d."""
    ctx = mul.ctx
    qm, bm = [m.value for m in ctx.moduli], [m.value for m in mul.bsk_moduli]
    L, K, l, t = ctx.L, mul.K, mul.l, ctx.t
    msk = bm[l]
    cqb, imt, iqb = mul.conv_q_to_bsk, mul.inv_mtilde_bsk_ints, mul.inv_q_bsk_ints

    def shoup(vals, mods):  # constants, then their Shoup companions
        w, ws = shoup_ints(vals, mods, _BITS)
        return w + [v % (1 << 64) for v in ws]

    def q_terms(vals):  # constants of terms whose source is a residue mod q
        return _split(vals, 61 - _Q_SPLIT)

    def b_terms(vals):  # constants of terms whose source is below 2^60
        return _split(vals, 61 - _B_SPLIT)

    xq = []
    for d, b in enumerate(bm):
        xq += q_terms([cqb[d][i] * imt[d] % b for i in range(L)]
                      + [mul.q_mod_bsk_ints[d] * imt[d] % b])
    fb = []
    for i, b in enumerate(bm[:l]):
        f = iqb[i] * mul.bhat_inv_b[i] % b
        fb += q_terms([-cqb[i][j] * f % b for j in range(L)]) + b_terms([t * f % b])
    f = iqb[l] * mul.inv_M_msk_int % msk
    fa = (b_terms([c * mul.inv_M_msk_int % msk for c in mul.conv_b_to_msk[0]] + [-t * f % msk])
          + q_terms([cqb[l][j] * f % msk for j in range(L)]))
    fq = []
    for d, q in enumerate(qm):
        fq += b_terms(list(mul.conv_b_to_q[d]) + [-mul.M % q])
    ratios_q, ratios_b = _ratios(ctx.moduli), _ratios(mul.bsk_moduli)
    bufs = {
        "tensor": qm + bm + ratios_q + ratios_b,
        "to_bsk": (qm + shoup(mul.mtilde_qhat_inv_ints, qm) + mul.conv_q_to_mtilde_ints + bm
                   + ratios_b + xq),
        "floor_sk": (qm + ratios_q + shoup([t * v % q for v, q in zip(mul.qhat_inv_ints, qm)], qm)
                     + mul.mskM_mod_q_ints + bm + ratios_b + fb + fa + fq),
    }
    return bufs, [mul.neg_inv_q_mtilde, mul.msk_half]


def _pack_lift(ctx, groups) -> list[int]:
    """q [L], floor(2^128 / q) [L][2], then per digit: i0, i1 (or none),
    q0^-1 mod q1 + companion, then (q0 mod q_d, companion) for every limb d
    (``lift64_kernel``)."""
    qs = [m.value for m in ctx.moduli]
    buf = qs + _ratios(ctx.moduli)
    for g in groups:
        if len(g) == 1:
            buf += [g[0], _NO_LIMB, 0, 0] + [0] * (2 * len(qs))
            continue
        if len(g) != 2:
            raise NotImplementedError("digits wider than two limbs need Garner lifting")
        i0, i1 = g
        inv, inv_s = shoup_ints([pow(qs[i0], -1, qs[i1])], [qs[i1]], _BITS)
        buf += [i0, i1, inv[0], inv_s[0] % (1 << 64)]
        w, ws = shoup_ints([qs[i0]] * len(qs), qs, _BITS)
        buf += [v % (1 << 64) for pair in zip(w, ws) for v in pair]
    return buf


def _u64_buffer(values, device) -> torch.Tensor:
    """Integers in [0, 2^64) -> a contiguous int64 tensor on ``device``
    holding the same 64 bits, which a kernel reads as uint64."""
    host = np.asarray(values, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def _constants(mul) -> tuple[dict, np.ndarray]:
    """({kernel: device address of its constant buffer}, host u64 scalars)
    of ``mul``; the buffers share one device tensor, kept with them."""
    bufs = _mul_buffers.get(mul)
    if bufs is None:
        parts, scalars = _pack_constants(mul)
        dev = _u64_buffer([v for part in parts.values() for v in part], mul.ctx.device)
        ptrs, offset = {}, 0
        for name, part in parts.items():
            ptrs[name] = dev.data_ptr() + 8 * offset
            offset += len(part)
        bufs = _mul_buffers[mul] = (ptrs, np.asarray(scalars, dtype=np.uint64), dev)
    return bufs[0], bufs[1]


def _key_buffers_of(ctx, rlk) -> tuple[torch.Tensor, torch.Tensor]:
    """(lift buffer, keys packed as (k0, k0', k1, k1') per coefficient
    [D, L, n, 4]) of ``rlk`` on ``ctx``."""
    per_keys = _key_buffers.setdefault(rlk, {})
    key = (tuple(m.value for m in ctx.moduli), ctx.device)
    bufs = per_keys.get(key)
    if bufs is None:
        lift = _u64_buffer(_pack_lift(ctx, rlk.digit_groups(ctx.L)), ctx.device)
        keys = torch.stack([rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup], -1).contiguous()
        bufs = per_keys[key] = (lift, keys)
    return bufs


def _check_i64(x, shape, what, device):
    if (not x.is_cuda or x.dtype != torch.int64 or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{what} must be a contiguous, 16-byte aligned CUDA int64 "
                         f"{list(shape)} tensor, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.device != device:
        raise ValueError(f"{what} on {x.device}, context on {device}")


def _validate(polys, ctx) -> int:
    """Every residue tensor: CUDA, int64, contiguous, 16-byte aligned,
    [..., L, n] of one shape on the context's device. Returns the flattened
    batch B."""
    L, n = ctx.L, ctx.n
    shape = polys[0].shape
    for x in polys:
        if not x.is_cuda:
            raise ValueError(f"the CUDA BEHZ kernels take CUDA tensors, got {x.device}")
        if x.dim() < 2 or x.shape[-2:] != (L, n) or x.shape != shape:
            raise ValueError(f"expected matching [..., {L}, {n}] tensors, got {tuple(x.shape)}")
        if x.dtype != torch.int64:
            raise TypeError(f"residues must be int64, got {x.dtype}")
        _check_i64(x, shape, "residue tensor", ctx.device)
    if ctx.tables.profile != "m62":
        raise ValueError("the u64 BEHZ kernels take an m62 (seal) context")
    if not 6 <= ctx.tables.logn <= 15:
        raise ValueError(f"n = {n} outside the kernels' range [64, 32768]")
    return polys[0].numel() // (L * n)


def _check_bounds(mul):
    """L, |B_sk| and the B_sk primes within the bounds under which the
    kernels' 128-bit conversion sums cannot wrap (behz64.cu's header)."""
    L, K = mul.ctx.L, mul.K
    if L > MAX_L or K > MAX_K:
        raise ValueError(f"L = {L}, |B_sk| = {K} exceed the kernel's bounds "
                         f"({MAX_L}, {MAX_K})")
    if max(m.value for m in mul.bsk_moduli) >> _BSK_BITS:
        raise ValueError(f"the kernels need B_sk primes below 2^{_BSK_BITS}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _empty(*shape, device):
    return torch.empty(shape, dtype=torch.int64, device=device)


def _launch(lib, name: str, *args):
    cuda_build.check(getattr(lib, "pplp_" + name)(*args), lib, name)
    _count(name)


def to_bsk(c0, c1, d0, d1, mul) -> torch.Tensor:
    """Base extension of the four inputs [..., L, n] -> xb [4, B, K, n]."""
    ctx = mul.ctx
    B = _validate((c0, c1, d0, d1), ctx)
    _check_bounds(mul)
    xb = _empty(4, B, mul.K, ctx.n, device=c0.device)
    if B == 0:
        return xb
    lib = load()
    consts, scalars = _constants(mul)
    _launch(lib, "behz64_to_bsk", c0.data_ptr(), c1.data_ptr(), d0.data_ptr(), d1.data_ptr(),
            xb.data_ptr(), consts["to_bsk"], scalars.ctypes.data, B, ctx.L, mul.K,
            ctx.tables.logn, _stream(c0.device))
    return xb


def tensor_spectra(sq, sb, mul) -> tuple[torch.Tensor, torch.Tensor]:
    """The Karatsuba tensor products of the spectra sq [4, B, L, n] (over Q)
    and sb [4, B, K, n] (over B_sk) -> ([3, B, L, n], [3, B, K, n]), one
    launch."""
    ctx = mul.ctx
    _check_bounds(mul)
    if sq.dim() != 4:
        raise ValueError(f"spectra must be [4, B, {ctx.L}, {ctx.n}], got {tuple(sq.shape)}")
    B, L, K, n = sq.shape[1], ctx.L, mul.K, ctx.n
    _check_i64(sq, (4, B, L, n), "Q spectra", ctx.device)
    _check_i64(sb, (4, B, K, n), "B_sk spectra", ctx.device)
    eq, eb = _empty(3, B, L, n, device=sq.device), _empty(3, B, K, n, device=sq.device)
    if B == 0:
        return eq, eb
    consts, _ = _constants(mul)
    _launch(load(), "behz64_tensor", sq.data_ptr(), sb.data_ptr(), eq.data_ptr(), eb.data_ptr(),
            consts["tensor"], B, L, K, ctx.tables.logn, _stream(sq.device))
    return eq, eb


def floor_sk(eq, eb, mul) -> torch.Tensor:
    """Fast floor + Shenoy-Kumaresan of the products -> [3, B, L, n]."""
    ctx = mul.ctx
    _check_bounds(mul)
    L, K, n = ctx.L, mul.K, ctx.n
    B = eq.shape[1] if eq.dim() == 4 else -1
    _check_i64(eq, (3, B, L, n), "eq", ctx.device)
    _check_i64(eb, (3, B, K, n), "eb", ctx.device)
    out = _empty(3, B, L, n, device=eq.device)
    if B == 0:
        return out
    consts, scalars = _constants(mul)
    _launch(load(), "behz64_floor_sk", eq.data_ptr(), eb.data_ptr(), out.data_ptr(),
            consts["floor_sk"], scalars.ctypes.data, B, L, K, ctx.tables.logn,
            _stream(eq.device))
    return out


def multiply(c0, c1, d0, d1, mul) -> torch.Tensor:
    """(c0, c1) x (d0, d1), each [..., L, n] on the card -> [3, ..., L, n]."""
    ctx, tq, tb = mul.ctx, mul.ctx.tables, mul.bsk_tables
    batch = tuple(c0.shape[:-2])
    xb = to_bsk(c0, c1, d0, d1, mul)
    B = xb.shape[1]
    if B == 0:
        return _empty(*((3,) + batch + (ctx.L, ctx.n)), device=c0.device)
    x = torch.stack([c.reshape(B, ctx.L, ctx.n) for c in (c0, c1, d0, d1)])
    eq, eb = tensor_spectra(ntt_cuda.forward(x, tq), ntt_cuda.forward(xb, tb), mul)
    out = floor_sk(ntt_cuda.inverse(eq, tq), ntt_cuda.inverse(eb, tb), mul)
    return out.reshape((3,) + batch + (ctx.L, ctx.n))


def _check_keys(ctx, rlk) -> int:
    """The keys' digit count D after checking their tensors and L."""
    L, n, D = ctx.L, ctx.n, len(rlk.digit_groups(ctx.L))
    if L > MAX_L:
        raise ValueError(f"L = {L} exceeds the kernel's bound {MAX_L}")
    for k in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup):
        if (k.device != ctx.device or k.dtype != torch.int64
                or k.shape != (D, L, n) or not k.is_contiguous()):
            raise ValueError(f"relin keys must be contiguous int64 [{D}, {L}, {n}] on "
                             f"{ctx.device}, got {k.dtype} {tuple(k.shape)} on {k.device}")
    return D


def relinearize(c0, c1, c2, ctx, rlk) -> torch.Tensor:
    """Key-switch c2 with ``rlk`` (width-1 or width-2 digits) and add to
    (c0, c1); each [..., L, n] on the card -> [2, ..., L, n]."""
    B = _validate((c0, c1, c2), ctx)
    _check_keys(ctx, rlk)
    shape = (2,) + tuple(c0.shape[:-2]) + (ctx.L, ctx.n)
    if B == 0:
        return _empty(*shape, device=c0.device)
    dn = ntt_cuda.forward(lift_digits(c2, ctx, rlk), ctx.tables)
    d = ntt_cuda.inverse(key_products(dn, ctx, rlk), ctx.tables)
    return add_switched(c0, c1, d, ctx).reshape(shape)


def lift_digits(c2, ctx, rlk) -> torch.Tensor:
    """The gadget digits of c2 [..., L, n] lifted into every limb
    -> [D, B, L, n]."""
    B = _validate((c2,), ctx)
    D = _check_keys(ctx, rlk)
    dig = _empty(D, B, ctx.L, ctx.n, device=c2.device)
    if B == 0:
        return dig
    lift, _ = _key_buffers_of(ctx, rlk)
    _launch(load(), "behz64_lift", c2.data_ptr(), dig.data_ptr(), lift.data_ptr(), B, ctx.L, D,
            ctx.tables.logn, _stream(c2.device))
    return dig


def key_products(dn, ctx, rlk) -> torch.Tensor:
    """sum_g dn[g] * (k0[g], k1[g]) mod q of the digit spectra dn
    [D, B, L, n] -> [2, B, L, n]."""
    D = _check_keys(ctx, rlk)
    if dn.dim() != 4:
        raise ValueError(f"digit spectra must be [{D}, B, {ctx.L}, {ctx.n}]")
    B = dn.shape[1]
    _check_i64(dn, (D, B, ctx.L, ctx.n), "digit spectra", ctx.device)
    acc = _empty(2, B, ctx.L, ctx.n, device=dn.device)
    if B == 0:
        return acc
    _, keys = _key_buffers_of(ctx, rlk)
    _launch(load(), "behz64_keyprod", dn.data_ptr(), keys.data_ptr(), acc.data_ptr(),
            ntt_cuda.table_buffers(ctx.tables)["q"].data_ptr(), B, ctx.L, D, ctx.tables.logn,
            _stream(dn.device))
    return acc


def add_switched(c0, c1, d, ctx) -> torch.Tensor:
    """(c0 + d[0], c1 + d[1]) mod q: c0, c1 [..., L, n], d [2, B, L, n]
    -> [2, B, L, n]."""
    B = _validate((c0, c1), ctx)
    _check_i64(d, (2, B, ctx.L, ctx.n), "d", ctx.device)
    out = _empty(2, B, ctx.L, ctx.n, device=c0.device)
    if B == 0:
        return out
    _launch(load(), "behz64_add", c0.data_ptr(), c1.data_ptr(), d.data_ptr(), out.data_ptr(),
            ntt_cuda.table_buffers(ctx.tables)["q"].data_ptr(), B, ctx.L, ctx.tables.logn,
            _stream(c0.device))
    return out
