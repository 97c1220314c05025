"""Load and launch the Hopper BEHZ multiply + relinearization (``csrc/behz.cu``).

Replaces the Pallas kernel ``pplp_tpu/bfv/behz_fused.py::_kernel``. One
``multiply`` call launches, on the current stream, ``behz_to_bsk`` (the
per-coefficient base extension), ``behz_tensor_ntt`` (per (base, batch,
limb): the four forward transforms, the Karatsuba tensor product and the
three inverse transforms, in shared memory, Q and B_sk in one grid) and
``behz_floor_sk`` (fast floor + Shenoy-Kumaresan); ``relinearize`` launches
``behz_relin_ntt`` (per (batch, limb): the digit lifts, their transforms and
key products, the inverse transforms and the add). Every intermediate is
u32 in device memory (int32 tensors holding the same bits, [component,
batch, limb, n]); see the source's header for the design and its bounds
(L <= 40, |B_sk| <= 48).

Where a fused kernel's rows do not fit in shared memory (n above
``FUSED_TENSOR_MAX_N`` for the tensor kernel, above ``FUSED_RELIN_MAX_N``
for the relinearization) the wrapper launches the u32-I/O transforms of
``ntt_cuda`` around ``behz_tensor``, ``behz_lift``, ``behz_keyprod`` and
``behz_add`` instead (``tensor_spectra``, ``lift_digits``, ``key_products``,
``add_switched``): a dispatch on n, not a fallback.

The plain version is ``bfv.behz`` (``RnsMultiplier.multiply``,
``relinearize``); ``bfv.behz_fused.FusedMultiplier`` dispatches between the
two by device. These wrappers take CUDA tensors only and raise on anything
else; a launch error raises.

``launches`` counts kernel launches of ``behz.cu`` (the standalone NTT
launches are counted by ``ntt_cuda``); ``launches_by_kernel`` splits them.
The packed constant buffers are cached here, keyed by the multiplier and
keys objects they were packed from.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import cuda_build, ntt_cuda
from .modmath import shoup_ints

__all__ = ["multiply", "relinearize", "to_bsk", "tensor_products", "floor_sk",
           "tensor_spectra", "lift_digits", "key_products", "add_switched", "launches",
           "launches_by_kernel", "reset_launches", "MAX_L", "MAX_K", "FUSED_TENSOR_MAX_N",
           "FUSED_RELIN_MAX_N"]

SOURCE = cuda_build.CSRC / "behz.cu"
MAX_L = 40
MAX_K = 48
_NO_LIMB = 0xFFFFFFFF
# The largest n whose rows fit a block's 227 KB of shared memory: 4 rows of
# 4n bytes for behz_tensor_ntt, 3 for behz_relin_ntt.
FUSED_TENSOR_MAX_N = 8192
FUSED_RELIN_MAX_N = 16384

launches = 0
launches_by_kernel = {"behz_to_bsk": 0, "behz_tensor_ntt": 0, "behz_floor_sk": 0,
                      "behz_relin_ntt": 0, "behz_tensor": 0, "behz_lift": 0,
                      "behz_keyprod": 0, "behz_add": 0}

# multiplier -> (device constants, host scalars); keys -> {("lift" | "keys",
# moduli, device): the lift buffer or the packed keys of those limbs}
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
    lib.pplp_behz_to_bsk.argtypes = [vp] * 9 + [ci] * 4 + [vp]
    lib.pplp_behz_tensor_ntt.argtypes = [vp] * 9 + [ci] * 4 + [vp]
    lib.pplp_behz_floor_sk.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pplp_behz_relin_ntt.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.pplp_behz_tensor.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.pplp_behz_lift.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.pplp_behz_keyprod.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.pplp_behz_add.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    for name in ("to_bsk", "tensor_ntt", "floor_sk", "relin_ntt", "tensor", "lift",
                 "keyprod", "add"):
        getattr(lib, f"pplp_behz_{name}").restype = ci


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def _pack_constants(mul) -> tuple[list[int], list[int]]:
    """The multiplier's constants in the order of ``Consts`` in behz.cu:
    (the whole buffer, its four leading scalars)."""
    qmods, bsk = mul.ctx.moduli, mul.bsk_moduli
    l = mul.l
    b_basis, msk = bsk[:l], bsk[l]

    def shoup(vals, mods):  # constants, then their Shoup companions
        w, ws = shoup_ints(vals, [m.value for m in mods])
        return w + ws

    def table(conv, dst):  # [D][S] -> row-major constants, then companions
        return shoup([c for row in conv for c in row],
                     [d for row, d in zip(conv, dst) for _ in row])

    imm = shoup([mul.inv_M_msk_int], [msk])
    scalars = [mul.neg_inv_q_mtilde, imm[0], imm[1], mul.msk_half]
    buf = list(scalars)
    buf += [m.value for m in qmods] + [m.value for m in bsk]
    buf += shoup(mul.mtilde_qhat_inv_ints, qmods)
    buf += table(mul.conv_q_to_bsk, bsk)
    buf += mul.conv_q_to_mtilde_ints
    buf += shoup(mul.q_mod_bsk_ints, bsk)
    buf += shoup(mul.inv_mtilde_bsk_ints, bsk)
    buf += shoup(mul.t_mod_q_ints, qmods)
    buf += shoup(mul.t_mod_bsk_ints, bsk)
    buf += shoup(mul.inv_q_bsk_ints, bsk)
    buf += shoup(mul.qhat_inv_ints, qmods)
    buf += shoup(mul.bhat_inv_b, b_basis)
    buf += table(mul.conv_b_to_q, qmods)
    buf += table(mul.conv_b_to_msk, [msk])
    buf += shoup(mul.M_mod_q_ints, qmods)
    buf += mul.mskM_mod_q_ints
    return buf, scalars


def _pack_lift(ctx, groups) -> list[int]:
    """q[L], then per digit: i0, i1 (or none), q0^-1 mod q1 + companion,
    then (q0 mod q_d, companion) for every limb d (``lift_kernel``)."""
    qs = [m.value for m in ctx.moduli]
    buf = list(qs)
    for g in groups:
        if len(g) == 1:
            buf += [g[0], _NO_LIMB, 0, 0] + [0] * (2 * len(qs))
            continue
        if len(g) != 2:
            raise NotImplementedError("digits wider than two limbs need Garner lifting")
        i0, i1 = g
        q0, q1 = qs[i0], qs[i1]
        inv01 = pow(q0, -1, q1)
        buf += [i0, i1, inv01, (inv01 << 32) // q1]
        w, ws = shoup_ints([q0] * len(qs), qs)
        buf += [v for pair in zip(w, ws) for v in pair]
    return buf


def _constants(mul):
    """(u32 constant buffer on the card, host u32 scalars) of ``mul``."""
    bufs = _mul_buffers.get(mul)
    if bufs is None:
        consts, scalars = _pack_constants(mul)
        bufs = _mul_buffers[mul] = (cuda_build.u32_buffer(consts, mul.ctx.device),
                                    np.asarray(scalars, dtype=np.uint32))
    return bufs


def _lift_buffer(ctx, rlk) -> torch.Tensor:
    """The lift records of ``rlk``'s digit groups over ``ctx``'s chain."""
    per_keys = _key_buffers.setdefault(rlk, {})
    key = ("lift", tuple(m.value for m in ctx.moduli), ctx.device)
    if key not in per_keys:
        per_keys[key] = cuda_build.u32_buffer(_pack_lift(ctx, rlk.digit_groups(ctx.L)),
                                              ctx.device)
    return per_keys[key]


def _packed_keys(ctx, rlk, tables=None) -> torch.Tensor:
    """``rlk`` packed as u32 (k0, k0', k1, k1') per coefficient [D, L', n, 4],
    its rows covering the limbs of ``tables`` (default ``ctx.tables``)."""
    per_keys = _key_buffers.setdefault(rlk, {})
    key = ("keys", tuple(m.value for m in (tables or ctx.tables).moduli), ctx.device)
    if key not in per_keys:
        per_keys[key] = cuda_build.u32_buffer(
            torch.stack([rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup], -1), ctx.device)
    return per_keys[key]


def _base(tbx):
    """A base's six table pointers (``Base`` in behz.cu) as a host array."""
    b = ntt_cuda.table_buffers(tbx)
    return (ctypes.c_void_p * 6)(*(b[k].data_ptr() for k in
                                   ("q", "tw", "itw", "n_inv", "n_inv_s", "mu")))


def _logn(ctx, n) -> int:
    """log2 of the row length ``n`` (default ``ctx.n``): a coefficient-wise
    kernel also takes a slice of n / S coefficients of every limb (the C
    layout of ``parallel.ntt_dist``), at least 64 wide, a power of two."""
    n = ctx.n if n is None else n
    logn = n.bit_length() - 1
    if 1 << logn != n or not 6 <= logn <= 15:
        raise ValueError(f"rows of {n} outside the kernels' range: powers of two in "
                         f"[64, 32768]")
    return logn


def _validate(polys, ctx, n=None) -> int:
    """Every residue tensor: CUDA, int64, contiguous, 16-byte aligned,
    [..., L, n] of one shape on the context's device (n: ``ctx.n`` or the
    slice given). Returns the flattened batch B."""
    L, n = ctx.L, 1 << _logn(ctx, n)
    shape = polys[0].shape
    for x in polys:
        if not x.is_cuda:
            raise ValueError(f"the CUDA BEHZ kernels take CUDA tensors, got {x.device}")
        if x.device != ctx.device:
            raise ValueError(f"tensor on {x.device}, context on {ctx.device}")
        if x.dtype != torch.int64:
            raise TypeError(f"residues must be int64, got {x.dtype}")
        if x.dim() < 2 or x.shape[-2:] != (L, n) or x.shape != shape:
            raise ValueError(f"expected matching [..., {L}, {n}] tensors, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("residue tensor must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("residue tensor must start on a 16-byte boundary")
    return polys[0].numel() // (L * n)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _u32(*shape, device):
    return torch.empty(shape, dtype=torch.int32, device=device)


def _launch(lib, name: str, *args):
    cuda_build.check(getattr(lib, "pplp_" + name)(*args), lib, name)
    _count(name)


def _check_bounds(mul):
    L, K = mul.ctx.L, mul.K
    if L > MAX_L or K > MAX_K:
        raise ValueError(f"L = {L}, |B_sk| = {K} exceed the kernel's bounds "
                         f"({MAX_L}, {MAX_K})")


def to_bsk(c0, c1, d0, d1, mul, n=None) -> torch.Tensor:
    """Base extension of the four inputs [..., L, n] -> xb u32 [4, B, K, n]
    (``n``: a coefficient slice's width, default ``ctx.n``)."""
    ctx = mul.ctx
    B = _validate((c0, c1, d0, d1), ctx, n)
    logn = _logn(ctx, n)
    _check_bounds(mul)
    xb = _u32(4, B, mul.K, 1 << logn, device=c0.device)
    if B == 0:
        return xb
    lib = load()
    consts, scalars = _constants(mul)
    _launch(lib, "behz_to_bsk", c0.data_ptr(), c1.data_ptr(), d0.data_ptr(), d1.data_ptr(),
            xb.data_ptr(), consts.data_ptr(), scalars.ctypes.data,
            ntt_cuda.table_buffers(ctx.tables)["mu"].data_ptr(),
            ntt_cuda.table_buffers(mul.bsk_tables)["mu"].data_ptr(), B, ctx.L, mul.K,
            logn, _stream(c0.device))
    return xb


def _check_u32(x, shape, what):
    if (not x.is_cuda or x.dtype != torch.int32 or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous CUDA int32 {list(shape)} tensor, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def tensor_products(c0, c1, d0, d1, xb, mul) -> tuple[torch.Tensor, torch.Tensor]:
    """The coefficient-domain tensor products over Q and B_sk: (eq u32
    [3, B, L, n], eb u32 [3, B, K, n]). One ``behz_tensor_ntt`` launch for
    n <= FUSED_TENSOR_MAX_N, else the u32 transforms around ``tensor_spectra``."""
    ctx = mul.ctx
    B = _validate((c0, c1, d0, d1), ctx)
    _check_bounds(mul)
    L, K, n, logn = ctx.L, mul.K, ctx.n, ctx.tables.logn
    _check_u32(xb, (4, B, K, n), "xb")
    dev = c0.device
    eq, eb = _u32(3, B, L, n, device=dev), _u32(3, B, K, n, device=dev)
    if B == 0:
        return eq, eb
    tq, tb = ctx.tables, mul.bsk_tables
    if n <= FUSED_TENSOR_MAX_N:
        _launch(load(), "behz_tensor_ntt", c0.data_ptr(), c1.data_ptr(), d0.data_ptr(),
                d1.data_ptr(), xb.data_ptr(), eq.data_ptr(), eb.data_ptr(), _base(tq),
                _base(tb), B, L, K, logn, _stream(dev))
        return eq, eb
    fq = _u32(4, B, L, n, device=dev)
    for x, dst in zip((c0, c1, d0, d1), fq):
        ntt_cuda.forward_u32(x.reshape(B, L, n), tq, out=dst)
    for spec, dst, tbx in ((fq, eq, tq), (ntt_cuda.forward_u32(xb, tb), eb, tb)):
        ntt_cuda.inverse_u32(tensor_spectra(spec, tbx), tbx, out=dst)
    return eq, eb


def tensor_spectra(spec, tbx) -> torch.Tensor:
    """The Karatsuba tensor product of u32 spectra [4, B, Lx, n] (a0, a1,
    b0, b1) over one base's tables -> u32 [3, B, Lx, n] (``behz_tensor``)."""
    if spec.dim() != 4:
        raise ValueError(f"spectra must be [4, B, {tbx.L}, {tbx.n}], got {tuple(spec.shape)}")
    B = spec.shape[1]
    _check_u32(spec, (4, B, tbx.L, tbx.n), "spectra")
    if spec.device != tbx.device:
        raise ValueError(f"spectra on {spec.device}, tables on {tbx.device}")
    prod = _u32(3, B, tbx.L, tbx.n, device=spec.device)
    if B == 0:
        return prod
    b = ntt_cuda.table_buffers(tbx)
    _launch(load(), "behz_tensor", spec.data_ptr(), prod.data_ptr(), b["q"].data_ptr(),
            b["mu"].data_ptr(), B, tbx.L, tbx.logn, _stream(spec.device))
    return prod


def floor_sk(eq, eb, mul, n=None) -> torch.Tensor:
    """Fast floor + Shenoy-Kumaresan of the products -> int64 [3, B, L, n]
    (``n``: a coefficient slice's width, default ``ctx.n``)."""
    ctx = mul.ctx
    _check_bounds(mul)
    logn = _logn(ctx, n)
    L, K, n = ctx.L, mul.K, 1 << logn
    B = eq.shape[1]
    _check_u32(eq, (3, B, L, n), "eq")
    _check_u32(eb, (3, B, K, n), "eb")
    out = torch.empty((3, B, L, n), dtype=torch.int64, device=eq.device)
    if B == 0:
        return out
    lib = load()
    consts, scalars = _constants(mul)
    _launch(lib, "behz_floor_sk", eq.data_ptr(), eb.data_ptr(), out.data_ptr(),
            consts.data_ptr(), scalars.ctypes.data,
            ntt_cuda.table_buffers(ctx.tables)["mu"].data_ptr(),
            ntt_cuda.table_buffers(mul.bsk_tables)["mu"].data_ptr(), B, L, K,
            logn, _stream(eq.device))
    return out


def multiply(c0, c1, d0, d1, mul) -> torch.Tensor:
    """(c0, c1) x (d0, d1), each [..., L, n] on the card -> [3, ..., L, n]."""
    batch = tuple(c0.shape[:-2])
    xb = to_bsk(c0, c1, d0, d1, mul)
    eq, eb = tensor_products(c0, c1, d0, d1, xb, mul)
    return floor_sk(eq, eb, mul).reshape((3,) + batch + (mul.ctx.L, mul.ctx.n))


def _check_keys(ctx, rlk, L=None) -> int:
    """The keys' digit count D after checking their tensors: [D, L, n]
    (``L``: the key rows' limbs, default ``ctx.L``)."""
    L = ctx.L if L is None else L
    n, D = ctx.n, len(rlk.digit_groups(ctx.L))
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
    (c0, c1); each [..., L, n] on the card -> [2, ..., L, n]. One
    ``behz_relin_ntt`` launch for n <= FUSED_RELIN_MAX_N, else
    ``lift_digits``, the u32 transforms, ``key_products`` and ``add_switched``."""
    B = _validate((c0, c1, c2), ctx)
    D = _check_keys(ctx, rlk)
    L, n = ctx.L, ctx.n
    shape = (2,) + tuple(c0.shape[:-2]) + (L, n)
    if B == 0:
        return torch.empty(shape, dtype=torch.int64, device=c0.device)
    if n > FUSED_RELIN_MAX_N:
        dn = ntt_cuda.forward_u32(lift_digits(c2, ctx, rlk), ctx.tables)
        d = ntt_cuda.inverse_u32(key_products(dn, ctx, rlk), ctx.tables)
        return add_switched(c0, c1, d, ctx).reshape(shape)
    out = torch.empty(shape, dtype=torch.int64, device=c0.device)
    lift, keys = _lift_buffer(ctx, rlk), _packed_keys(ctx, rlk)
    _launch(load(), "behz_relin_ntt", c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            out.data_ptr(), lift.data_ptr(), keys.data_ptr(), _base(ctx.tables), B, L, D,
            ctx.tables.logn, _stream(c0.device))
    return out


def lift_digits(c2, ctx, rlk, n=None) -> torch.Tensor:
    """The gadget digits of c2 [..., L, n] (int64) lifted into every limb
    -> u32 [D, B, L, n] (``behz_lift``; ``n``: a coefficient slice's width,
    default ``ctx.n``). Reads ``rlk``'s digit groups only."""
    B = _validate((c2,), ctx, n)
    logn = _logn(ctx, n)
    D = len(rlk.digit_groups(ctx.L))
    dig = _u32(D, B, ctx.L, 1 << logn, device=c2.device)
    if B == 0:
        return dig
    _launch(load(), "behz_lift", c2.data_ptr(), dig.data_ptr(), _lift_buffer(ctx, rlk).data_ptr(),
            ntt_cuda.table_buffers(ctx.tables)["mu"].data_ptr(), B, ctx.L, D,
            logn, _stream(c2.device))
    return dig


def key_products(dn, ctx, rlk, tables=None) -> torch.Tensor:
    """sum_g dn[g] * (k0[g], k1[g]) mod q of the digit spectra dn u32
    [D, B, L, n] -> u32 [2, B, L, n] (``behz_keyprod``). ``tables``: the
    limbs dn and the keys' rows cover (``ntt.NttTables.limbs`` of
    ``ctx.tables``, the R layout of ``parallel.ntt_dist``); default all."""
    tables = ctx.tables if tables is None else tables
    L = tables.L
    D = _check_keys(ctx, rlk, L)
    if dn.dim() != 4:
        raise ValueError(f"digit spectra must be [{D}, B, {L}, {ctx.n}]")
    B = dn.shape[1]
    _check_u32(dn, (D, B, L, ctx.n), "digit spectra")
    acc = _u32(2, B, L, ctx.n, device=dn.device)
    if B == 0:
        return acc
    _launch(load(), "behz_keyprod", dn.data_ptr(), _packed_keys(ctx, rlk, tables).data_ptr(),
            acc.data_ptr(),
            ntt_cuda.table_buffers(tables)["q"].data_ptr(), B, L, D, ctx.tables.logn,
            _stream(dn.device))
    return acc


def add_switched(c0, c1, d, ctx, n=None) -> torch.Tensor:
    """(c0 + d[0], c1 + d[1]) mod q: c0, c1 int64 [..., L, n], d u32
    [2, B, L, n] -> int64 [2, B, L, n] (``behz_add``; ``n``: a coefficient
    slice's width, default ``ctx.n``)."""
    B = _validate((c0, c1), ctx, n)
    logn = _logn(ctx, n)
    n = 1 << logn
    _check_u32(d, (2, B, ctx.L, n), "d")
    out = torch.empty((2, B, ctx.L, n), dtype=torch.int64, device=c0.device)
    if B == 0:
        return out
    _launch(load(), "behz_add", c0.data_ptr(), c1.data_ptr(), d.data_ptr(), out.data_ptr(),
            ntt_cuda.table_buffers(ctx.tables)["q"].data_ptr(), B, ctx.L, logn,
            _stream(c0.device))
    return out
