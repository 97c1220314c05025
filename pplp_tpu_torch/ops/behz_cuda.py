"""Load and launch the Hopper BEHZ multiply + relinearization (``csrc/behz.cu``).

Replaces the Pallas kernel ``pplp_tpu/bfv/behz_fused.py::_kernel``. One
``multiply`` call launches, on the current stream, the per-coefficient base
extension, the forward NTTs (``ntt_cuda``), the Karatsuba tensor product in
both bases, the inverse NTTs and the fast floor + Shenoy-Kumaresan step;
``relinearize`` launches the digit lift, the forward NTTs, the key products,
the inverse NTTs and the final add. Intermediates live in device memory
(int64 residues, [component, batch, limb, n]); see the source's header for
the design and its bounds (L <= 40, |B_sk| <= 48).

The plain version is ``bfv.behz`` (``RnsMultiplier.multiply``,
``relinearize``); ``bfv.behz_fused.FusedMultiplier`` dispatches between the
two by device. These wrappers take CUDA tensors only and raise on anything
else; a launch error raises.

``launches`` counts kernel launches of ``behz.cu`` (the NTT launches are
counted by ``ntt_cuda``); ``launches_by_kernel`` splits them. The packed
constant buffers are cached here, keyed by the multiplier and keys objects
they were packed from.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import cuda_build, ntt_cuda
from .modmath import shoup_ints

__all__ = ["multiply", "relinearize", "launches", "launches_by_kernel",
           "reset_launches", "MAX_L", "MAX_K"]

SOURCE = cuda_build.CSRC / "behz.cu"
MAX_L = 40
MAX_K = 48
_NO_LIMB = 0xFFFFFFFF

launches = 0
launches_by_kernel = {"behz_to_bsk": 0, "behz_tensor": 0, "behz_floor_sk": 0,
                      "behz_lift": 0, "behz_keyprod": 0, "behz_add": 0}

# multiplier -> (device constants, host scalars); keys -> {(moduli, device): lift buffer}
_mul_buffers: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_lift_buffers: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


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
    lib.pplp_behz_to_bsk.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pplp_behz_tensor.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pplp_behz_floor_sk.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pplp_behz_lift.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pplp_behz_keyprod.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pplp_behz_add.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    for name in ("to_bsk", "tensor", "floor_sk", "lift", "keyprod", "add"):
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
    per_keys = _lift_buffers.setdefault(rlk, {})
    key = (tuple(m.value for m in ctx.moduli), ctx.device)
    buf = per_keys.get(key)
    if buf is None:
        buf = per_keys[key] = cuda_build.u32_buffer(
            _pack_lift(ctx, rlk.digit_groups(ctx.L)), ctx.device)
    return buf


def _validate(polys, ctx) -> int:
    """Every residue tensor: CUDA, int64, contiguous, [..., L, n] of one
    shape on the context's device. Returns the flattened batch B."""
    L, n = ctx.L, ctx.n
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
    if not 6 <= ctx.tables.logn <= 15:
        raise ValueError(f"n = {n} outside the kernels' range [64, 32768]")
    return polys[0].numel() // (L * n)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def multiply(c0, c1, d0, d1, mul) -> torch.Tensor:
    """(c0, c1) x (d0, d1), each [..., L, n] on the card -> [3, ..., L, n]."""
    ctx = mul.ctx
    B = _validate((c0, c1, d0, d1), ctx)
    L, K, n, logn = ctx.L, mul.K, ctx.n, ctx.tables.logn
    if L > MAX_L or K > MAX_K:
        raise ValueError(f"L = {L}, |B_sk| = {K} exceed the kernel's bounds "
                         f"({MAX_L}, {MAX_K})")
    batch = tuple(c0.shape[:-2])
    out = torch.empty((3,) + batch + (L, n), dtype=torch.int64, device=c0.device)
    if B == 0:
        return out
    lib = load()
    consts, scalars = _constants(mul)
    cst, sc = consts.data_ptr(), scalars.ctypes.data
    stream = _stream(c0.device)
    tq, tb = ctx.tables, mul.bsk_tables

    xb = torch.empty((4, B, K, n), dtype=torch.int64, device=c0.device)
    code = lib.pplp_behz_to_bsk(c0.data_ptr(), c1.data_ptr(), d0.data_ptr(),
                                d1.data_ptr(), xb.data_ptr(), cst, sc, B, L, K, logn,
                                stream)
    cuda_build.check(code, lib, "behz_to_bsk")
    _count("behz_to_bsk")

    fq = [ntt_cuda.forward(x, tq) for x in (c0, c1, d0, d1)]
    fb = ntt_cuda.forward(xb, tb)
    eq = torch.empty((3, B, L, n), dtype=torch.int64, device=c0.device)
    eb = torch.empty((3, B, K, n), dtype=torch.int64, device=c0.device)
    for spec, dst, tbx in ((fq, eq, tq), (fb.unbind(0), eb, tb)):
        code = lib.pplp_behz_tensor(*(s.data_ptr() for s in spec), dst.data_ptr(),
                                    ntt_cuda.table_buffers(tbx)["q"].data_ptr(), B,
                                    tbx.L, logn, stream)
        cuda_build.check(code, lib, "behz_tensor")
        _count("behz_tensor")
    iq = ntt_cuda.inverse(eq, tq)
    ib = ntt_cuda.inverse(eb, tb)
    code = lib.pplp_behz_floor_sk(iq.data_ptr(), ib.data_ptr(), out.data_ptr(), cst, sc,
                                  B, L, K, logn, stream)
    cuda_build.check(code, lib, "behz_floor_sk")
    _count("behz_floor_sk")
    return out


def relinearize(c0, c1, c2, ctx, rlk) -> torch.Tensor:
    """Key-switch c2 with ``rlk`` (width-1 or width-2 digits) and add to
    (c0, c1); each [..., L, n] on the card -> [2, ..., L, n]."""
    B = _validate((c0, c1, c2), ctx)
    groups = rlk.digit_groups(ctx.L)
    L, n, logn, D = ctx.L, ctx.n, ctx.tables.logn, len(groups)
    if L > MAX_L:
        raise ValueError(f"L = {L} exceeds the kernel's bound {MAX_L}")
    keys = (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)
    for k in keys:
        if (k.device != ctx.device or k.dtype != torch.int64
                or k.shape != (D, L, n) or not k.is_contiguous()):
            raise ValueError(f"relin keys must be contiguous int64 [{D}, {L}, {n}] on "
                             f"{ctx.device}, got {k.dtype} {tuple(k.shape)} on {k.device}")
    batch = tuple(c0.shape[:-2])
    out = torch.empty((2,) + batch + (L, n), dtype=torch.int64, device=c0.device)
    if B == 0:
        return out
    lib = load()
    stream = _stream(c0.device)
    qbuf = ntt_cuda.table_buffers(ctx.tables)["q"]

    dig = torch.empty((D, B, L, n), dtype=torch.int64, device=c0.device)
    code = lib.pplp_behz_lift(c2.data_ptr(), dig.data_ptr(), _lift_buffer(ctx, rlk).data_ptr(),
                              B, L, D, logn, stream)
    cuda_build.check(code, lib, "behz_lift")
    _count("behz_lift")
    dn = ntt_cuda.forward(dig, ctx.tables)
    acc = torch.empty((2, B, L, n), dtype=torch.int64, device=c0.device)
    code = lib.pplp_behz_keyprod(dn.data_ptr(), *(k.data_ptr() for k in keys), acc.data_ptr(),
                                 qbuf.data_ptr(), B, L, D, logn, stream)
    cuda_build.check(code, lib, "behz_keyprod")
    _count("behz_keyprod")
    d = ntt_cuda.inverse(acc, ctx.tables)
    code = lib.pplp_behz_add(c0.data_ptr(), c1.data_ptr(), d.data_ptr(), out.data_ptr(),
                             qbuf.data_ptr(), B, L, logn, stream)
    cuda_build.check(code, lib, "behz_add")
    _count("behz_add")
    return out
