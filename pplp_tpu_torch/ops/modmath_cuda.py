"""Load and launch the m62 profile's elementwise kernels (``csrc/modmath64.cu``).

They replace no Pallas kernel: the reference runs the m62 arithmetic as XLA
on (lo, hi) u32 pairs. ``ops.modmath.m62`` sends each op that the port
calls on card residues here when they lie on the card: ``add``, ``sub``,
``neg``, ``mulmod_shoup``, ``mulmod``, ``reduce_words`` / ``reduce128`` and
``shoup_precompute``, each one launch of its kernel (``OPS``: the kernel
and its operands). On the CPU it runs the plain chain
(``modmath.m62_plain``), the model the card tests hold these kernels to.

``launch(op, *operands)`` takes CUDA int64 tensors and Python ints (an int
is passed as an immediate), broadcast as PyTorch broadcasts them, and
returns a new contiguous int64 tensor of the broadcast shape on the current
stream, without synchronizing. An operand is read where it lies, through
its strides (0 on a broadcast dimension): no expanded copy. The layout of
a set of operand shapes and strides is worked out once and cached
(``_layout``), so a launch costs a dictionary lookup, ``torch.empty`` and
one ctypes call. ``launches_by_kernel`` counts the launches by kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

__all__ = ["OPS", "launch", "launches_by_kernel", "reset_launches", "load"]

SOURCE = cuda_build.CSRC / "modmath64.cu"

# op: (kernel, operands), in csrc/modmath64.cu's op-code order.
OPS = {
    "add": ("m62_add", ("x", "y", "q")),
    "sub": ("m62_sub", ("x", "y", "q")),
    "neg": ("m62_neg", ("x", "q")),
    "mulmod_shoup": ("m62_shoup", ("x", "w", "w_shoup", "q")),
    "mulmod": ("m62_mulmod", ("x", "y", "q", "r0", "r1", "r2")),
    "reduce128": ("m62_reduce128", ("z0", "z1", "z2", "z3", "q", "r0", "r1", "r2")),
    "shoup_precompute": ("m62_shoup_pre", ("w", "q", "r0", "r1", "r2")),
}
_CODES = {op: (code, kernel, len(operands))
          for code, (op, (kernel, operands)) in enumerate(OPS.items())}
MAX_OPERANDS = 8
MAX_DIMS = 6  # csrc/modmath64.cu's kMaxDims, after merging dimensions
MAX_NUMEL = (1 << 32) - 132 * 16 * 256  # its kMaxNumel: the index is 32-bit

launches_by_kernel = {kernel: 0 for kernel, _ in OPS.values()}

# (op, each operand's (shape, strides) or int) -> the layout csrc/modmath64.cu
# reads: (output shape, ctypes int64 array), or (shape, None) for no residue.
_layouts: dict = {}
_MAX_LAYOUTS = 4096


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _declare(lib):
    vp = ctypes.c_void_p
    lib.pplp_m62_elementwise.argtypes = [ctypes.c_int] + [vp] * (MAX_OPERANDS + 3)
    lib.pplp_m62_elementwise.restype = ctypes.c_int


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def _layout(operands) -> tuple:
    """The output shape and the kernel's layout array for operands (tensors
    and ints): the broadcast shape with its size-1 dimensions dropped and
    the dimensions every operand walks alike merged, each operand's strides
    over it (0 where it broadcasts) and its immediate."""
    shapes = [tuple(a.shape) if torch.is_tensor(a) else () for a in operands]
    ndim = max(len(s) for s in shapes)
    out = [1] * ndim
    for s in shapes:
        for i, size in enumerate(s, ndim - len(s)):
            if size != 1:
                if out[i] not in (1, size):
                    raise ValueError(f"operand shapes {shapes} do not broadcast")
                out[i] = size
    keep = [i for i in range(ndim) if out[i] != 1]
    strides = []
    for a, s in zip(operands, shapes):
        if not torch.is_tensor(a):
            strides.append([0] * len(keep))
            continue
        full = [0] * (ndim - len(s)) + [st if size != 1 else 0
                                        for size, st in zip(s, a.stride())]
        strides.append([full[i] for i in keep])
    dims = [out[i] for i in keep] or [1]
    strides = [st or [0] for st in strides]
    d = len(dims) - 1
    while d > 0:  # merge dimension d - 1 into d where every operand allows it
        if all(st[d - 1] == st[d] * dims[d] for st in strides):
            dims[d - 1:d + 1] = [dims[d - 1] * dims[d]]
            for st in strides:
                st[d - 1:d + 1] = [st[d]]
        d -= 1
    if len(dims) > MAX_DIMS:
        raise ValueError(f"operands span {len(dims)} dimensions after merging; the kernels "
                         f"take {MAX_DIMS}")
    numel = 1
    for size in dims:
        numel *= size
    if numel >= MAX_NUMEL:
        raise ValueError(f"{numel} residues; the kernels take fewer than {MAX_NUMEL}")
    words = [numel, len(dims), *dims]
    for a, st in zip(operands, strides):
        imm = 0 if torch.is_tensor(a) else int(a)
        if not -(1 << 63) <= imm < 1 << 64:
            raise ValueError(f"an immediate operand {imm} is not a 64-bit pattern")
        words += [imm - (1 << 64) if imm >= 1 << 63 else imm, *st]
    out_shape = tuple(out)
    if 0 in out_shape:
        return out_shape, None
    return out_shape, (ctypes.c_int64 * len(words))(*words)


def launch(op: str, *operands) -> torch.Tensor:
    """One launch of ``op``'s kernel (``OPS``) on CUDA int64 tensors and
    Python ints in the op's operand order -> a new int64 tensor of their
    broadcast shape."""
    code, kernel, count = _CODES[op]
    if len(operands) != count:
        raise TypeError(f"{op} takes {count} operands, got {len(operands)}")
    card, key = None, [code]
    for a in operands:
        if torch.is_tensor(a):
            if a.dtype is not torch.int64:
                raise TypeError(f"m62 residues must be int64, got {a.dtype}")
            index = a.get_device()
            if card is None:
                card = index
            if index < 0 or index != card:
                raise ValueError(f"{op}: operands on {a.device} and cuda:{card}; the kernels "
                                 f"take CUDA tensors of one device")
            key.append((a.shape, a.stride()))
        else:
            key.append(int(a))
    if card is None:
        raise ValueError(f"{op}: no operand is a CUDA tensor")
    key = tuple(key)
    found = _layouts.get(key)
    if found is None:
        if len(_layouts) >= _MAX_LAYOUTS:
            _layouts.clear()
        found = _layouts[key] = _layout(operands)
    shape, layout = found
    out = torch.empty(shape, dtype=torch.int64, device=torch.device("cuda", card))
    if layout is None:
        return out
    ptrs = [a.data_ptr() if torch.is_tensor(a) else None for a in operands]
    lib = load()
    rc = lib.pplp_m62_elementwise(code, out.data_ptr(), *ptrs,
                                  *(None,) * (MAX_OPERANDS - count), layout,
                                  cuda_build.raw_stream(card))
    cuda_build.check(rc, lib, kernel)
    launches_by_kernel[kernel] += 1
    return out
