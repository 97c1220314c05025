"""Load and launch the Hopper NTT kernels (``csrc/ntt.cu``).

On an m31 table the u32 kernels, which replace the Pallas kernel
``pplp_tpu/ops/ntt_vmem.py::_kernel``; on an m62 table the u64 kernel, which
replaces no TPU kernel (the reference runs m62 through the XLA stage engine,
``pplp_tpu/ops/ntt.py:205-267``). The kernels are built by ``cuda_build``
(nvcc for ``sm_90a``, a plain C interface, ctypes) at first use; pointers
come from ``data_ptr()`` and the stream from PyTorch's current stream.

The u32 kernels run the in-block transform of ``csrc/ntt_block.cuh``:
register-radix rounds of 4 stages with one shared-memory exchange each,
twiddles as interleaved (w, w_shoup) pairs (``table_buffers`` packs them),
16-byte row I/O. ``forward``/``inverse`` take and give int64 residues
(narrowed on load, widened on store); ``forward_u32``/``inverse_u32`` give
u32 rows (int32 tensors holding the same 32 bits) for the multiply's
intermediates (``behz_cuda``).

``launches`` counts kernel launches (both directions, both profiles);
``launches_by_kernel`` splits them by name and I/O width (``ntt_forward``,
``ntt_inverse``: int64 in and out; ``ntt_forward_u32``, ``ntt_inverse_u32``:
u32 out; ``ntt_forward_u64``, ``ntt_inverse_u64``). Each wrapper adds one
where it launches and nowhere else; a u64 transform at n = 32768 is one
count for its two launches (stage 0 or the last stage runs as a global
pass).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

__all__ = ["load", "forward", "inverse", "forward_u32", "inverse_u32", "launches",
           "launches_by_kernel", "reset_launches", "table_buffers"]

SOURCE = cuda_build.CSRC / "ntt.cu"

launches = 0
launches_by_kernel = {"ntt_forward": 0, "ntt_inverse": 0, "ntt_forward_u32": 0,
                      "ntt_inverse_u32": 0, "ntt_forward_u64": 0, "ntt_inverse_u64": 0}


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
    lib.pplp_ntt_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.pplp_ntt_inverse.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.pplp_ntt_forward_u64.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pplp_ntt_inverse_u64.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    for name in ("forward", "inverse", "forward_u64", "inverse_u64"):
        getattr(lib, f"pplp_ntt_{name}").restype = ci


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def table_buffers(tb) -> dict:
    """The tables the kernels read. m31: u32 copies cached on ``tb`` (q, the
    n^-1 pair, the interleaved (w, w_shoup) / (iw, iw_shoup) tables ``tw`` /
    ``itw`` [L, n, 2], and ``mu`` = floor(2^64 / q) as int64 for the BEHZ
    kernels' Barrett reductions); m62: the int64 tables themselves, read as
    u64."""
    if tb.profile == "m62":
        return {name: getattr(tb, name)
                for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s")}
    bufs = tb.kernel_buffers
    if not bufs:
        for name in ("q", "n_inv", "n_inv_s"):
            bufs[name] = cuda_build.u32_buffer(getattr(tb, name), tb.device)
        bufs["tw"] = cuda_build.u32_buffer(torch.stack([tb.w, tb.ws], -1), tb.device)
        bufs["itw"] = cuda_build.u32_buffer(torch.stack([tb.iw, tb.iws], -1), tb.device)
        bufs["mu"] = torch.tensor([(1 << 64) // m.value for m in tb.moduli],
                                  dtype=torch.int64, device=tb.device)
    return bufs


def _validate(x: torch.Tensor, tb, dtypes=(torch.int64,)):
    if not x.is_cuda:
        raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
    if tb.device != x.device:
        raise ValueError(f"tensor on {x.device}, tables on {tb.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"residues must be {' or '.join(map(str, dtypes))}, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2:] != (tb.L, tb.n):
        raise ValueError(f"expected [..., {tb.L}, {tb.n}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("residue tensor must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("residue tensor must start on a 16-byte boundary")
    if not 6 <= tb.logn <= 15:
        raise ValueError(f"n = {tb.n} outside the kernel's range [64, 32768]")
    rows = x.numel() // tb.n
    if rows >= 1 << 30:
        raise ValueError(f"{rows} rows exceed the grid limit")
    return rows


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _u32_out(x, tb, out):
    """A u32 (int32) result tensor shaped like ``x``: ``out`` if given."""
    if out is None:
        return torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if out.dtype != torch.int32 or out.shape != x.shape or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous int32 {tuple(x.shape)} tensor")
    if out.device != x.device or out.data_ptr() % 16:
        raise ValueError("out must be on the input's device, 16-byte aligned")
    return out


def _m31(x, tb, out_u32, out, inverse):
    """Launch the u32 kernel of one direction; x int64 or u32 (int32)."""
    rows = _validate(x, tb, (torch.int64, torch.int32) if out_u32 else (torch.int64,))
    y = _u32_out(x, tb, out) if out_u32 else torch.empty_like(x)
    if rows == 0:
        return y
    if tb.profile != "m31":
        raise ValueError("u32 transforms take an m31 table")
    lib = load()
    b = table_buffers(tb)
    in_u32 = int(x.dtype == torch.int32)
    if inverse:
        name = "ntt_inverse_u32" if out_u32 else "ntt_inverse"
        code = lib.pplp_ntt_inverse(
            x.data_ptr(), y.data_ptr(), b["q"].data_ptr(), b["itw"].data_ptr(),
            b["n_inv"].data_ptr(), b["n_inv_s"].data_ptr(), rows, tb.L, tb.logn, in_u32,
            int(out_u32), _stream(x))
    else:
        name = "ntt_forward_u32" if out_u32 else "ntt_forward"
        code = lib.pplp_ntt_forward(
            x.data_ptr(), y.data_ptr(), b["q"].data_ptr(), b["tw"].data_ptr(), rows, tb.L,
            tb.logn, in_u32, int(out_u32), _stream(x))
    cuda_build.check(code, lib, name)
    _count(name)
    return y


def _m62(x, tb, inverse):
    rows = _validate(x, tb)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load()
    b = table_buffers(tb)
    if inverse:
        name = "ntt_inverse_u64"
        code = lib.pplp_ntt_inverse_u64(
            x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["iw"].data_ptr(),
            b["iws"].data_ptr(), b["n_inv"].data_ptr(), b["n_inv_s"].data_ptr(),
            rows, tb.L, tb.logn, _stream(x))
    else:
        name = "ntt_forward_u64"
        code = lib.pplp_ntt_forward_u64(
            x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["w"].data_ptr(),
            b["ws"].data_ptr(), rows, tb.L, tb.logn, _stream(x))
    cuda_build.check(code, lib, name)
    _count(name)
    return out


def forward(x: torch.Tensor, tb) -> torch.Tensor:
    """Negacyclic NTT of CUDA int64 residues [..., L, n] (bit-reversed out),
    canonical in and out."""
    if tb.profile == "m62":
        return _m62(x, tb, inverse=False)
    return _m31(x, tb, False, None, inverse=False)


def inverse(x: torch.Tensor, tb) -> torch.Tensor:
    """Inverse negacyclic NTT of CUDA int64 spectra [..., L, n]."""
    if tb.profile == "m62":
        return _m62(x, tb, inverse=True)
    return _m31(x, tb, False, None, inverse=True)


def forward_u32(x: torch.Tensor, tb, out: torch.Tensor | None = None) -> torch.Tensor:
    """m31 forward NTT of CUDA residues [..., L, n], int64 or u32 (int32
    bits), into u32 (int32 bits; ``out`` if given)."""
    return _m31(x, tb, True, out, inverse=False)


def inverse_u32(x: torch.Tensor, tb, out: torch.Tensor | None = None) -> torch.Tensor:
    """m31 inverse NTT of CUDA u32 spectra (int32 bits) into u32."""
    if x.dtype != torch.int32:
        raise TypeError(f"inverse_u32 takes u32 (int32) spectra, got {x.dtype}")
    return _m31(x, tb, True, out, inverse=True)
