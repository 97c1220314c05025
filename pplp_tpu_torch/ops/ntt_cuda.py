"""Load and launch the Hopper NTT kernels (``csrc/ntt.cu``).

On an m31 table the u32 kernel, which replaces the Pallas kernel
``pplp_tpu/ops/ntt_vmem.py::_kernel``; on an m62 table the u64 kernel, which
replaces no TPU kernel (the reference runs m62 through the XLA stage engine,
``pplp_tpu/ops/ntt.py:205-267``). The kernels are built by ``cuda_build``
(nvcc for ``sm_90a``, a plain C interface, ctypes) at first use; pointers
come from ``data_ptr()`` and the stream from PyTorch's current stream.

What bounds the kernel on an H100: device-memory bytes at batch scale (an
int64 read and write per element per transform, plus twiddle reads). Making
it fast is later work: u32 storage end to end, twiddles fused into the
epilogue, several rows per block.

``launches`` counts kernel launches (both directions, both profiles);
``launches_by_kernel`` splits them by name (``ntt_forward``, ``ntt_inverse``,
``ntt_forward_u64``, ``ntt_inverse_u64``). Each wrapper adds one where it
launches and nowhere else; a u64 transform at n = 32768 is one count for
its two launches (stage 0 or the last stage runs as a global pass).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

__all__ = ["load", "forward", "inverse", "launches", "launches_by_kernel",
           "reset_launches"]

SOURCE = cuda_build.CSRC / "ntt.cu"

launches = 0
launches_by_kernel = {"ntt_forward": 0, "ntt_inverse": 0,
                      "ntt_forward_u64": 0, "ntt_inverse_u64": 0}


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
    lib.pplp_ntt_forward.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pplp_ntt_forward.restype = ci
    lib.pplp_ntt_inverse.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.pplp_ntt_inverse.restype = ci
    lib.pplp_ntt_forward_u64.argtypes = lib.pplp_ntt_forward.argtypes
    lib.pplp_ntt_forward_u64.restype = ci
    lib.pplp_ntt_inverse_u64.argtypes = lib.pplp_ntt_inverse.argtypes
    lib.pplp_ntt_inverse_u64.restype = ci


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def table_buffers(tb) -> dict:
    """The tables the kernel reads: u32 copies cached on ``tb`` (m31), or
    the int64 tables themselves, read as u64 (m62)."""
    if tb.profile == "m62":
        return {name: getattr(tb, name)
                for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s")}
    bufs = tb.kernel_buffers
    if not bufs:
        for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s"):
            bufs[name] = cuda_build.u32_buffer(getattr(tb, name), tb.device)
    return bufs


def _validate(x: torch.Tensor, tb):
    if not x.is_cuda:
        raise ValueError(f"the CUDA NTT takes CUDA tensors, got {x.device}")
    if tb.device != x.device:
        raise ValueError(f"tensor on {x.device}, tables on {tb.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2:] != (tb.L, tb.n):
        raise ValueError(f"expected [..., {tb.L}, {tb.n}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("residue tensor must be contiguous")
    if not 6 <= tb.logn <= 15:
        raise ValueError(f"n = {tb.n} outside the kernel's range [64, 32768]")
    rows = x.numel() // tb.n
    if rows >= 1 << 30:
        raise ValueError(f"{rows} rows exceed the grid limit")
    return rows


def forward(x: torch.Tensor, tb) -> torch.Tensor:
    """Negacyclic NTT of CUDA int64 residues [..., L, n] (bit-reversed out),
    canonical in and out."""
    rows = _validate(x, tb)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load()
    b = table_buffers(tb)
    name = "ntt_forward_u64" if tb.profile == "m62" else "ntt_forward"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, "pplp_" + name)(
        x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["w"].data_ptr(),
        b["ws"].data_ptr(), rows, tb.L, tb.logn, stream,
    )
    cuda_build.check(code, lib, name)
    _count(name)
    return out


def inverse(x: torch.Tensor, tb) -> torch.Tensor:
    """Inverse negacyclic NTT of CUDA int64 spectra [..., L, n]."""
    rows = _validate(x, tb)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load()
    b = table_buffers(tb)
    name = "ntt_inverse_u64" if tb.profile == "m62" else "ntt_inverse"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, "pplp_" + name)(
        x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["iw"].data_ptr(),
        b["iws"].data_ptr(), b["n_inv"].data_ptr(), b["n_inv_s"].data_ptr(),
        rows, tb.L, tb.logn, stream,
    )
    cuda_build.check(code, lib, name)
    _count(name)
    return out
