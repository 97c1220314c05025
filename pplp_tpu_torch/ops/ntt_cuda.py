"""Build, load and launch the Hopper NTT kernel (``csrc/ntt.cu``).

Replaces the Pallas kernel ``pplp_tpu/ops/ntt_vmem.py::_kernel``. The kernel
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, under ``pplp_tpu_torch/_build/``; the library name
carries a hash of the sources and flags, so a changed source rebuilds. It is
loaded with ``ctypes``; pointers come from ``data_ptr()`` and the stream from
PyTorch's current stream.

What bounds the kernel on an H100: device-memory bytes at batch scale (an
int64 read and write per element per transform, plus twiddle reads). Making
it fast is later work: u32 storage end to end, twiddles fused into the
epilogue, several rows per block.

``launches`` counts kernel launches (both directions); ``launches_by_kernel``
splits them. Each wrapper adds one where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build", "load", "forward", "inverse", "launches",
           "launches_by_kernel", "reset_launches"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "ntt.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = 0
launches_by_kernel = {"ntt_forward": 0, "ntt_inverse": 0}

_lib = None
build_info: dict = {}


def reset_launches():
    global launches
    launches = 0
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _count(name: str):
    global launches
    launches += 1
    launches_by_kernel[name] += 1


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then PyTorch's CUDA home."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME:
        cands.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA NTT "
        "kernel cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path.

    Raises if nvcc is missing or the compile fails. ``build_info`` records
    the seconds taken and nvcc's ptxas report."""
    lib_path = BUILD_DIR / f"libpplp_ntt_{_source_hash()}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib_path)
    build_info.update(
        seconds=time.perf_counter() - t0, log=res.stdout + res.stderr,
        nvcc=nvcc,
    )
    return lib_path


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pplp_ntt_forward.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.pplp_ntt_forward.restype = ci
        lib.pplp_ntt_inverse.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.pplp_ntt_inverse.restype = ci
        lib.pplp_cuda_error_string.argtypes = [ci]
        lib.pplp_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _u32_buffer(t: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> a contiguous int32 tensor with the same bits."""
    host = t.detach().cpu().numpy().astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(host)).to(t.device)


def _buffers(tb) -> dict:
    bufs = tb.kernel_buffers
    if not bufs:
        for name in ("q", "w", "ws", "iw", "iws", "n_inv", "n_inv_s"):
            bufs[name] = _u32_buffer(getattr(tb, name))
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
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed the grid limit")
    return rows


def _raise_on(code: int, lib, what: str):
    if code != 0:
        msg = lib.pplp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def forward(x: torch.Tensor, tb) -> torch.Tensor:
    """Negacyclic NTT of CUDA int64 residues [..., L, n] (bit-reversed out)."""
    rows = _validate(x, tb)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load()
    b = _buffers(tb)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.pplp_ntt_forward(
        x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["w"].data_ptr(),
        b["ws"].data_ptr(), rows, tb.L, tb.logn, stream,
    )
    _raise_on(code, lib, "ntt_forward")
    _count("ntt_forward")
    return out


def inverse(x: torch.Tensor, tb) -> torch.Tensor:
    """Inverse negacyclic NTT of CUDA int64 spectra [..., L, n]."""
    rows = _validate(x, tb)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = load()
    b = _buffers(tb)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.pplp_ntt_inverse(
        x.data_ptr(), out.data_ptr(), b["q"].data_ptr(), b["iw"].data_ptr(),
        b["iws"].data_ptr(), b["n_inv"].data_ptr(), b["n_inv_s"].data_ptr(),
        rows, tb.L, tb.logn, stream,
    )
    _raise_on(code, lib, "ntt_inverse")
    _count("ntt_inverse")
    return out
