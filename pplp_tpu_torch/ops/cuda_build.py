"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, under
``pplp_tpu_torch/_build/``. The library name carries a hash of the source,
the shared headers beside it (``csrc/*.cuh``) and the flags, so a changed
source or header rebuilds. ``build`` starts one ``nvcc``
per source that is not built yet, all at once, and waits for all of them.
Libraries are loaded with ``ctypes``; the wrappers (``ntt_cuda``,
``behz_cuda``, ``mulmod_chain``) declare their entry points' argtypes.

Every library exports ``pplp_cuda_error_string(int)``; each entry point
returns ``cudaGetLastError()`` after its launch and ``check`` raises on a
non-zero code.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load",
           "check", "u32_buffer", "raw_stream", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -split-compile=0: cicc optimizes the device code in parallel on every
# core (dgk_mont.cu's 20 kernels: 60 s of which cicc 54, 15 s split, on the
# 8-core H100 host).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile=0",
)

# Per source file name: seconds nvcc took (0.0 if already built), its
# ptxas report and the nvcc used.
build_info: dict[str, dict] = {}
# The loaded libraries by (source, build_dir) as the wrappers pass them
# (module constants): a launch looks its library up without making two new
# Paths.
_libs: dict[tuple, ctypes.CDLL] = {}


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
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built"
    )


def _lib_path(source: Path, build_dir: Path) -> Path:
    h = hashlib.sha256()
    h.update(source.name.encode())
    h.update(source.read_bytes())
    for header in sorted(Path(source).parent.glob("*.cuh")):  # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return Path(build_dir) / f"libpplp_{source.stem}_{h.hexdigest()[:16]}.so"


def build(sources, build_dir=None) -> dict[Path, Path]:
    """Compile every source whose library is missing, in parallel.

    Returns {source: library path}. Raises if nvcc is missing or any
    compile fails (after all of them have ended)."""
    build_dir = Path(build_dir or BUILD_DIR)
    sources = [Path(s) for s in sources]
    paths = {s: _lib_path(s, build_dir) for s in sources}
    todo = [s for s in sources if not paths[s].exists()]
    for s in sources:
        if s not in todo:
            build_info.setdefault(s.name, {"seconds": 0.0, "log": ""})
    if not todo:
        return paths
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = []
    for s in todo:
        tmp = paths[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((s, tmp, proc))
    failures = []
    for s, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{s.name}: nvcc failed ({proc.returncode}):\n{out}\n{err}")
            continue
        os.replace(tmp, paths[s])
        build_info[s.name] = {"seconds": time.perf_counter() - t0,
                              "log": out + err, "nvcc": nvcc}
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(source, declare, build_dir=None) -> ctypes.CDLL:
    """The library of ``source`` (built if needed); ``declare(lib)`` sets
    its entry points' argtypes on first load."""
    lib = _libs.get((source, build_dir))
    if lib is None:
        src = Path(source)
        lib = ctypes.CDLL(str(build([src], Path(build_dir or BUILD_DIR))[src]))
        lib.pplp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pplp_cuda_error_string.restype = ctypes.c_char_p
        declare(lib)
        _libs[(source, build_dir)] = lib
    return lib


def u32_buffer(values, device) -> torch.Tensor:
    """Integers in [0, 2^32) (a tensor or anything numpy takes) -> a
    contiguous int32 tensor on ``device`` holding the same 32 bits, which a
    kernel reads as uint32."""
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    host = np.asarray(values, dtype=np.int64).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def raw_stream(device_index: int) -> int:
    """The raw handle of the current stream of CUDA device ``device_index``.
    It reads PyTorch's private binding ``torch._C._cuda_getCurrentRawStream``
    (the launch path of PyTorch's own generated kernels), a few microseconds
    a call less than ``torch.cuda.current_stream(device).cuda_stream``; a
    PyTorch without it raises here."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        raise RuntimeError("this PyTorch has no torch._C._cuda_getCurrentRawStream; the "
                           "kernels' launches need the current stream's handle")
    return raw(device_index)


def check(code: int, lib, what: str):
    """Raise if an entry point returned a CUDA error."""
    if code != 0:
        msg = lib.pplp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
