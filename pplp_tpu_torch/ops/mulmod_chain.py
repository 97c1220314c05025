"""Chained Shoup mulmods: the port's integer-throughput probe.

Counterpart of ``scripts/gated_profile.py::build_prim``: ``steps`` chained
m31 Shoup products y <- y * w mod q by one scalar constant, over a residue
tensor (the reference probes u32 [256, 4, 4096] with 16 steps).
``chain_plain`` is the plain torch version; ``chain`` sends a CUDA tensor to
the hand-written kernel ``csrc/mulmod_chain.cu`` and a CPU tensor to
``chain_plain``. ``launches`` counts kernel launches.

``mad_probe`` runs the source's second probe: independent chains of
32 x 32 -> 64-bit multiply-adds, as IMAD.WIDE.U32 or as IMAD + IMAD.HI
pairs, whose rate settles how many 32-bit multiply slots one such
multiply-add takes (``measure_dgk``).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .modmath import m31

__all__ = ["Q", "W", "WS", "STEPS", "chain", "chain_plain", "chain_cuda",
           "launches", "reset_launches", "mad_probe", "MAD_CHAINS", "MAD_THREADS"]

SOURCE = cuda_build.CSRC / "mulmod_chain.cu"
# The reference probe's constants (gated_profile.py:101-103).
Q = (1 << 30) - (1 << 18) + 1
W = 123456789
WS = (W << 32) // Q
STEPS = 16

MAD_CHAINS = 8  # independent chains a thread of the multiply-add probe
MAD_THREADS = 256  # threads a block of it

launches = 0


def reset_launches():
    global launches
    launches = 0


def _declare(lib):
    vp = ctypes.c_void_p
    lib.pplp_mulmod_chain.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_uint,
                                      ctypes.c_uint, ctypes.c_uint, ctypes.c_int, vp]
    lib.pplp_mulmod_chain.restype = ctypes.c_int
    lib.pplp_mad_probe.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
    lib.pplp_mad_probe.restype = ctypes.c_int


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def _check_constants(w: int, ws: int, q: int, steps: int):
    if not (0 < q < 1 << 30 and 0 <= w < q and ws == (w << 32) // q and steps >= 0):
        raise ValueError(f"need q < 2^30, w < q, ws = floor(w 2^32 / q), steps >= 0; "
                         f"got q={q}, w={w}, ws={ws}, steps={steps}")


def chain_plain(x: torch.Tensor, w: int = W, ws: int = WS, q: int = Q,
                steps: int = STEPS) -> torch.Tensor:
    """``steps`` x ``m31.mulmod_shoup(y, w, ws, q)`` on int64 residues (< 2^32)."""
    _check_constants(w, ws, q, steps)
    for _ in range(steps):
        x = m31.mulmod_shoup(x, w, ws, q)
    return x


def chain_cuda(x: torch.Tensor, w: int = W, ws: int = WS, q: int = Q,
               steps: int = STEPS) -> torch.Tensor:
    """The kernel on a contiguous CUDA int64 tensor; raises on anything else."""
    _check_constants(w, ws, q, steps)
    if not x.is_cuda:
        raise ValueError(f"the CUDA mulmod chain takes CUDA tensors, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("residue tensor must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load()
    code = lib.pplp_mulmod_chain(x.data_ptr(), out.data_ptr(), x.numel(), w, ws, q, steps,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(code, lib, "mulmod_chain")
    global launches
    launches += 1
    return out


def chain(x: torch.Tensor, w: int = W, ws: int = WS, q: int = Q,
          steps: int = STEPS) -> torch.Tensor:
    """The kernel for a CUDA tensor, ``chain_plain`` for a CPU tensor."""
    if x.is_cuda:
        return chain_cuda(x, w, ws, q, steps)
    if x.device.type != "cpu":
        raise ValueError(f"no mulmod chain for device {x.device}")
    return chain_plain(x, w, ws, q, steps)


def mad_probe(device, wide: bool, steps: int, blocks: int) -> torch.Tensor:
    """One launch of the multiply-add probe on ``device`` (a CUDA device):
    blocks x MAD_THREADS threads, each MAD_CHAINS chains of ``steps``
    multiply-adds, IMAD.WIDE.U32 (``wide``) or IMAD + IMAD.HI pairs. Returns
    its output words (one a thread), which only keep the chains live."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the multiply-add probe runs on a CUDA device, got {device}")
    out = torch.empty(blocks * MAD_THREADS, dtype=torch.int32, device=device)
    lib = load()
    code = lib.pplp_mad_probe(out.data_ptr(), int(wide), steps, blocks,
                              torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(code, lib, "mad_probe")
    return out
