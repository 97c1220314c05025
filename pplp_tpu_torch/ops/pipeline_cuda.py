"""Load and launch the packed step's fused kernels (``csrc/pipeline.cu``).

They replace no Pallas kernel: the reference leaves the packed step's
elementwise chain to XLA. On the card the fused route of
``parallel.pipeline``'s step is

* the six ciphertext polynomials transformed by ``ntt_cuda.forward_u32``
  straight from their int64 tensors into one u32 workspace [6, ..., L, n],
  one launch per run of polynomials that lie back to back in one storage
  (two for ``make_packed_inputs``' ciphertexts, at most six);
* ``Combine``: one launch of ``pipe_combine``, the products by the
  plaintext and key spectra and the two additive terms' spectra, into u32
  (or int64) values;
* ``ntt_cuda.inverse_u32`` (``ntt_cuda.inverse`` for int64);
* ``decode``: one launch of ``pipe_decode``, the BEHZ decode of
  ``bfv.rns_decrypt.RnsDecoder`` into int64 blind distances [..., n].

``route`` is the rule that picks it: CUDA residues, an m31 chain and no
mesh; everything else runs the plain torch chain. ``launches_by_kernel``
counts the launches of the two kernels. ``combine_constants`` and
``decode_constants`` pack what the kernels read; the numpy model in
``tests/test_torch_pipeline_words.py`` reads the same arrays.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build, ntt, ntt_cuda

__all__ = ["route", "Combine", "combine_constants", "decode", "decode_constants",
           "launches_by_kernel", "reset_launches", "load", "forward_runs"]

SOURCE = cuda_build.CSRC / "pipeline.cu"

launches_by_kernel = {"pipe_combine": 0, "pipe_decode": 0}


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _declare(lib):
    vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.pplp_pipe_combine.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.pplp_pipe_decode.argtypes = [vp, ci, vp, vp, ctypes.c_longlong, ci, ci, cu, cu, cu, cu,
                                     cu, vp]
    for name in ("combine", "decode"):
        getattr(lib, f"pplp_pipe_{name}").restype = ci


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def route(x: torch.Tensor, tables, mesh=None) -> str:
    """"fused" for CUDA residues on an m31 chain outside a mesh, else "plain"."""
    return "fused" if mesh is None and tables.profile == "m31" and x.is_cuda else "plain"


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def combine_constants(tables, z, sr, m_ntt, m_shoup, s_ntt, s_shoup) -> torch.Tensor:
    """The combine's ten constant planes as u32 (int32 bits) [10, L, n] on
    the tables' device: the spectra of z and s r, then (xb, yb, s) and the
    secret key's spectrum each beside its Shoup companion."""
    planes = [ntt.forward(z, tables), ntt.forward(sr, tables)]
    for i in range(3):
        planes += [m_ntt[i], m_shoup[i]]
    planes += [s_ntt, s_shoup]
    return cuda_build.u32_buffer(torch.stack(planes), tables.device)


def forward_runs(polys) -> list[tuple[int, torch.Tensor]]:
    """Cut polynomials of one shape [..., L, n] into runs of views of one
    tensor that lie back to back: [(index of the run's first, a contiguous
    view of the run [k * rows, L, n])]."""
    runs = []  # [first index, first polynomial, length]
    for i, p in enumerate(polys):
        p = p.contiguous()
        if runs:
            _, first, k = runs[-1]
            if (p._base is not None and p._base is first._base
                    and p.data_ptr() == first.data_ptr() + k * p.numel() * p.itemsize):
                runs[-1][2] += 1
                continue
        runs.append([i, p, 1])
    out = []
    for start, first, k in runs:
        L, n = first.shape[-2:]
        out.append((start, first.as_strided((k * (first.numel() // (L * n)), L, n),
                                            (L * n, n, 1))))
    return out


class Combine:
    """The fused evaluation of ``parallel.pipeline``'s step for one set of
    constants: ``__call__(c1, c2, c3, wide)`` gives x = c0 + c1 s [..., L, n]
    as u32 (int32 bits) or, with ``wide``, int64."""

    def __init__(self, tables, z, sr, m_ntt, m_shoup, s_ntt, s_shoup):
        self.tables = tables
        self.consts = combine_constants(tables, z, sr, m_ntt, m_shoup, s_ntt, s_shoup)

    def __call__(self, c1_polys, c2_polys, c3_polys, wide: bool) -> torch.Tensor:
        tb = self.tables
        polys = (c1_polys[0], c2_polys[0], c3_polys[0], c1_polys[1], c2_polys[1], c3_polys[1])
        shape = polys[0].shape
        if shape[-2:] != (tb.L, tb.n) or any(p.shape != shape or p.dtype != torch.int64
                                              for p in polys):
            raise ValueError(f"the six ciphertext polynomials must be int64 [..., {tb.L}, "
                             f"{tb.n}] of one shape")
        rows = polys[0].numel() // (tb.L * tb.n)
        spec = torch.empty((6,) + tuple(shape), dtype=torch.int32, device=polys[0].device)
        flat = spec.view(6 * rows, tb.L, tb.n)
        for start, run in forward_runs(polys):
            ntt_cuda.forward_u32(run, tb, out=flat[start * rows:start * rows + run.shape[0]])
        val = torch.empty(shape, dtype=torch.int64 if wide else torch.int32, device=spec.device)
        if rows:
            lib = load()
            q = ntt_cuda.table_buffers(tb)["q"]
            code = lib.pplp_pipe_combine(spec.data_ptr(), self.consts.data_ptr(), q.data_ptr(),
                                         val.data_ptr(), int(wide), rows, tb.L, tb.logn,
                                         _stream(spec))
            cuda_build.check(code, lib, "pipe_combine")
            launches_by_kernel["pipe_combine"] += 1
        return ntt_cuda.inverse(val, tb) if wide else ntt_cuda.inverse_u32(val, tb)


def decode_constants(moduli, t: int, gamma: int, ymul, c_t, c_g) -> tuple[np.ndarray, tuple]:
    """The decode's limb table u32 [L, 7] (q, the y multiplier and its
    companion mod q, c_t and its companion mod t, c_gamma and its companion
    mod gamma) and its scalars (t, gamma, gamma mod t, gamma^-1 mod t and
    its companion), from Python ints."""
    limbs = np.array([[q, y, (y << 32) // q, a, (a << 32) // t, b, (b << 32) // gamma]
                      for q, y, a, b in zip(moduli, ymul, c_t, c_g)], dtype=np.uint32)
    inv = pow(gamma % t, -1, t)
    return limbs, (t, gamma, gamma % t, inv, (inv << 32) // t)


def decode(x: torch.Tensor, limbs: torch.Tensor, scalars: tuple) -> torch.Tensor:
    """One launch of ``pipe_decode``: CUDA residues x [..., L, n] (int64, or
    u32 as int32 bits) -> m mod t, int64 [..., n]. ``limbs`` is
    ``decode_constants``' table on x's device (int32 bits)."""
    if not x.is_cuda:
        raise ValueError(f"the CUDA decode takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"residues must be int64 or u32 (int32), got {x.dtype}")
    L = limbs.shape[0]
    if x.dim() < 2 or x.shape[-2] != L:
        raise ValueError(f"expected [..., {L}, n], got {tuple(x.shape)}")
    if limbs.device != x.device:
        raise ValueError(f"residues on {x.device}, constants on {limbs.device}")
    x = x.contiguous()
    out = torch.empty(x.shape[:-2] + x.shape[-1:], dtype=torch.int64, device=x.device)
    if out.numel() == 0:
        return out
    lib = load()
    code = lib.pplp_pipe_decode(x.data_ptr(), int(x.dtype == torch.int32), limbs.data_ptr(),
                                out.data_ptr(), out.numel(), L, x.shape[-1], *scalars,
                                _stream(x))
    cuda_build.check(code, lib, "pipe_decode")
    launches_by_kernel["pipe_decode"] += 1
    return out
