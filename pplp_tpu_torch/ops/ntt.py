"""Negacyclic NTT/INTT over RNS prime chains (m31 profile), on int64 tensors.

Counterpart of ``pplp_tpu.ops.ntt`` with one engine and one spectrum order:
the stage engine's. ``forward`` consumes standard coefficient order and
produces the spectrum in bit-reversed order (index i holds the evaluation
at psi^(2 brv(i) + 1)); ``inverse`` consumes that order.

``forward`` and ``inverse`` dispatch on the tensor's device: a CUDA tensor
goes to the hand-written kernel (``ntt_cuda``, ``csrc/ntt.cu``), a CPU
tensor to ``forward_plain`` / ``inverse_plain``, which follow the stage
engine's butterfly sweeps (``pplp_tpu/ops/ntt.py:215-267``) op for op.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .modmath import m31
from .primes import Modulus

__all__ = [
    "NttTables",
    "build_tables",
    "forward",
    "inverse",
    "forward_plain",
    "inverse_plain",
    "pointwise_mul",
    "negacyclic_polymul",
    "order_permutation",
]

MIN_N = 64
MAX_N = 32768


def _bitrev_perm(logn: int) -> np.ndarray:
    k = np.arange(1 << logn, dtype=np.int64)
    r = np.zeros_like(k)
    for _ in range(logn):
        r = (r << 1) | (k & 1)
        k >>= 1
    return r


def _powers(base: int, n: int, q: int) -> np.ndarray:
    out = [1] * n
    for k in range(1, n):
        out[k] = out[k - 1] * base % q
    return np.asarray(out, dtype=np.int64)


@dataclass(eq=False)
class NttTables:
    """Twiddle tables for one RNS chain at one degree, on one device.

    ``w``/``iw`` are bit-reversed psi / psi^-1 powers [L, n] and ``ws``/``iws``
    their Shoup companions floor(w * 2^32 / q); ``n_inv``/``n_inv_s`` [L].
    All int64. ``kernel_buffers`` caches the u32 copies the CUDA kernel reads.
    """

    n: int
    logn: int
    moduli: tuple[Modulus, ...]
    device: torch.device
    q: torch.Tensor
    w: torch.Tensor
    ws: torch.Tensor
    iw: torch.Tensor
    iws: torch.Tensor
    n_inv: torch.Tensor
    n_inv_s: torch.Tensor
    kernel_buffers: dict = field(default_factory=dict, repr=False)

    @property
    def L(self) -> int:
        return len(self.moduli)

    def q_b(self, extra_dims: int) -> torch.Tensor:
        """q shaped [L, 1, ...] to broadcast against [..., L, <extra_dims>]."""
        return self.q.reshape((self.L,) + (1,) * extra_dims)


def build_tables(moduli: Sequence[Modulus], n: int, device) -> NttTables:
    """Forward/inverse twiddle tables for a chain of NTT-friendly primes."""
    logn = n.bit_length() - 1
    if 1 << logn != n or not MIN_N <= n <= MAX_N:
        raise ValueError(f"n must be a power of two in [{MIN_N}, {MAX_N}], got {n}")
    if not all(m.value < (1 << 30) for m in moduli):
        raise NotImplementedError(
            "primes of 30 bits or more need the m62 arithmetic and a 64-bit "
            "NTT kernel, which are not ported yet; use the 'tpu' profile"
        )
    brv = _bitrev_perm(logn)
    rows = {"w": [], "ws": [], "iw": [], "iws": []}
    n_inv, n_inv_s = [], []
    for mod in moduli:
        q = mod.value
        assert (q - 1) % (2 * n) == 0, "prime not NTT-friendly for this n"
        psi = mod.minimal_primitive_root(2 * n)
        w = _powers(psi, n, q)[brv]
        iw = _powers(pow(psi, -1, q), n, q)[brv]
        rows["w"].append(w)
        rows["iw"].append(iw)
        # w < 2^30, so w << 32 < 2^62 fits int64 exactly.
        rows["ws"].append((w << 32) // q)
        rows["iws"].append((iw << 32) // q)
        ninv = pow(n, -1, q)
        n_inv.append(ninv)
        n_inv_s.append(mod.shoup(ninv, 32))

    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    return NttTables(
        n=n,
        logn=logn,
        moduli=tuple(moduli),
        device=dev,
        q=put([m.value for m in moduli]),
        w=put(np.stack(rows["w"])),
        ws=put(np.stack(rows["ws"])),
        iw=put(np.stack(rows["iw"])),
        iws=put(np.stack(rows["iws"])),
        n_inv=put(n_inv),
        n_inv_s=put(n_inv_s),
    )


def _check(x: torch.Tensor, tb: NttTables):
    if x.dtype != torch.int64:
        raise TypeError(f"residues must be int64, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2:] != (tb.L, tb.n):
        raise ValueError(f"expected [..., {tb.L}, {tb.n}], got {tuple(x.shape)}")
    if x.device != tb.device:
        raise ValueError(f"tensor on {x.device}, tables on {tb.device}")


def forward_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Plain-torch negacyclic NTT along the last axis of [..., L, n]."""
    _check(x, tb)
    p = m31
    n = tb.n
    lead = x.shape[:-1]
    q3 = tb.q_b(2)
    two_q = 2 * q3
    h, t = 1, n
    for _ in range(tb.logn):
        t //= 2
        xv = x.reshape(lead + (h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        w = tb.w[:, h : 2 * h, None]
        ws = tb.ws[:, h : 2 * h, None]
        # Harvey lazy CT: u < 4q -> [0, 2q); outputs < 4q; canonical at end.
        u = p.csub2q(u, two_q)
        mv = p.mulmod_shoup_lazy(v, w, ws, q3)
        x = torch.stack([p.lazy_add(u, mv), p.lazy_sub2q(u, mv, two_q)], dim=-2)
        x = x.reshape(lead + (n,))
        h *= 2
    q2 = tb.q_b(1)
    return p.csub(p.csub2q(x, 2 * q2), q2)


def inverse_plain(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Plain-torch inverse of ``forward_plain`` (bit-reversed input order)."""
    _check(x, tb)
    p = m31
    n = tb.n
    lead = x.shape[:-1]
    q3 = tb.q_b(2)
    two_q = 2 * q3
    h, t = n // 2, 1
    for _ in range(tb.logn):
        xv = x.reshape(lead + (h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        w = tb.iw[:, h : 2 * h, None]
        ws = tb.iws[:, h : 2 * h, None]
        # Harvey lazy GS: inputs/outputs < 2q; canonical via the n^-1 product.
        s = p.csub2q(p.lazy_add(u, v), two_q)
        d = p.mulmod_shoup_lazy(p.lazy_sub2q(u, v, two_q), w, ws, q3)
        x = torch.stack([s, d], dim=-2).reshape(lead + (n,))
        h //= 2
        t *= 2
    q2 = tb.q_b(1)
    return p.mulmod_shoup(x, tb.n_inv[:, None], tb.n_inv_s[:, None], q2)


def forward(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Negacyclic NTT: the CUDA kernel for a CUDA tensor, else plain torch."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.forward(x, tb)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return forward_plain(x, tb)


def inverse(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT, dispatched like ``forward``."""
    if x.is_cuda:
        from . import ntt_cuda

        return ntt_cuda.inverse(x, tb)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return inverse_plain(x, tb)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Residue-wise product, both operands variable."""
    return m31.mulmod(a, b, tb.q_b(1))


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """c = a * b mod (x^n + 1) mod q_i, coefficient order in and out."""
    return inverse(pointwise_mul(forward(a, tb), forward(b, tb), tb), tb)


def order_permutation(other_x_spectrum: np.ndarray, tb: NttTables) -> np.ndarray:
    """Index map from this port's spectrum order to another engine's.

    ``other_x_spectrum`` [L, n] is the other engine's forward transform of
    the monomial X, whose entries psi^(2k+1) are all distinct. Returns
    ``perm`` with ``forward(x)[..., perm] == other_forward(x)`` for every x;
    the map is the same for every limb.
    """
    mono = torch.zeros((tb.L, tb.n), dtype=torch.int64, device=tb.device)
    mono[:, 1] = 1
    ours = forward(mono, tb).cpu().numpy()
    other = np.asarray(other_x_spectrum, dtype=np.int64)
    perm = None
    for li in range(tb.L):
        where = {int(v): i for i, v in enumerate(ours[li])}
        p = np.asarray([where[int(v)] for v in other[li]], dtype=np.int64)
        if perm is None:
            perm = p
        elif not np.array_equal(perm, p):
            raise ValueError("spectrum orders differ between limbs")
    return perm
