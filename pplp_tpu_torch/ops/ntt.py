"""Negacyclic NTT/INTT over RNS prime chains (m31 and m62), on int64 tensors.

Counterpart of ``pplp_tpu.ops.ntt`` with one engine and one spectrum order:
the stage engine's. ``forward`` consumes standard coefficient order and
produces the spectrum in bit-reversed order (index i holds the evaluation
at psi^(2 brv(i) + 1)); ``inverse`` consumes that order.

The profile follows the chain, as in the reference: every prime below 2^30
is ``m31``, every prime in [2^32, 2^62) is ``m62``; a mix is refused.
``NttTables.prof`` is the arithmetic of the profile.

``forward`` and ``inverse`` dispatch on the tensor's device: a CUDA tensor
goes to the hand-written kernel of the profile (``ntt_cuda``,
``csrc/ntt.cu``: u32 for m31, u64 for m62), a CPU tensor to
``forward_plain`` / ``inverse_plain``. On m31 these follow the stage
engine's butterfly sweeps (``pplp_tpu/ops/ntt.py:215-267``) op for op; on
m62 they run the same sweeps with canonical butterflies, since a lazy value
up to 4q does not fit int64. Canonical outputs agree bit for bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .modmath import as_int64_bits, m31, m62
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
    their Shoup companions floor(w * 2^b / q), b = 32 (m31) or 64 (m62, kept
    as int64 bit patterns); ``n_inv``/``n_inv_s`` [L]. All int64. ``mu`` is
    floor(2^128 / q) as three 32-bit words [3, L] on m62 (None on m31).
    ``kernel_buffers`` caches the packed tables the CUDA kernels read.
    """

    n: int
    logn: int
    profile: str  # "m31" | "m62"
    moduli: tuple[Modulus, ...]
    device: torch.device
    q: torch.Tensor
    w: torch.Tensor
    ws: torch.Tensor
    iw: torch.Tensor
    iws: torch.Tensor
    n_inv: torch.Tensor
    n_inv_s: torch.Tensor
    mu: torch.Tensor | None = None
    kernel_buffers: dict = field(default_factory=dict, repr=False)

    @property
    def L(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def prof(self):
        """The profile's arithmetic: ``m31``, or ``m62`` bound to this
        chain's ratio words, so both take the same arguments."""
        return m31 if self.profile == "m31" else m62(self.mu_b(1))

    def mu_b(self, extra_dims: int) -> tuple:
        """m62 ratio words (r0, r1, r2), each shaped like ``q_b(extra_dims)``."""
        return tuple(r.reshape((self.L,) + (1,) * extra_dims) for r in self.mu)

    def q_b(self, extra_dims: int) -> torch.Tensor:
        """q shaped [L, 1, ...] to broadcast against [..., L, <extra_dims>]."""
        return self.q.reshape((self.L,) + (1,) * extra_dims)


def build_tables(moduli: Sequence[Modulus], n: int, device) -> NttTables:
    """Forward/inverse twiddle tables for a chain of NTT-friendly primes."""
    logn = n.bit_length() - 1
    if 1 << logn != n or not MIN_N <= n <= MAX_N:
        raise ValueError(f"n must be a power of two in [{MIN_N}, {MAX_N}], got {n}")
    profile = "m31" if all(m.value < (1 << 30) for m in moduli) else "m62"
    if profile == "m62" and not all(1 << 32 <= m.value < 1 << 62 for m in moduli):
        raise ValueError(
            "the m62 profile needs every prime in [2^32, 2^62); do not mix "
            "primes below 2^30 into a wide chain"
        )
    shoup_bits = (m31 if profile == "m31" else m62).shoup_bits
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
        if profile == "m31":
            # w < 2^30, so w << 32 < 2^62 fits int64 exactly.
            rows["ws"].append((w << 32) // q)
            rows["iws"].append((iw << 32) // q)
        else:
            for name, vals in (("ws", w), ("iws", iw)):
                rows[name].append([as_int64_bits((int(v) << 64) // q) for v in vals])
        ninv = pow(n, -1, q)
        n_inv.append(ninv)
        n_inv_s.append(as_int64_bits(mod.shoup(ninv, shoup_bits)))

    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    mu = None
    if profile == "m62":
        mu = put([[(m.const_ratio >> (32 * i)) & 0xFFFFFFFF for m in moduli]
                  for i in range(3)])
    return NttTables(
        n=n,
        logn=logn,
        profile=profile,
        moduli=tuple(moduli),
        device=dev,
        q=put([m.value for m in moduli]),
        w=put(np.stack(rows["w"])),
        ws=put(np.stack(rows["ws"])),
        iw=put(np.stack(rows["iw"])),
        iws=put(np.stack(rows["iws"])),
        n_inv=put(n_inv),
        n_inv_s=put(n_inv_s),
        mu=mu,
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
    if tb.profile == "m62":
        return _forward_plain_m62(x, tb)
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
    if tb.profile == "m62":
        return _inverse_plain_m62(x, tb)
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


def _forward_plain_m62(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """The stage engine's CT sweeps with canonical butterflies (m62)."""
    n = tb.n
    lead = x.shape[:-1]
    q3 = tb.q_b(2)
    h, t = 1, n
    for _ in range(tb.logn):
        t //= 2
        xv = x.reshape(lead + (h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        mv = m62.mulmod_shoup(v, tb.w[:, h : 2 * h, None], tb.ws[:, h : 2 * h, None], q3)
        x = torch.stack([m62.add(u, mv, q3), m62.sub(u, mv, q3)], dim=-2)
        x = x.reshape(lead + (n,))
        h *= 2
    return x


def _inverse_plain_m62(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """The stage engine's GS sweeps with canonical butterflies (m62)."""
    n = tb.n
    lead = x.shape[:-1]
    q3 = tb.q_b(2)
    h, t = n // 2, 1
    for _ in range(tb.logn):
        xv = x.reshape(lead + (h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        d = m62.mulmod_shoup(m62.sub(u, v, q3), tb.iw[:, h : 2 * h, None],
                             tb.iws[:, h : 2 * h, None], q3)
        x = torch.stack([m62.add(u, v, q3), d], dim=-2).reshape(lead + (n,))
        h //= 2
        t *= 2
    q2 = tb.q_b(1)
    return m62.mulmod_shoup(x, tb.n_inv[:, None], tb.n_inv_s[:, None], q2)


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
    return tb.prof.mulmod(a, b, tb.q_b(1))


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
