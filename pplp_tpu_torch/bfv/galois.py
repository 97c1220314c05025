"""Galois automorphisms and rotations (SEAL's apply_galois / rotate_rows /
rotate_columns).

Counterpart of ``pplp_tpu.bfv.galois``. The automorphism sigma_g:
a(X) -> a(X^g) mod (X^n + 1), g odd, permutes coefficients with signs:
X^i -> +-X^{(i g) mod n}, negated where i g mod 2n lands in [n, 2n). On a
ciphertext (c0, c1) it yields an encryption under sigma_g(s); a key switch
toward sigma_g(s) returns it to s.

With the batch encoder's slot order, sigma_3 rotates each slot row by one
and sigma_{2n-1} swaps the rows.

The gather/sign tables are built on the host once per (n, g) and device. ``apply_galois`` dispatches on the key type: special-prime keys go
to ``keyswitch.sp_keyswitch``; RNS-gadget keys, on a CUDA context, to the
profile's relinearization kernel on (c0g, 0, c1g) (``behz_relin_ntt``, or
the behz64 route on m62), which returns (c0g + d0, d1); on a CPU context to
the plain ``behz.keyswitch_contributions_grouped`` with the keys' own digit
groups, as the kernel reads them (the reference's width-1
``keyswitch_contributions`` for the width-1 keys ``create_galois_keys``
makes). A CUDA context never runs the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import ntt
from . import behz
from .behz_fused import kernel_module
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import SecretKey

__all__ = [
    "galois_elt_from_step",
    "apply_galois_plain",
    "create_galois_keys",
    "apply_galois",
    "rotate_rows",
    "rotate_columns",
]


def galois_elt_from_step(step: int, n: int) -> int:
    """SEAL's convention: a row rotation by ``step`` is g = 3^step mod 2n
    (negative steps the other way); the column swap is g = 2n - 1."""
    m = 2 * n
    if step >= 0:
        return pow(3, step, m)
    return pow(pow(3, -1, m), -step, m)


@functools.lru_cache(maxsize=128)
def _tables(n: int, g: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, negate) on ``device``: output j takes input src[j], negated
    where negate[j]. Built on the host once per (n, g, device)."""
    if g % 2 != 1:
        raise ValueError(f"a Galois element is odd, got {g}")
    i = np.arange(n, dtype=np.int64)
    j = (i * g) % (2 * n)
    src = np.empty(n, np.int64)
    negate = np.empty(n, bool)
    src[j % n] = i
    negate[j % n] = j >= n
    return torch.as_tensor(src, device=device), torch.as_tensor(negate, device=device)


def apply_galois_plain(ctx: BFVContext, poly: torch.Tensor, g: int) -> torch.Tensor:
    """sigma_g of coefficient-domain residues [..., L, n]."""
    src, negate = _tables(ctx.n, g, ctx.device)
    gathered = poly[..., src]
    return torch.where(negate, ctx.prof.neg(gathered, ctx.q2), gathered)


def create_galois_keys(ctx: BFVContext, sk: SecretKey, g: int,
                       generator: torch.Generator) -> behz.KSwitchKeys:
    """RNS-gadget keys toward sigma_g(s), one digit per limb."""
    s_coeff = ntt.inverse(sk.s_ntt, ctx.tables)
    target = ntt.forward(apply_galois_plain(ctx, s_coeff, g), ctx.tables)
    return behz.create_kswitch_keys(ctx, sk, target, generator)


def apply_galois(ctx: BFVContext, ct: Ciphertext, g: int, gk) -> Ciphertext:
    """sigma_g on a size-2 ciphertext, switched back to s with ``gk``:
    RNS-gadget ``KSwitchKeys`` or special-prime ``keyswitch.SPKeys``."""
    from .keyswitch import SPKeys, sp_keyswitch

    if ct.size != 2 or ct.domain != "coeff":
        raise ValueError("apply_galois takes a size-2 coefficient-domain ciphertext")
    p, q2 = ctx.prof, ctx.q2
    c0g = apply_galois_plain(ctx, ct.polys[0], g)
    c1g = apply_galois_plain(ctx, ct.polys[1], g)
    if isinstance(gk, SPKeys):
        d0, d1 = sp_keyswitch(ctx, gk, c1g)
        return Ciphertext((p.add(c0g, d0, q2), d1), "coeff")
    if ctx.device.type == "cuda":
        out = kernel_module(ctx).relinearize(c0g, torch.zeros_like(c0g), c1g, ctx, gk)
        return Ciphertext(tuple(out.unbind(0)), "coeff")
    d0, d1 = behz.keyswitch_contributions_grouped(ctx, c1g, gk, gk.digit_groups(ctx.L))
    return Ciphertext((p.add(c0g, d0, q2), d1), "coeff")


def rotate_rows(ctx: BFVContext, ct: Ciphertext, step: int, gk) -> Ciphertext:
    """Rotate both slot rows by ``step`` (keys for ``galois_elt_from_step``)."""
    return apply_galois(ctx, ct, galois_elt_from_step(step, ctx.n), gk)


def rotate_columns(ctx: BFVContext, ct: Ciphertext, gk) -> Ciphertext:
    """Swap the two slot rows (keys for g = 2n - 1)."""
    return apply_galois(ctx, ct, 2 * ctx.n - 1, gk)
