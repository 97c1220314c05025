"""RNS divide-and-round: x -> round(x / q_last) on the head limbs.

Counterpart of ``pplp_tpu.bfv.rescale``, the primitive behind
``evaluator.mod_switch_to_next``, on both residue profiles. With e the
centered remainder of x mod q_last, round(x / q_last) = (x - e) / q_last;
per head limb that is (x_j - |e|_{q_j}) q_last^-1 mod q_j, with a + q_last
correction where the remainder is negative (above q_last / 2). Residues
are below 2^62, so ``last % q_j`` is exact in int64; the product with
q_last^-1 goes through a Shoup companion of the profile's width (64 bits
on m62). Plain torch; no kernel.
"""

from __future__ import annotations

import torch

from ..ops.modmath import shoup_ints

__all__ = ["make_divide_round_last"]


def make_divide_round_last(small_ctx, q_last: int, L_big: int):
    """fn(poly [..., L_big, n]) -> round(poly / q_last) [..., L, n] over the
    ``small_ctx.L`` head limbs (``small_ctx``: the head-limb context)."""
    k = small_ctx.L
    p, q2 = small_ctx.prof, small_ctx.q2
    mods = [m.value for m in small_ctx.moduli]
    dev = small_ctx.device

    def col(vals):
        return torch.tensor([[v] for v in vals], dtype=torch.int64, device=dev)

    inv_w, inv_ws = (col(v) for v in shoup_ints([pow(q_last, -1, m) for m in mods], mods,
                                                 p.shoup_bits))
    ql_res = col([q_last % m for m in mods])

    def one_poly(poly: torch.Tensor) -> torch.Tensor:
        last = poly[..., L_big - 1 : L_big, :]
        out = p.sub(poly[..., :k, :], last % q2, q2)
        out = torch.where(last > q_last // 2, p.add(out, ql_res, q2), out)
        return p.mulmod_shoup(out, inv_w, inv_ws, q2)

    return one_poly
