"""RNS divide-and-round: x -> round(x / q_last) on the head limbs.

Counterpart of the m31 half of ``pplp_tpu.bfv.rescale``, the primitive
behind ``evaluator.mod_switch_to_next``. With e the centered remainder of x
mod q_last, round(x / q_last) = (x - e) / q_last; per head limb that is
(x_j - |e|_{q_j}) q_last^-1 mod q_j, with a + q_last correction where the
remainder is negative (above q_last / 2). Plain torch; no kernel.
"""

from __future__ import annotations

import torch

from ..ops.modmath import m31

__all__ = ["make_divide_round_last"]


def make_divide_round_last(small_ctx, q_last: int, L_big: int):
    """fn(poly [..., L_big, n]) -> round(poly / q_last) [..., L, n] over the
    ``small_ctx.L`` head limbs (``small_ctx``: the head-limb context)."""
    k = small_ctx.L
    q2 = small_ctx.q2
    mods = small_ctx.moduli
    dev = small_ctx.device

    def col(vals):
        return torch.tensor([[v] for v in vals], dtype=torch.int64, device=dev)

    inv = [pow(q_last, -1, m.value) for m in mods]
    inv_w = col(inv)
    inv_ws = col([(v << 32) // m.value for v, m in zip(inv, mods)])
    ql_res = col([q_last % m.value for m in mods])

    def one_poly(poly: torch.Tensor) -> torch.Tensor:
        last = poly[..., L_big - 1 : L_big, :]
        out = m31.sub(poly[..., :k, :], last % q2, q2)
        out = torch.where(last > q_last // 2, m31.add(out, ql_res, q2), out)
        return m31.mulmod_shoup(out, inv_w, inv_ws, q2)

    return one_poly
