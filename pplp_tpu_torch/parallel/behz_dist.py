"""Distributed BEHZ ciphertext multiply + relinearization over a mesh.

Counterpart of ``DistMultiplier`` (``pplp_tpu/parallel/behz_dist.py``;
BASELINE.md multi-host row: n = 32768 mult+relin with all-to-all NTT
stages). The reference runs the whole multiply in one ``shard_map`` with
the coefficient axis sharded and one all-to-all inside every four-step
transform. The port has whole-row transforms, so it moves the data between
the two layouts of ``parallel.ntt_dist`` instead: C (a rank holds every
limb of n/S coefficients) for the coefficient-wise steps, R (whole rows of
the rank's share of the limbs, Q and B_sk split among the ranks separately,
a sub-table per base) for the transforms and the products. One exchange per
arrow, four a call:

    C: to_bsk
    -> R: forward transforms, the Karatsuba tensor products, inverse
    -> C: fast floor + Shenoy-Kumaresan, the gadget digit lift
    -> R: forward, key products with the rank's key rows [D, L_r, n], inverse
    -> C: the add of (c0, c1)

Each rank's arithmetic is the single-device multiply's, on its block, so
the result is bit for bit ``relinearize(multiply(ct1, ct2))``. On a CUDA
context the steps are the separate-route kernels of ``ops/behz_cuda.py``
(``to_bsk``, ``tensor_spectra``, ``floor_sk``, ``lift_digits``,
``key_products``, ``add_switched``; coefficient-wise ones on the n/S
slice) around ``ntt_cuda.forward_u32``/``inverse_u32``, intermediates u32;
on a CPU context the plain steps of ``bfv/behz.py``.

Like the reference, m31 contexts only (an m62 context raises). The
coefficient-wise kernels take rows of 64 to 32768: n/S >= 64.
"""

from __future__ import annotations

import torch

from ..bfv import behz
from ..bfv.ciphertext import Ciphertext
from ..ops import ntt
from .mesh import block, shard
from .ntt_dist import limb_splits, to_coeffs, to_rows

__all__ = ["DistMultiplier", "MIN_SLICE"]

MIN_SLICE = 64  # the coefficient-wise kernels' narrowest row


class DistMultiplier:
    """BEHZ multiply + relinearize over ``mesh``'s ``coeff_axis``; an
    optional ``batch_axis`` shards the ciphertext batch. ``rlk``'s
    rows this rank needs are kept; its digit groups come from the keys."""

    def __init__(self, ctx, rlk: behz.KSwitchKeys, mesh, coeff_axis: str = "coeff",
                 batch_axis: str | None = None):
        if ctx.tables.profile != "m31":
            raise ValueError(
                f"DistMultiplier takes m31 contexts (primes below 2^30), got "
                f"{ctx.tables.profile}: the reference distributes the m31 multiply only")
        S = mesh.size(coeff_axis)
        if ctx.n % S or ctx.n // S < MIN_SLICE:
            raise ValueError(f"{S} coefficient shards of n = {ctx.n}: each must hold at "
                             f"least {MIN_SLICE} coefficients, and S must divide n")
        self.ctx, self.mesh, self.S = ctx, mesh, S
        self.coeff_axis, self.batch_axis = coeff_axis, batch_axis
        self.mul = mul = behz.multiplier(ctx)
        self.group = mesh.group(coeff_axis)
        self.me = mesh.coord(coeff_axis)
        self.w = ctx.n // S
        self.coeffs = block(ctx.n, S, self.me)
        self.split_q = limb_splits(ctx.L, S)
        self.split_b = limb_splits(mul.K, S)
        (qlo, qhi), (blo, bhi) = self.split_q[self.me], self.split_b[self.me]
        self.limbs = slice(qlo, qhi)
        # Sub-tables of the rank's rows (None where it holds none).
        self.tq = ctx.tables.limbs(self.limbs) if qhi > qlo else None
        self.tb = mul.bsk_tables.limbs(slice(blo, bhi)) if bhi > blo else None
        self.groups = rlk.digit_groups(ctx.L)
        self.keys = behz.KSwitchKeys(
            *(k[:, qlo:qhi].contiguous() for k in (rlk.k0, rlk.k0_shoup, rlk.k1,
                                                   rlk.k1_shoup)),
            groups=self.groups)
        self.cuda = ctx.device.type == "cuda"
        if self.cuda:
            from ..ops import behz_cuda, ntt_cuda

            self._bc, self._nc = behz_cuda, ntt_cuda

    # -- layout ---------------------------------------------------------------

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's C block of a whole [B, L, n] tensor."""
        return shard(x, self.mesh, (self.batch_axis, None, self.coeff_axis))

    def shard_ciphertext(self, ct: Ciphertext) -> Ciphertext:
        """This rank's C blocks of a ciphertext of [B, L, n] polynomials."""
        return Ciphertext(tuple(self.shard(p) for p in ct.polys), ct.domain)

    def _rows(self, parts, splits):
        return to_rows(parts, splits, self.group, self.me)

    def _coeffs(self, parts, splits):
        return to_coeffs(parts, splits, self.group, self.me)

    # -- R-layout steps (a rank without rows passes its empty block on) ------

    def _spectra_product(self, x, tbx):
        """Forward, Karatsuba tensor product, inverse of rows [4, B, Lx, n]."""
        if tbx is None:
            return x.new_empty((3,) + tuple(x.shape[1:]))
        if self.cuda:
            nc = self._nc
            return nc.inverse_u32(self._bc.tensor_spectra(nc.forward_u32(x, tbx), tbx), tbx)
        return ntt.inverse_plain(
            self.mul.tensor_spectra(ntt.forward_plain(x, tbx), tbx), tbx)

    def _switch(self, dig):
        """Forward, key products, inverse of digit rows [D, B, L_r, n]."""
        tq = self.tq
        if tq is None:
            return dig.new_empty((2,) + tuple(dig.shape[1:]))
        if self.cuda:
            nc = self._nc
            return nc.inverse_u32(
                self._bc.key_products(nc.forward_u32(dig, tq), self.ctx, self.keys, tq), tq)
        d_ntt = ntt.forward_plain(dig, tq)
        return ntt.inverse_plain(behz.key_products(self.ctx, d_ntt, self.keys, tq), tq)

    # -- the multiply -----------------------------------------------------------

    def multiply_relinearize_blocks(self, c, d) -> torch.Tensor:
        """(c0, c1) x (d0, d1), each this rank's C block [B', L, n/S] ->
        the relinearized product's C blocks [2, B', L, n/S] (int64)."""
        ctx, mul, w = self.ctx, self.mul, self.w
        if self.cuda:
            bc = self._bc
            polys = [p.contiguous() for p in (*c, *d)]
            xb = bc.to_bsk(*polys, mul, n=w)
            xq = torch.stack(polys).to(torch.int32)  # residues < 2^30: the same bits
        else:
            xq = torch.stack([*c, *d])
            xb = mul._to_bsk(xq)
        rq, rb = self._rows([xq, xb], [self.split_q, self.split_b])
        eq, eb = self._coeffs([self._spectra_product(rq, self.tq),
                               self._spectra_product(rb, self.tb)],
                              [self.split_q, self.split_b])
        if self.cuda:
            out3 = bc.floor_sk(eq, eb, mul, n=w)
            dig = bc.lift_digits(out3[2], ctx, self.keys, n=w)
        else:
            out3 = mul._sk_to_q(mul._fast_floor(eq, eb))
            dig = torch.stack([behz.lift_digit_grouped(ctx, out3[2], g) for g in self.groups])
        (rd,) = self._rows([dig], [self.split_q])
        (sw,) = self._coeffs([self._switch(rd)], [self.split_q])
        if self.cuda:
            return bc.add_switched(out3[0], out3[1], sw, ctx, n=w)
        p, q2 = ctx.prof, ctx.q2
        return torch.stack([p.add(out3[0], sw[0], q2), p.add(out3[1], sw[1], q2)])

    def multiply_relinearize(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """This rank's C blocks of two size-2 coefficient-domain ciphertexts
        (``shard_ciphertext``) -> its block of the relinearized product."""
        behz._check_pair(ct1, ct2)
        batch = tuple(ct1.polys[0].shape[:-2])
        c = [p.reshape((-1, self.ctx.L, self.w)) for p in ct1.polys]
        d = [p.reshape((-1, self.ctx.L, self.w)) for p in ct2.polys]
        out = self.multiply_relinearize_blocks(c, d)
        out = out.reshape((2,) + batch + (self.ctx.L, self.w))
        return Ciphertext((out[0], out[1]), "coeff")
