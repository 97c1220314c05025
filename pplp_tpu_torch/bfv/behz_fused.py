"""BEHZ multiply + relinearization through the hand-written kernels.

Counterpart of ``pplp_tpu.bfv.behz_fused.FusedMultiplier``. On a CUDA
context every call goes to the kernels of the context's profile: m31 to
``ops.behz_cuda`` (``csrc/behz.cu`` plus the NTT kernel), m62 to
``ops.behz64_cuda`` (``csrc/behz64.cu`` around the u64 NTT kernels). On a
CPU context it goes to the plain version (``bfv.behz``). This is a dispatch,
not a fallback: a CUDA context never runs the plain version, and a failed
build or launch raises. The results are the same bit for bit.

Ciphertexts may carry a leading batch: polynomials [..., L, n]. Contexts are
built the port's one way (stage spectrum order), so there is no engine
requirement; relinearization reads the gadget width (1 or 2) from the keys.
"""

from __future__ import annotations

from .behz import KSwitchKeys, _check_pair, multiplier, relinearize
from .ciphertext import Ciphertext
from .context import BFVContext

__all__ = ["FusedMultiplier", "kernel_module"]


def kernel_module(ctx: BFVContext):
    """The BEHZ kernel module of the context's profile: ``behz64_cuda`` on
    m62, ``behz_cuda`` on m31."""
    if ctx.tables.profile == "m62":
        from ..ops import behz64_cuda

        return behz64_cuda
    from ..ops import behz_cuda

    return behz_cuda


class FusedMultiplier:
    def __init__(self, ctx: BFVContext, rlk: KSwitchKeys | None = None):
        self.ctx = ctx
        self.rlk = rlk
        self.mul = multiplier(ctx)

    @property
    def on_card(self) -> bool:
        return self.ctx.device.type == "cuda"

    def _keys(self) -> KSwitchKeys:
        if self.rlk is None:
            raise ValueError("this FusedMultiplier was built without relinearization keys")
        return self.rlk

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """Tensor product without relinearization: a size-3 ciphertext."""
        _check_pair(ct1, ct2)
        if not self.on_card:
            return self.mul.multiply(ct1, ct2)
        out = kernel_module(self.ctx).multiply(*ct1.polys, *ct2.polys, self.mul)
        return Ciphertext(tuple(out.unbind(0)), "coeff")

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        """Size 3 -> size 2 with this multiplier's keys."""
        rlk = self._keys()
        if not self.on_card:
            return relinearize(self.ctx, ct, rlk)
        if ct.size != 3 or ct.domain != "coeff":
            raise ValueError("relinearize takes a size-3 coefficient-domain ciphertext")
        out = kernel_module(self.ctx).relinearize(*ct.polys, self.ctx, rlk)
        return Ciphertext(tuple(out.unbind(0)), "coeff")

    def multiply_relinearize(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """The product, relinearized: a size-2 ciphertext."""
        self._keys()
        return self.relinearize(self.multiply(ct1, ct2))
