"""Key generation: ternary secret, RLWE public key, held in the NTT domain.

Counterpart of ``pplp_tpu.bfv.keys``. Keys carry Shoup companions so every
key product in encrypt/decrypt is the Shoup fast path (32-bit companions on
m31, 64-bit ones as int64 bit patterns on m62). Spectra are in the port's
(stage engine's) order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ntt
from . import sampling
from .context import BFVContext

__all__ = ["SecretKey", "PublicKey", "KeyGenerator", "shoup",
           "make_keys", "keys_from_reference", "from_reference_array"]


def shoup(ctx: BFVContext, w: torch.Tensor) -> torch.Tensor:
    """Shoup companions floor(w * 2^b / q_i) of residues [..., L, n]
    (b = 32 on m31, 64 on m62)."""
    return ctx.prof.shoup_precompute(w, ctx.q2)


@dataclass
class SecretKey:
    s_ntt: torch.Tensor
    s_shoup: torch.Tensor


@dataclass
class PublicKey:
    pk0_ntt: torch.Tensor
    pk1_ntt: torch.Tensor
    pk0_shoup: torch.Tensor
    pk1_shoup: torch.Tensor


def make_keys(ctx: BFVContext, s: torch.Tensor, a_ntt: torch.Tensor,
              e: torch.Tensor) -> tuple[SecretKey, PublicKey]:
    """Keys from a coefficient-domain secret s, a uniform a (NTT domain, as
    the reference samples it) and coefficient-domain noise e:
    pk0 = -(a*s + e), pk1 = a."""
    p, q2 = ctx.prof, ctx.q2
    spec = ntt.forward(torch.stack([s, e]), ctx.tables)
    s_ntt, e_ntt = spec[0], spec[1]
    s_shoup = shoup(ctx, s_ntt)
    pk0 = p.neg(p.add(p.mulmod_shoup(a_ntt, s_ntt, s_shoup, q2), e_ntt, q2), q2)
    return (
        SecretKey(s_ntt=s_ntt, s_shoup=s_shoup),
        PublicKey(pk0_ntt=pk0, pk1_ntt=a_ntt,
                  pk0_shoup=shoup(ctx, pk0), pk1_shoup=shoup(ctx, a_ntt)),
    )


class KeyGenerator:
    """Keys drawn from an explicit ``torch.Generator`` on the context's device.

    The secret's ternary words [n] are kept (``secret_words``): they do not
    depend on the chain, so the special-prime keys lift the same secret
    onto the extended basis with ``sampling.ternary_poly_from_bits``, as the
    reference resamples it from its PRNG key."""

    def __init__(self, ctx: BFVContext, generator: torch.Generator | None):
        self.ctx = ctx
        self.generator = generator
        self._words: tuple | None = None
        self._keys: tuple[SecretKey, PublicKey] | None = None

    @classmethod
    def from_bits(cls, ctx: BFVContext, s_bits, a_bits, e_bits) -> "KeyGenerator":
        """The known-answer hook: the words the reference's keygen drew
        (ternary [n], uniform [2|4, L, n], CBD [2, n])."""
        kg = cls(ctx, None)
        as_words = lambda b: torch.as_tensor(np.asarray(b, dtype=np.int64),  # noqa: E731
                                             device=ctx.device)
        kg._words = tuple(as_words(b) for b in (s_bits, a_bits, e_bits))
        return kg

    def _draw(self) -> tuple:
        """The keygen's words, drawn once in the order secret, a, e."""
        if self._words is None:
            ctx, g = self.ctx, self.generator
            self._words = (
                sampling.words(g, (ctx.n,), ctx.device),
                sampling.words(g, (ctx.prof.uniform_words, ctx.L, ctx.n), ctx.device),
                sampling.words(g, (2, ctx.n), ctx.device),
            )
        return self._words

    @property
    def secret_words(self) -> torch.Tensor:
        """The secret's ternary words [n] (int64 holding u32)."""
        return self._draw()[0]

    def _make(self):
        if self._keys is None:
            ctx = self.ctx
            s_bits, a_bits, e_bits = self._draw()
            self._keys = make_keys(ctx, sampling.ternary_poly_from_bits(s_bits, ctx),
                                   sampling.uniform_rq_from_bits(a_bits, ctx),
                                   sampling.cbd_poly_from_bits(e_bits, ctx))
        return self._keys

    def secret_key(self) -> SecretKey:
        return self._make()[0]

    def create_public_key(self) -> PublicKey:
        return self._make()[1]


def _int64_bits(a) -> np.ndarray:
    """A reference array: u32 values (m31) or a (lo, hi) u32 pair (m62, one
    64-bit value per entry) -> int64 holding the same bits."""
    if isinstance(a, (tuple, list)):
        lo, hi = (np.asarray(x).astype(np.uint64) for x in a)
        return (lo | (hi << np.uint64(32))).view(np.int64)
    return np.asarray(a).astype(np.int64)


def from_reference_array(ctx: BFVContext, a, perm=None) -> torch.Tensor:
    """A reference key array ([..., L, n]: numpy u32 on m31, a (lo, hi) pair
    of them on m62) on the port's device, as int64 with the same bits.

    Stage-engine spectra carry over as they are. For another engine's
    spectrum order pass ``perm`` from ``ntt.order_permutation`` (port order
    indexed by ``perm`` gives the other order); entries are moved back into
    the port's order."""
    t = torch.as_tensor(_int64_bits(a), device=ctx.device)
    if perm is None:
        return t
    out = torch.empty_like(t)
    out[..., torch.as_tensor(perm, device=ctx.device)] = t
    return out


def keys_from_reference(ctx: BFVContext, s_ntt, s_shoup, pk0_ntt, pk1_ntt,
                        pk0_shoup, pk1_shoup, perm=None):
    """The reference's key arrays ([L, n], either profile's form) as the
    port's keys; ``perm`` as in ``from_reference_array``. All six leaves
    carry over, the Shoup companions moving with their values.
    """
    put = lambda a: from_reference_array(ctx, a, perm)  # noqa: E731
    return (
        SecretKey(s_ntt=put(s_ntt), s_shoup=put(s_shoup)),
        PublicKey(pk0_ntt=put(pk0_ntt), pk1_ntt=put(pk1_ntt),
                  pk0_shoup=put(pk0_shoup), pk1_shoup=put(pk1_shoup)),
    )
