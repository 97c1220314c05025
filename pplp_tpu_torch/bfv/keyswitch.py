"""Special-prime (hybrid) key switching over the extended basis Q ∪ {P}.

Counterpart of ``pplp_tpu.bfv.keyswitch``. Keys live over QP, the
accumulated product carries a factor P, and the final divide-and-round by P
brings the digit noise down to O(B):

  key_i = (b_i, a_i) over QP,  b_i = -(a_i s + e_i) + P g_i T,
  g_i = 1 mod q_i, 0 mod q_j (j != i);  so  P g_i mod q_j = (P mod q_i) delta_ij,
  P g_i mod P = 0;

  switch(c) = round(sum_i NTT([c]_{q_i}) * key_i / P)  over Q.

T = s^2 gives relinearization keys, T = sigma_g(s) Galois keys.

``sp_keyswitch`` lifts all k digits at once (each digit residue is below
2^62, so ``% q`` over the K limbs of QP is exact in int64), runs one
stacked forward NTT over [k, ..., K, n], accumulates the key products
(reduced after every term, ``behz.key_products``), runs one stacked inverse
NTT and divides by P (``rescale.make_divide_round_last``). On a CUDA
context both transforms run the profile's NTT kernel (``ntt_cuda``: u32 on
m31, u64 on m62); the work between them is plain torch. The result is bit
for bit the reference's per-digit loop.

The secret over QP is the keygen's own ternary words lifted onto QP
(``KeyGenerator.secret_words``): the same coefficients on any basis, as the
reference resamples them from its PRNG key.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..ops import ntt
from ..ops.modmath import shoup_ints
from ..ops.primes import get_primes
from . import sampling
from .behz import key_products
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import KeyGenerator, from_reference_array, shoup
from .rescale import make_divide_round_last

__all__ = [
    "SPKeys",
    "build_ctx_qp",
    "create_sp_kswitch_keys",
    "make_sp_keys",
    "create_sp_relin_keys",
    "create_sp_galois_keys",
    "sp_keyswitch",
    "sp_relinearize",
    "apply_galois_sp",
    "sp_keys_from_reference",
]


@dataclass(eq=False)
class SPKeys:
    """Key-switching keys over QP toward a target secret T: k digit rows of
    NTT-domain (b_i, a_i), each [k, K, n] (K = k + 1), with their Shoup
    companions."""

    ctx_qp: BFVContext  # basis Q ∪ {P}; P is the last limb
    P: int
    k0: torch.Tensor
    k0_shoup: torch.Tensor
    k1: torch.Tensor
    k1_shoup: torch.Tensor


def build_ctx_qp(ctx: BFVContext) -> tuple[BFVContext, int]:
    """Q extended by one special prime P: the largest prime of the chain's
    profile (below 2^30 on m31, of 61 bits on m62) not already in Q, as
    SEAL reserves the largest prime for key switching. Returns the context
    over QP on ``ctx``'s device, and P."""
    bits = 30 if ctx.tables.profile == "m31" else 61
    used = {m.value for m in ctx.moduli}
    P = max(p for p in get_primes(bits, ctx.L + 4, ctx.n) if p not in used)
    parms = ctx.parms.with_coeff_modulus(tuple(m.value for m in ctx.moduli) + (P,))
    return BFVContext.build(parms, ctx.device), P


def _secret_coeff(keygen: KeyGenerator, ctx_qp: BFVContext) -> torch.Tensor:
    """The keygen's secret in the coefficient domain over QP."""
    return sampling.ternary_poly_from_bits(keygen.secret_words, ctx_qp)


def make_sp_keys(ctx_qp: BFVContext, P: int, k0: torch.Tensor, k1: torch.Tensor) -> SPKeys:
    """SPKeys from NTT-domain digit rows [k, K, n] over QP, with their
    Shoup companions."""
    k0, k1 = k0.contiguous(), k1.contiguous()
    return SPKeys(ctx_qp=ctx_qp, P=P, k0=k0, k0_shoup=shoup(ctx_qp, k0),
                  k1=k1, k1_shoup=shoup(ctx_qp, k1))


def create_sp_kswitch_keys(ctx: BFVContext, keygen: KeyGenerator, target_ntt_qp: torch.Tensor,
                           generator: torch.Generator | None = None,
                           qp: tuple[BFVContext, int] | None = None, words=None) -> SPKeys:
    """Keys toward a target T given in the NTT domain over QP [K, n].

    ``keygen`` holds the working secret's words. ``qp`` = (ctx_qp, P)
    reuses an extended context. The randomness is drawn from ``generator``,
    or given as ``words`` = (uniform words [k, 2|4, K, n], CBD words
    [k, 2, n]): per digit, the words the reference drew from the keys of
    its ``split(key, 3)``."""
    ctx_qp, P = qp if qp is not None else build_ctx_qp(ctx)
    p, q2, tb = ctx_qp.prof, ctx_qp.q2, ctx_qp.tables
    k, K, n, dev = ctx.L, ctx_qp.L, ctx.n, ctx.device
    if words is None:
        if generator is None:
            raise ValueError("special-prime keys need a generator or injected words")
        words = (sampling.words(generator, (k, p.uniform_words, K, n), dev),
                 sampling.words(generator, (k, 2, n), dev))
    a = sampling.uniform_rq_from_bits(words[0], ctx_qp)  # [k, K, n]
    e_ntt = ntt.forward(sampling.cbd_poly_from_bits(words[1], ctx_qp), tb)
    s_qp = ntt.forward(_secret_coeff(keygen, ctx_qp), tb)
    b = p.neg(p.add(p.mulmod_shoup(a, s_qp, shoup(ctx_qp, s_qp), q2), e_ntt, q2), q2)
    # + P g_i T: digit i's row carries (P mod q_i) T on limb i, 0 elsewhere.
    mods = [m.value for m in ctx_qp.moduli]
    gw, gws = shoup_ints([P if j == i else 0 for i in range(k) for j in range(K)],
                         mods * k, p.shoup_bits)
    col = lambda v: torch.tensor(v, dtype=torch.int64, device=dev).reshape(k, K, 1)  # noqa: E731
    b = p.add(b, p.mulmod_shoup(target_ntt_qp, col(gw), col(gws), q2), q2)
    return make_sp_keys(ctx_qp, P, b, a)


def create_sp_relin_keys(ctx: BFVContext, keygen: KeyGenerator,
                         generator: torch.Generator | None = None, words=None) -> SPKeys:
    """Relinearization keys: target T = s^2 over QP."""
    qp = build_ctx_qp(ctx)
    ctx_qp = qp[0]
    s_qp = ntt.forward(_secret_coeff(keygen, ctx_qp), ctx_qp.tables)
    s2 = ctx_qp.prof.mulmod_shoup(s_qp, s_qp, shoup(ctx_qp, s_qp), ctx_qp.q2)
    return create_sp_kswitch_keys(ctx, keygen, s2, generator, qp=qp, words=words)


def create_sp_galois_keys(ctx: BFVContext, keygen: KeyGenerator, g: int,
                          generator: torch.Generator | None = None, words=None) -> SPKeys:
    """Galois keys: target sigma_g(s) over QP."""
    from .galois import apply_galois_plain

    qp = build_ctx_qp(ctx)
    ctx_qp = qp[0]
    target = ntt.forward(apply_galois_plain(ctx_qp, _secret_coeff(keygen, ctx_qp), g),
                         ctx_qp.tables)
    return create_sp_kswitch_keys(ctx, keygen, target, generator, qp=qp, words=words)


@functools.lru_cache(maxsize=16)
def _divide_by(ctx: BFVContext, P: int, K: int):
    """The divide-by-P step, built once: building it copies its constants
    to the device."""
    return make_divide_round_last(ctx, P, K)


def sp_keyswitch(ctx: BFVContext, spk: SPKeys, poly: torch.Tensor):
    """poly [..., L, n] (coefficient domain over Q) -> (d0, d1), the switched
    contributions to (c0, c1), coefficient domain over Q."""
    ctx_qp = spk.ctx_qp
    tb = ctx_qp.tables
    # Digit i = |poly|_{q_i} lifted into every limb of QP: [k, ..., K, n]
    # (contiguous, as the NTT kernel takes it).
    lifted = poly.movedim(-2, 0).contiguous().unsqueeze(-2) % ctx_qp.q2
    acc = ntt.inverse(key_products(ctx_qp, ntt.forward(lifted, tb), spk), tb)
    d = _divide_by(ctx, spk.P, ctx_qp.L)(acc)
    return d[0], d[1]


def sp_relinearize(ctx: BFVContext, ct: Ciphertext, spk: SPKeys) -> Ciphertext:
    """Size 3 -> size 2 with a special-prime switch of c2."""
    if ct.size != 3 or ct.domain != "coeff":
        raise ValueError("sp_relinearize takes a size-3 coefficient-domain ciphertext")
    p, q2 = ctx.prof, ctx.q2
    c0, c1, c2 = ct.polys
    d0, d1 = sp_keyswitch(ctx, spk, c2)
    return Ciphertext((p.add(c0, d0, q2), p.add(c1, d1, q2)), "coeff")


def apply_galois_sp(ctx: BFVContext, ct: Ciphertext, g: int, spk: SPKeys) -> Ciphertext:
    """sigma_g and a special-prime switch back to s (``galois.apply_galois``
    dispatches on the key type)."""
    from .galois import apply_galois

    return apply_galois(ctx, ct, g, spk)


def sp_keys_from_reference(ctx: BFVContext, P: int, k0, k0_shoup, k1, k1_shoup,
                           perm=None) -> SPKeys:
    """The reference's SPKeys leaves ([k, K, n]: numpy u32 on m31, (lo, hi)
    pairs on m62) as the port's, over the port's own ``build_ctx_qp``;
    ``perm`` as in ``keys.from_reference_array``. All four leaves carry
    over, the Shoup companions with their values."""
    ctx_qp, P_qp = build_ctx_qp(ctx)
    if P_qp != P:
        raise ValueError(f"the reference's special prime {P} is not this chain's {P_qp}")
    put = lambda a: from_reference_array(ctx_qp, a, perm)  # noqa: E731
    return SPKeys(ctx_qp=ctx_qp, P=P, k0=put(k0), k0_shoup=put(k0_shoup), k1=put(k1),
                  k1_shoup=put(k1_shoup))
