"""CKKS core: canonical-embedding encoder, RLWE encrypt / add / multiply /
rescale / decrypt.

Counterpart of ``pplp_tpu.ckks.ckks``. Encoding runs on the host in float64
(as SEAL's CKKSEncoder runs on the CPU): a slot vector z in C^{n/2} is
evaluated and interpolated at the odd powers of the primitive 2n-th complex
root zeta,

    eval_k(m) = sum_j c_j zeta^{j(2k+1)},   k = 0..n-1,

with conjugate symmetry (slot j pairs with n-1-j) making the coefficients
real. Interpolation is an FFT with a zeta^j pre-twist; coefficients are
scaled by ``scale``, rounded, and reduced per limb on the device. The host
code is the reference's, so the integer coefficients are its own bit for bit.

The device side is the BFV machinery: keys (``bfv.keys``), sampling, the
NTT tables of the context's chain. A CKKS ciphertext is (c0, c1) with the
message in the low bits (no Delta; the scale lives in the encoding). On a
CUDA context the transforms run the NTT kernel; relinearization goes to
``bfv.keyswitch.sp_relinearize`` for special-prime keys and through
``FusedMultiplier`` (the relinearization kernel) for RNS-gadget keys.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..bfv import sampling
from ..bfv.ciphertext import Ciphertext
from ..bfv.context import BFVContext
from ..bfv.params import EncryptionParameters
from ..device import cuda_device
from ..ops import ntt
from ..ops.primes import get_primes

__all__ = ["CKKSContext", "CKKSEncoder", "ckks_encrypt", "ckks_encrypt_from_bits",
           "ckks_decrypt", "ckks_add", "ckks_create_relin_keys", "ckks_multiply",
           "ckks_rescale", "restrict_secret_key"]


@dataclass(frozen=True, eq=False)
class CKKSContext:
    """A BFVContext used for its RNS/NTT machinery, and a scale."""

    base: BFVContext
    scale: float

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def build(n=4096, scale=float(1 << 30), profile="tpu", coeff_modulus=None,
              device=None) -> "CKKSContext":
        """A context on ``device`` (the CUDA card unless given). The default
        chain is three 28-bit primes (~2^84): ample headroom for add-only
        aggregation at scale 2^30."""
        if coeff_modulus is None:
            coeff_modulus = get_primes(28, 3, n)
        # The plain modulus is unused by CKKS; a benign value passes validation.
        parms = EncryptionParameters.bfv(n, 1 << 20, coeff_modulus=coeff_modulus,
                                         profile=profile)
        return CKKSContext(base=BFVContext.build(parms, device or cuda_device()),
                           scale=float(scale))

    @property
    def n(self):
        return self.base.n

    @property
    def slots(self):
        return self.base.n // 2


class CKKSEncoder:
    def __init__(self, ctx: CKKSContext):
        self.ctx = ctx
        n = ctx.n
        j = np.arange(n)
        self._twist = np.exp(1j * np.pi * j / n)  # zeta^j

    def encode(self, values) -> np.ndarray:
        """Complex/real slot values [<= n/2] -> integer coefficient vector."""
        ctx = self.ctx
        n = ctx.n
        z = np.zeros(ctx.slots, np.complex128)
        values = np.asarray(values)
        z[: len(values)] = values
        evals = np.zeros(n, np.complex128)
        evals[: ctx.slots] = z
        evals[ctx.slots :] = np.conj(z[::-1])
        t = np.fft.fft(evals) / n  # interpolation: t_j = (1/n) sum E_k w^{-jk}
        coeffs = np.real(t / self._twist) * ctx.scale
        return np.round(coeffs).astype(np.int64)

    def decode(self, coeffs: np.ndarray):
        """Centered integer coefficients -> complex slot values [n/2]."""
        ctx = self.ctx
        t = (np.asarray(coeffs, np.float64) / ctx.scale) * self._twist
        evals = np.fft.ifft(t) * ctx.n
        return evals[: ctx.slots]

    def coeffs_to_rns(self, coeffs: np.ndarray) -> torch.Tensor:
        """Signed int64 coefficients [..., n] -> residues [..., L, n] on the
        device (``%`` takes the divisor's sign: exact and canonical)."""
        base = self.ctx.base
        x = torch.as_tensor(np.asarray(coeffs, dtype=np.int64), device=base.device)
        return x.unsqueeze(-2) % base.q2

    def rns_to_centered(self, residues: np.ndarray) -> list[int]:
        """Host [L, n] residues -> centered Python ints in (-q/2, q/2]."""
        ctx = self.ctx.base
        xs = ctx.crt_compose(np.asarray(residues, dtype=object))
        half = ctx.q // 2
        return [x - ctx.q if x > half else x for x in xs]


def ckks_encrypt_from_bits(ctx: CKKSContext, pk, m_rns: torch.Tensor, u_bits, e0_bits,
                           e1_bits) -> Ciphertext:
    """(c0, c1) = (pk0 u + e0 + m, pk1 u + e1) from the samplers' words
    (ternary [..., n], CBD [..., 2, n]): given the words the reference drew
    from its ``split(key, 3)``, its ciphertext."""
    base = ctx.base
    p, q2 = base.prof, base.q2
    u_ntt = ntt.forward(sampling.ternary_poly_from_bits(u_bits, base), base.tables)
    prods = torch.stack([p.mulmod_shoup(u_ntt, pk.pk0_ntt, pk.pk0_shoup, q2),
                         p.mulmod_shoup(u_ntt, pk.pk1_ntt, pk.pk1_shoup, q2)])
    c0, c1 = ntt.inverse(prods, base.tables)
    c0 = p.add(p.add(c0, sampling.cbd_poly_from_bits(e0_bits, base), q2), m_rns, q2)
    c1 = p.add(c1, sampling.cbd_poly_from_bits(e1_bits, base), q2)
    return Ciphertext((c0, c1), "coeff")


def ckks_encrypt(ctx: CKKSContext, pk, m_rns: torch.Tensor,
                 generator: torch.Generator) -> Ciphertext:
    """Encrypt residues [..., L, n]; a leading batch encrypts at once."""
    base = ctx.base
    batch = tuple(m_rns.shape[:-2])
    draw = lambda shape: sampling.words(generator, batch + shape, base.device)  # noqa: E731
    return ckks_encrypt_from_bits(ctx, pk, m_rns, draw((base.n,)), draw((2, base.n)),
                                  draw((2, base.n)))


def ckks_add(ctx: CKKSContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    p, q2 = ctx.base.prof, ctx.base.q2
    return Ciphertext(tuple(p.add(x, y, q2) for x, y in zip(a.polys, b.polys)), "coeff")


def ckks_create_relin_keys(ctx: CKKSContext, sk, generator: torch.Generator | None,
                           inject=None):
    """RNS-gadget relinearization keys for CKKS: always width 1 (one digit
    per limb). The BFV default width is chosen against the Delta/2 = q/2t
    headroom; CKKS has no Delta, and the key-switch error lands directly in
    the fixed-point message, so the smallest digit is the right one."""
    from ..bfv.behz import create_relin_keys

    return create_relin_keys(ctx.base, sk, generator, inject=inject, width=1)


def ckks_multiply(ctx: CKKSContext, a: Ciphertext, b: Ciphertext, rlk=None) -> Ciphertext:
    """ct x ct: the NTT tensor product mod q (no t/q scaling; the scale
    squares, follow with ``ckks_rescale``), relinearized when ``rlk`` is
    given: special-prime ``SPKeys`` (noise ~B, for multiplicative
    pipelines) or RNS-gadget ``KSwitchKeys`` (``ckks_create_relin_keys``)."""
    base = ctx.base
    p, q2, tb = base.prof, base.q2, base.tables
    a0, a1, b0, b1 = ntt.forward(torch.stack([*a.polys, *b.polys]), tb)
    e0 = ntt.pointwise_mul(a0, b0, tb)
    e2 = ntt.pointwise_mul(a1, b1, tb)
    cross = ntt.pointwise_mul(p.add(a0, a1, q2), p.add(b0, b1, q2), tb)
    e1 = p.sub(p.sub(cross, e0, q2), e2, q2)
    ct3 = Ciphertext(tuple(ntt.inverse(torch.stack([e0, e1, e2]), tb).unbind(0)), "coeff")
    if rlk is None:
        return ct3
    from ..bfv.behz_fused import FusedMultiplier
    from ..bfv.keyswitch import SPKeys, sp_relinearize

    if isinstance(rlk, SPKeys):
        return sp_relinearize(base, ct3, rlk)
    return FusedMultiplier(base, rlk).relinearize(ct3)


def ckks_rescale(ctx: CKKSContext, ct: Ciphertext,
                 current_scale: float | None = None) -> tuple[CKKSContext, Ciphertext]:
    """Drop the last prime: x -> round(x / q_last) (``mod_switch_to_next``).
    Returns the smaller context, with scale current_scale / q_last
    (``current_scale`` defaults to ctx.scale^2, the post-multiply case),
    and the rescaled ciphertext."""
    from ..bfv.evaluator import mod_switch_to_next

    q_last = ctx.base.moduli[-1].value
    new_base, new_ct = mod_switch_to_next(ctx.base, ct)
    scale = ctx.scale * ctx.scale if current_scale is None else current_scale
    return CKKSContext(base=new_base, scale=scale / q_last), new_ct


def restrict_secret_key(ctx_small: CKKSContext, sk):
    """A secret key on a rescaled (fewer-limb) context."""
    from ..bfv.evaluator import restrict_secret_key as _restrict

    return _restrict(ctx_small.base, sk)


def ckks_decrypt(ctx: CKKSContext, sk, ct: Ciphertext) -> np.ndarray:
    """Device product with s, host CRT and centring -> centered coefficients
    (object array [..., n])."""
    from ..bfv.decryptor import Decryptor

    residues = Decryptor(ctx.base, sk).ct_value_rns(ct).cpu().numpy()
    enc = CKKSEncoder(ctx)
    rows = residues.reshape((-1,) + residues.shape[-2:])
    out = np.array([enc.rns_to_centered(r) for r in rows], dtype=object)
    return out.reshape(residues.shape[:-2] + (ctx.n,))
