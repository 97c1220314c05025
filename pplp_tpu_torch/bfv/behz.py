"""Full-RNS BFV ciphertext multiplication (BEHZ) + relinearization, plain torch.

Counterpart of the m31 half of ``pplp_tpu.bfv.behz``:

  1. extend both ciphertexts from base Q to the auxiliary base B_sk by fast
     base conversion with the m_tilde = 2^16 Montgomery correction,
  2. tensor them in the NTT domain over Q and B_sk (Karatsuba),
  3. fast floor: w ~ floor(t * e / q), computed in B_sk,
  4. Shenoy-Kumaresan exact conversion B_sk -> Q.

Relinearization uses the RNS gadget g_j (= 1 mod the limbs of group j, 0
mod the others) with digits of one limb (width 1) or two (width 2, the
CRT composition of ``lift_digit_grouped``); the keys record their groups.

This is the plain version: every step is int64 torch arithmetic, and the
NTTs are ``ops.ntt.forward_plain``/``inverse_plain`` on any device, so the
NTT kernel never checks itself when the hand-written path
(``bfv.behz_fused``) is held against this one.

The fast base conversions are sums of products below 2^60 in int64 where
the reference accumulates 96-bit columns; the sum is reduced every seven
terms, so it stays below 2^63. The Karatsuba cross term multiplies
canonical sums (< 2q < 2^31), so its product stays below 2^62. The m62
profile (primes of 30 bits or more) waits for the ``seal`` slice: such a
context cannot be built (``ops.ntt.build_tables`` raises).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..ops import ntt
from ..ops.modmath import m31, shoup_ints
from ..ops.primes import Modulus, get_primes
from . import sampling
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import SecretKey, from_reference_array, shoup

__all__ = [
    "M_TILDE",
    "RnsMultiplier",
    "multiplier",
    "KSwitchKeys",
    "default_relin_width",
    "create_kswitch_keys",
    "create_relin_keys",
    "make_keys",
    "lift_digit_grouped",
    "keyswitch_contributions",
    "keyswitch_contributions_grouped",
    "relinearize",
    "relin_keys_from_reference",
]

M_TILDE_BITS = 16
M_TILDE = 1 << M_TILDE_BITS
_MASK16 = M_TILDE - 1
_TERMS_PER_REDUCE = 7  # 7 products below 2^60 plus a residue stay below 2^63


def _conv_ints(src_moduli, dst_moduli):
    """|prod(src) / src_i|_d as Python ints [D][S]."""
    prod = math.prod(m.value for m in src_moduli)
    return [[(prod // s.value) % d.value for s in src_moduli] for d in dst_moduli]


class RnsMultiplier:
    """BEHZ multiplier bound to one m31 BFVContext.

    Sizes B_sk and holds every integer constant as Python ints (the CUDA
    kernel packs them, ``ops.behz_cuda``) and as [K, 1] device columns."""

    def __init__(self, ctx: BFVContext):
        if ctx.tables.profile != "m31":
            raise NotImplementedError("the BEHZ multiply is ported for the m31 profile only")
        self.ctx = ctx
        n, t, k = ctx.n, ctx.t, ctx.L
        q = ctx.q
        qm = [m.value for m in ctx.moduli]

        # Size the auxiliary base: prod(B) > 2 n t q (the SK bound on
        # |w| ~ t e / q) with margin for the uncentered x_hat < 2q.
        need_bits = q.bit_length() + t.bit_length() + n.bit_length() + 6
        l = max(k + 1, (need_bits + 28) // 29)
        pool = [p for p in get_primes(30, l + k + 2, n) if p not in qm]
        b_values = pool[:l]
        msk = pool[l]
        self.l = l
        self.msk = msk
        self.bsk_moduli = tuple(Modulus(p) for p in b_values + [msk])
        self.bsk_tables = ntt.build_tables(self.bsk_moduli, n, ctx.device)
        M = math.prod(b_values)
        self.M = M
        bsk = self.bsk_moduli
        b_basis = bsk[:l]
        msk_mod = bsk[l:]

        # Python-int constants (what the kernel packs).
        self.mtilde_qhat_inv_ints = [(M_TILDE * pow(q // qi, -1, qi)) % qi for qi in qm]
        self.conv_q_to_bsk = _conv_ints(ctx.moduli, bsk)              # [K][L]
        self.conv_q_to_mtilde_ints = [(q // qi) % M_TILDE for qi in qm]
        self.neg_inv_q_mtilde = pow(-q, -1, M_TILDE)
        self.q_mod_bsk_ints = [q % m.value for m in bsk]
        self.inv_mtilde_bsk_ints = [pow(M_TILDE, -1, m.value) for m in bsk]
        self.t_mod_q_ints = [t % qi for qi in qm]
        self.t_mod_bsk_ints = [t % m.value for m in bsk]
        self.inv_q_bsk_ints = [pow(q % m.value, -1, m.value) for m in bsk]
        self.qhat_inv_ints = [pow(q // qi, -1, qi) for qi in qm]
        self.bhat_inv_b = [pow(M // p.value, -1, p.value) for p in b_basis]
        self.conv_b_to_q = _conv_ints(b_basis, ctx.moduli)           # [L][l]
        self.conv_b_to_msk = _conv_ints(b_basis, msk_mod)             # [1][l]
        self.inv_M_msk_int = pow(M % msk, -1, msk)
        self.M_mod_q_ints = [M % qi for qi in qm]
        self.mskM_mod_q_ints = [(msk * M) % qi for qi in qm]
        self.msk_half = msk // 2

        dev = ctx.device

        def col(vals):
            return torch.tensor([[int(v)] for v in vals], dtype=torch.int64, device=dev)

        def shoup_col(vals, moduli):
            w, ws = shoup_ints(vals, [m.value for m in moduli])
            return col(w), col(ws)

        def conv_cols(conv):  # [D][S] ints -> [S, D, 1]
            return torch.tensor(conv, dtype=torch.int64, device=dev).T.unsqueeze(-1).contiguous()

        self.conv_q_to_bsk_t = conv_cols(self.conv_q_to_bsk)
        self.conv_b_to_q_t = conv_cols(self.conv_b_to_q)
        self.conv_b_to_msk_t = conv_cols(self.conv_b_to_msk)
        self.q_col = ctx.q2
        self.bsk_col = col([m.value for m in bsk])
        self.b_col = self.bsk_col[:l]
        self.msk_col = self.bsk_col[l:]
        self.mtilde_qhat_inv = shoup_col(self.mtilde_qhat_inv_ints, ctx.moduli)
        self.q_mod_bsk = col(self.q_mod_bsk_ints)
        self.inv_mtilde_bsk = shoup_col(self.inv_mtilde_bsk_ints, bsk)
        self.t_mod_q = shoup_col(self.t_mod_q_ints, ctx.moduli)
        self.t_mod_bsk = shoup_col(self.t_mod_bsk_ints, bsk)
        self.inv_q_bsk = shoup_col(self.inv_q_bsk_ints, bsk)
        self.qhat_inv = shoup_col(self.qhat_inv_ints, ctx.moduli)
        self.bhat_inv = shoup_col(self.bhat_inv_b, b_basis)
        self.inv_M_msk = shoup_col([self.inv_M_msk_int], msk_mod)
        self.M_mod_q = shoup_col(self.M_mod_q_ints, ctx.moduli)
        self.mskM_mod_q = col(self.mskM_mod_q_ints)

    @property
    def K(self) -> int:
        """|B_sk| = l + 1."""
        return len(self.bsk_moduli)

    # ------------------------------------------------------------------

    def _accum(self, y: torch.Tensor, conv: torch.Tensor, dst_col: torch.Tensor) -> torch.Tensor:
        """sum_i y[..., i, :] * conv[i] mod dst_d -> [..., D, n].

        ``conv`` is [S, D, 1] (built in ``__init__``). y is canonical (< 2^30) and
        conv[i][d] < dst_d < 2^30, so each product is below 2^60; the sum
        is reduced every seven terms."""
        acc = None
        for i in range(conv.shape[0]):
            term = y[..., i : i + 1, :] * conv[i]
            acc = term if acc is None else acc + term
            if i % _TERMS_PER_REDUCE == _TERMS_PER_REDUCE - 1:
                acc = acc % dst_col
        return acc % dst_col

    def _to_bsk(self, x_q: torch.Tensor) -> torch.Tensor:
        """Base extension Q -> B_sk with the m_tilde Montgomery correction."""
        q2, bq = self.q_col, self.bsk_col
        y = m31.mulmod_shoup(x_q, *self.mtilde_qhat_inv, q2)
        x_bsk = self._accum(y, self.conv_q_to_bsk_t, bq)
        # The m_tilde component: arithmetic mod 2^16, masked after every step.
        acc = None
        for i, c in enumerate(self.conv_q_to_mtilde_ints):
            term = ((y[..., i, :] & _MASK16) * c) & _MASK16
            acc = term if acc is None else (acc + term) & _MASK16
        r = (acc * self.neg_inv_q_mtilde) & _MASK16
        corr = (self.q_mod_bsk * r.unsqueeze(-2)) % bq  # < 2^46
        x_bsk = m31.add(x_bsk, corr, bq)
        return m31.mulmod_shoup(x_bsk, *self.inv_mtilde_bsk, bq)

    def _fast_floor(self, e_q: torch.Tensor, e_bsk: torch.Tensor) -> torch.Tensor:
        """floor(t e / q) (with BEHZ-bounded error), in B_sk."""
        q2, bq = self.q_col, self.bsk_col
        te_q = m31.mulmod_shoup(e_q, *self.t_mod_q, q2)
        te_b = m31.mulmod_shoup(e_bsk, *self.t_mod_bsk, bq)
        y = m31.mulmod_shoup(te_q, *self.qhat_inv, q2)
        conv = self._accum(y, self.conv_q_to_bsk_t, bq)
        return m31.mulmod_shoup(m31.sub(te_b, conv, bq), *self.inv_q_bsk, bq)

    def _sk_to_q(self, w_bsk: torch.Tensor) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion B_sk -> Q."""
        l, q2, mskc = self.l, self.q_col, self.msk_col
        w_b = w_bsk[..., :l, :]
        w_msk = w_bsk[..., l : l + 1, :]
        y = m31.mulmod_shoup(w_b, *self.bhat_inv, self.b_col)
        conv_q = self._accum(y, self.conv_b_to_q_t, q2)
        conv_msk = self._accum(y, self.conv_b_to_msk_t, mskc)
        alpha = m31.mulmod_shoup(m31.sub(conv_msk, w_msk, mskc), *self.inv_M_msk, mskc)
        out = m31.sub(conv_q, m31.mulmod_shoup(alpha, *self.M_mod_q, q2), q2)
        # Where the centered alpha is negative, add msk * M back.
        corr = m31.add(out, self.mskM_mod_q, q2)
        return torch.where(alpha > self.msk_half, corr, out)

    # ------------------------------------------------------------------

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """BFV multiply: (c0, c1) x (d0, d1) -> size-3 ciphertext over Q."""
        _check_pair(ct1, ct2)
        tq, tb = self.ctx.tables, self.bsk_tables
        x = torch.stack([*ct1.polys, *ct2.polys])  # [4, ..., L, n]
        fq = ntt.forward_plain(x, tq)
        fb = ntt.forward_plain(self._to_bsk(x), tb)
        es = []
        for spec, tbx in ((fq, tq), (fb, tb)):
            qc = tbx.q_b(1)
            a0, a1, b0, b1 = spec
            e0 = m31.mulmod(a0, b0, qc)
            e2 = m31.mulmod(a1, b1, qc)
            # Karatsuba: e1 = (a0 + a1)(b0 + b1) - e0 - e2, canonical sums.
            cross = m31.mulmod(m31.add(a0, a1, qc), m31.add(b0, b1, qc), qc)
            e1 = m31.sub(m31.sub(cross, e0, qc), e2, qc)
            es.append(ntt.inverse_plain(torch.stack([e0, e1, e2]), tbx))
        out = self._sk_to_q(self._fast_floor(es[0], es[1]))
        return Ciphertext(tuple(out.unbind(0)), "coeff")


@functools.lru_cache(maxsize=8)
def multiplier(ctx: BFVContext) -> RnsMultiplier:
    """The RnsMultiplier of ``ctx``, built once (contexts are cached too)."""
    return RnsMultiplier(ctx)


def _check_pair(ct1: Ciphertext, ct2: Ciphertext):
    if ct1.size != 2 or ct2.size != 2:
        raise ValueError(f"multiply takes two size-2 ciphertexts, got {ct1.size} and {ct2.size}")
    if ct1.domain != "coeff" or ct2.domain != "coeff":
        raise ValueError("multiply takes coefficient-domain ciphertexts")


# ---------------------------------------------------------------------------
# Relinearization
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class KSwitchKeys:
    """RNS-gadget key-switching keys toward a target secret T, NTT domain:
    key[j] = (b_j, a_j), b_j = -(a_j s + e_j) + g_j T. T = s^2 gives
    relinearization keys. ``groups`` is the gadget's limb grouping (None:
    one digit per limb). k0/k1 and their Shoup companions are [D, L, n]."""

    k0: torch.Tensor
    k0_shoup: torch.Tensor
    k1: torch.Tensor
    k1_shoup: torch.Tensor
    groups: tuple | None = None

    def digit_groups(self, L: int) -> tuple:
        return self.groups if self.groups is not None else _digit_groups(L, 1)


def _digit_groups(k: int, width: int) -> tuple:
    """Consecutive limb groups: width 1 is the per-limb gadget, width 2
    pairs limbs (digit modulus q_i q_{i+1})."""
    return tuple(tuple(range(i, min(i + width, k))) for i in range(0, k, width))


def default_relin_width(ctx) -> int:
    """Noise-bounded gadget width for this context (BFV rule, capped at 2).

    Keyswitch noise ~ D n digit_max B_err must stay ``margin`` bits under
    Delta/2 = q / 2t. At the tpu n = 4096 chain this picks width 2."""
    margin_bits = 10
    b_err_bits = 7  # CBD bound (|e| <= 2 eta = 12 < 2^7) with headroom
    delta_half_bits = (ctx.q // ctx.t).bit_length() - 2
    best = 1
    for width in (2,):
        groups = _digit_groups(ctx.L, width)
        digit_bits = max(sum(ctx.moduli[i].value.bit_length() for i in g) for g in groups)
        noise_bits = (math.ceil(math.log2(len(groups))) + ctx.n.bit_length()
                      + digit_bits + b_err_bits)
        if noise_bits + margin_bits <= delta_half_bits:
            best = width
    return best


def create_kswitch_keys(ctx: BFVContext, sk: SecretKey, target_ntt: torch.Tensor,
                        generator: torch.Generator | None, inject=None,
                        groups=None) -> KSwitchKeys:
    """Keys toward ``target_ntt``. ``inject``: optional list of
    (a_coeff, e_coeff) residues [L, n] per digit, the known-answer hook;
    otherwise a (uniform, NTT domain) and e (CBD) come from ``generator``."""
    q2 = ctx.q2
    k = ctx.L
    groups = tuple(groups) if groups is not None else _digit_groups(k, 1)
    D = len(groups)
    if inject is not None:
        a = ntt.forward(torch.stack([a for a, _ in inject]), ctx.tables)
        e_ntt = ntt.forward(torch.stack([e for _, e in inject]), ctx.tables)
    else:
        a = sampling.uniform_rq(generator, ctx, (D,))
        e_ntt = ntt.forward(sampling.cbd_poly(generator, ctx, (D,)), ctx.tables)
    b = m31.neg(m31.add(m31.mulmod_shoup(a, sk.s_ntt, sk.s_shoup, q2), e_ntt, q2), q2)
    # + g_j T: only the group's limbs receive the target.
    sel = torch.zeros((D, k, 1), dtype=torch.int64, device=ctx.device)
    for j, group in enumerate(groups):
        sel[j, list(group)] = 1
    b = m31.add(b, target_ntt * sel, q2)
    return KSwitchKeys(k0=b, k0_shoup=shoup(ctx, b), k1=a, k1_shoup=shoup(ctx, a),
                       groups=groups)


def create_relin_keys(ctx: BFVContext, sk: SecretKey, generator: torch.Generator | None,
                      inject=None, width: int | None = None) -> KSwitchKeys:
    """Relinearization keys; ``width=None`` picks ``default_relin_width``,
    or 1 when ``inject`` (per-digit randomness) is given."""
    s2 = m31.mulmod_shoup(sk.s_ntt, sk.s_ntt, sk.s_shoup, ctx.q2)
    if width is None:
        width = 1 if inject is not None else default_relin_width(ctx)
    return create_kswitch_keys(ctx, sk, s2, generator, inject=inject,
                               groups=_digit_groups(ctx.L, width))


def make_keys(ctx: BFVContext, generator: torch.Generator) -> tuple[SecretKey, KSwitchKeys]:
    """(SecretKey, relinearization keys at the default width) in one call."""
    s_ntt = ntt.forward(sampling.ternary_poly(generator, ctx), ctx.tables)
    sk = SecretKey(s_ntt=s_ntt, s_shoup=shoup(ctx, s_ntt))
    return sk, create_relin_keys(ctx, sk, generator)


def lift_digit_grouped(ctx: BFVContext, poly: torch.Tensor, group) -> torch.Tensor:
    """Lift the gadget digit |poly| mod prod(q_i, i in group) into every limb.

    Width 1: the residue reduced mod each q_j. Width 2: CRT-compose
    x = r0 + q0 t with t = (r1 - r0) q0^-1 mod q1, then reduce x per limb as
    (r0 mod q_j) + (q0 mod q_j) t mod q_j."""
    q2 = ctx.q2
    if len(group) == 1:
        i = group[0]
        return poly[..., i : i + 1, :] % q2
    if len(group) != 2:
        raise NotImplementedError("digits wider than two limbs need Garner lifting")
    i0, i1 = group
    moduli = [m.value for m in ctx.moduli]
    q0, q1 = moduli[i0], moduli[i1]
    r0 = poly[..., i0 : i0 + 1, :]
    r1 = poly[..., i1 : i1 + 1, :]
    d = m31.sub(r1, r0 % q1, q1)
    inv01 = pow(q0, -1, q1)
    t = m31.mulmod_shoup(d, inv01, (inv01 << 32) // q1, q1)
    w, ws = shoup_ints([q0] * len(moduli), moduli)
    col = lambda v: torch.tensor(v, dtype=torch.int64, device=poly.device).reshape(-1, 1)  # noqa: E731
    return m31.add(r0 % q2, m31.mulmod_shoup(t, col(w), col(ws), q2), q2)


def keyswitch_contributions_grouped(ctx: BFVContext, poly: torch.Tensor,
                                    keys: KSwitchKeys, groups):
    """sum_j NTT(lift_j(poly)) * key[j] -> (d0, d1) in the coefficient domain;
    one forward NTT per digit (all digits in one stacked transform)."""
    q2 = ctx.q2
    lifted = torch.stack([lift_digit_grouped(ctx, poly, g) for g in groups])
    d_ntt = ntt.forward_plain(lifted, ctx.tables)  # [D, ..., L, n]
    lead = (len(groups),) + (1,) * (poly.dim() - 2) + tuple(poly.shape[-2:])

    def acc(key, key_s):
        t = m31.mulmod_shoup(d_ntt, key.reshape(lead), key_s.reshape(lead), q2)
        return t.sum(0) % q2  # D canonical terms: below 2^37

    return tuple(ntt.inverse_plain(torch.stack([acc(keys.k0, keys.k0_shoup),
                                                acc(keys.k1, keys.k1_shoup)]),
                                   ctx.tables).unbind(0))


def keyswitch_contributions(ctx: BFVContext, poly: torch.Tensor, keys: KSwitchKeys):
    """Per-limb digits: ``keyswitch_contributions_grouped`` at width 1."""
    return keyswitch_contributions_grouped(ctx, poly, keys, _digit_groups(ctx.L, 1))


def relinearize(ctx: BFVContext, ct: Ciphertext, rlk: KSwitchKeys) -> Ciphertext:
    """Size 3 -> size 2: key-switch c2 with the gadget the keys were built for."""
    if ct.size != 3 or ct.domain != "coeff":
        raise ValueError("relinearize takes a size-3 coefficient-domain ciphertext")
    q2 = ctx.q2
    c0, c1, c2 = ct.polys
    d0, d1 = keyswitch_contributions_grouped(ctx, c2, rlk, rlk.digit_groups(ctx.L))
    return Ciphertext((m31.add(c0, d0, q2), m31.add(c1, d1, q2)), "coeff")


def relin_keys_from_reference(ctx: BFVContext, k0, k0_shoup, k1, k1_shoup, groups,
                              perm=None) -> KSwitchKeys:
    """The reference's KSwitchKeys leaves (numpy [D, L, n]) as the port's.

    Stage-engine spectra carry over as they are; ``perm`` from
    ``ntt.order_permutation`` moves another engine's spectra into the
    port's order (see ``keys.keys_from_reference``)."""
    put = lambda a: from_reference_array(ctx, a, perm)  # noqa: E731
    return KSwitchKeys(k0=put(k0), k0_shoup=put(k0_shoup), k1=put(k1),
                       k1_shoup=put(k1_shoup),
                       groups=tuple(tuple(g) for g in groups) if groups is not None else None)
