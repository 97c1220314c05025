"""Full-RNS BFV ciphertext multiplication (BEHZ) + relinearization, plain torch.

Counterpart of ``pplp_tpu.bfv.behz`` on both residue profiles (m31: every
prime below 2^30; m62: every prime in [2^32, 2^62), the seal chains):

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

Every op goes through the context's arithmetic (``ctx.prof``, or the
B_sk tables' ``prof``), so the two profiles share the code; they differ in
the size of B_sk (primes of 30 bits on m31, 60 on m62, as the reference
sizes it), the width of the Shoup companions (32 or 64 bits) and the fast
base conversions (``_Conversion``):

* m31: sums of products below 2^60 in int64, where the reference
  accumulates 96-bit columns; the sum is reduced every seven terms, so it
  stays below 2^63;
* m62: each product of a residue and a constant reaches 2^124, so a sum is
  kept exactly as four 32-bit word columns (the reference accumulates 160
  bits) and reduced once by ``ctx.prof.reduce_words``. A 128-bit sum holds
  floor((2^128 - 1) / ((q_src - 1)(q_dst - 1))) terms at the chain's largest
  moduli; on the seal chains every sum fits one (the widest, n = 32768, is
  below 2^121: 16 products of a 56-bit residue and a 60-bit constant, or 17
  of a 60-bit and a 56-bit), and a longer sum is reduced in parts.

The Karatsuba cross term multiplies canonical sums (< q), so on m31 its
product stays below 2^60 and on m62 it is a general 128-bit product.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..ops import ntt
from ..ops.modmath import M32, m31, m62, mul32, shoup_ints
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
    "key_products",
    "keyswitch_contributions",
    "keyswitch_contributions_grouped",
    "relinearize",
    "relin_keys_from_reference",
]

M_TILDE_BITS = 16
M_TILDE = 1 << M_TILDE_BITS
_MASK16 = M_TILDE - 1
_TERMS_PER_REDUCE = 7  # m31: 7 products below 2^60 plus a residue stay below 2^63


def _conv_ints(src_moduli, dst_moduli):
    """|prod(src) / src_i|_d as Python ints [D][S]."""
    prod = math.prod(m.value for m in src_moduli)
    return [[(prod // s.value) % d.value for s in src_moduli] for d in dst_moduli]


def _sub_prof(tables: ntt.NttTables, limbs: slice):
    """The arithmetic of some limbs of ``tables`` (m62: their ratio words)."""
    if tables.profile == "m31":
        return m31
    return m62(tuple(r[limbs] for r in tables.mu_b(1)))


def _sum_words(y: torch.Tensor, table: torch.Tensor, lo: int, hi: int) -> list:
    """sum_{lo <= i < hi} y[..., i, :] * table[i] as four little-endian
    32-bit words, exact while the sum stays below 2^128: every 32 x 32-bit
    partial product goes into its word column (a column sums at most
    3 (hi - lo) words below 2^32), and the carries propagate once."""
    cols = [0, 0, 0, 0]
    for i in range(lo, hi):
        yi = y[..., i : i + 1, :]
        a = (yi & M32, yi >> 32)
        b = (table[i] & M32, table[i] >> 32)
        for u in range(2):
            for v in range(2):
                plo, phi = mul32(a[u], b[v])
                cols[u + v] = cols[u + v] + plo
                cols[u + v + 1] = cols[u + v + 1] + phi
    out, carry = [], 0
    for c in cols:
        v = c + carry
        out.append(v & M32)
        carry = v >> 32
    return out


@dataclass(frozen=True, eq=False)
class _Conversion:
    """A fast base conversion sum_i y[..., i, :] conv[d][i] mod dst_d of
    canonical residues y over a source base: ``table`` [S, D, 1], the
    destination's moduli column [D, 1] and arithmetic, and the terms one
    exact sum holds (``terms``)."""

    table: torch.Tensor
    dst: torch.Tensor
    prof: object
    terms: int

    @classmethod
    def build(cls, conv, src_moduli, dst_col, prof, device):
        """``conv``: Python ints [D][S] (``_conv_ints``)."""
        table = torch.tensor(conv, dtype=torch.int64, device=device).T.unsqueeze(-1).contiguous()
        if prof is m31:
            terms = _TERMS_PER_REDUCE
        else:  # the largest product: a residue of the source times a constant
            most = (max(m.value for m in src_moduli) - 1) * max(max(row) for row in conv)
            terms = max(1, ((1 << 128) - 1) // max(most, 1))
        return cls(table, dst_col, prof, terms)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """[..., S, n] -> [..., D, n]."""
        S = self.table.shape[0]
        if self.prof is m31:
            acc = None
            for i in range(S):
                term = y[..., i : i + 1, :] * self.table[i]
                acc = term if acc is None else acc + term
                if i % self.terms == self.terms - 1:
                    acc = acc % self.dst
            return acc % self.dst
        out = None
        for lo in range(0, S, self.terms):
            part = self.prof.reduce_words(_sum_words(y, self.table, lo, min(S, lo + self.terms)),
                                          self.dst)
            out = part if out is None else self.prof.add(out, part, self.dst)
        return out


class RnsMultiplier:
    """BEHZ multiplier bound to one BFVContext (either profile).

    Sizes B_sk and holds every integer constant as Python ints (the CUDA
    kernels pack them, ``ops.behz_cuda`` and ``ops.behz64_cuda``) and as
    [K, 1] device columns."""

    def __init__(self, ctx: BFVContext):
        self.ctx = ctx
        n, t, k = ctx.n, ctx.t, ctx.L
        q = ctx.q
        qm = [m.value for m in ctx.moduli]

        # Size the auxiliary base: prod(B) > 2 n t q (the SK bound on
        # |w| ~ t e / q) with margin for the uncentered x_hat < 2q; its
        # primes have 30 bits on m31 and 60 on m62, as in the reference.
        need_bits = q.bit_length() + t.bit_length() + n.bit_length() + 6
        p_bits, p_cap = (30, 29) if ctx.tables.profile == "m31" else (60, 59)
        l = max(k + 1, -(-need_bits // p_cap))
        pool = [p for p in get_primes(p_bits, l + k + 2, n) if p not in qm]
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
        self.q_prof = ctx.prof
        self.bsk_prof = self.bsk_tables.prof
        self.msk_prof = _sub_prof(self.bsk_tables, slice(l, l + 1))
        bits = self.q_prof.shoup_bits

        def col(vals):
            return torch.tensor([[int(v)] for v in vals], dtype=torch.int64, device=dev)

        def shoup_col(vals, moduli):
            w, ws = shoup_ints(vals, [m.value for m in moduli], bits)
            return col(w), col(ws)

        self.q_col = ctx.q2
        self.bsk_col = col([m.value for m in bsk])
        self.b_col = self.bsk_col[:l]
        self.msk_col = self.bsk_col[l:]
        self.conv_q_to_bsk_t = _Conversion.build(self.conv_q_to_bsk, ctx.moduli, self.bsk_col,
                                                 self.bsk_prof, dev)
        self.conv_b_to_q_t = _Conversion.build(self.conv_b_to_q, b_basis, self.q_col,
                                               self.q_prof, dev)
        self.conv_b_to_msk_t = _Conversion.build(self.conv_b_to_msk, b_basis, self.msk_col,
                                                 self.msk_prof, dev)
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

    def _to_bsk(self, x_q: torch.Tensor) -> torch.Tensor:
        """Base extension Q -> B_sk with the m_tilde Montgomery correction."""
        q2, bq, pq, pb = self.q_col, self.bsk_col, self.q_prof, self.bsk_prof
        y = pq.mulmod_shoup(x_q, *self.mtilde_qhat_inv, q2)
        x_bsk = self.conv_q_to_bsk_t(y)
        # The m_tilde component: arithmetic mod 2^16 on the low 16 bits,
        # masked after every step.
        acc = None
        for i, c in enumerate(self.conv_q_to_mtilde_ints):
            term = ((y[..., i, :] & _MASK16) * c) & _MASK16
            acc = term if acc is None else (acc + term) & _MASK16
        r = (acc * self.neg_inv_q_mtilde) & _MASK16
        # (q mod b_d) r: below 2^46 on m31, 2^76 on m62 (a general product).
        corr = pb.mulmod(self.q_mod_bsk, r.unsqueeze(-2), bq)
        x_bsk = pb.add(x_bsk, corr, bq)
        return pb.mulmod_shoup(x_bsk, *self.inv_mtilde_bsk, bq)

    def _fast_floor(self, e_q: torch.Tensor, e_bsk: torch.Tensor) -> torch.Tensor:
        """floor(t e / q) (with BEHZ-bounded error), in B_sk."""
        q2, bq, pq, pb = self.q_col, self.bsk_col, self.q_prof, self.bsk_prof
        te_q = pq.mulmod_shoup(e_q, *self.t_mod_q, q2)
        te_b = pb.mulmod_shoup(e_bsk, *self.t_mod_bsk, bq)
        y = pq.mulmod_shoup(te_q, *self.qhat_inv, q2)
        conv = self.conv_q_to_bsk_t(y)
        return pb.mulmod_shoup(pb.sub(te_b, conv, bq), *self.inv_q_bsk, bq)

    def _sk_to_q(self, w_bsk: torch.Tensor) -> torch.Tensor:
        """Shenoy-Kumaresan exact conversion B_sk -> Q."""
        l, q2, mskc, pq, pm = self.l, self.q_col, self.msk_col, self.q_prof, self.msk_prof
        w_b = w_bsk[..., :l, :]
        w_msk = w_bsk[..., l : l + 1, :]
        y = self.bsk_prof.mulmod_shoup(w_b, *self.bhat_inv, self.b_col)
        conv_q = self.conv_b_to_q_t(y)
        conv_msk = self.conv_b_to_msk_t(y)
        alpha = pm.mulmod_shoup(pm.sub(conv_msk, w_msk, mskc), *self.inv_M_msk, mskc)
        out = pq.sub(conv_q, pq.mulmod_shoup(alpha, *self.M_mod_q, q2), q2)
        # Where the centered alpha is negative, add msk * M back (alpha < msk
        # < 2^62: a plain int64 compare on either profile).
        corr = pq.add(out, self.mskM_mod_q, q2)
        return torch.where(alpha > self.msk_half, corr, out)

    # ------------------------------------------------------------------

    @staticmethod
    def tensor_spectra(spec: torch.Tensor, tbx) -> torch.Tensor:
        """Karatsuba tensor product of spectra [4, ..., Lx, n] (a0, a1, b0,
        b1) over one base's tables -> [3, ..., Lx, n] (e0, e1, e2)."""
        qc, p = tbx.q_b(1), tbx.prof
        a0, a1, b0, b1 = spec
        e0 = p.mulmod(a0, b0, qc)
        e2 = p.mulmod(a1, b1, qc)
        # Karatsuba: e1 = (a0 + a1)(b0 + b1) - e0 - e2, canonical sums.
        cross = p.mulmod(p.add(a0, a1, qc), p.add(b0, b1, qc), qc)
        return torch.stack([e0, p.sub(p.sub(cross, e0, qc), e2, qc), e2])

    def tensor_products(self, x: torch.Tensor, x_bsk: torch.Tensor):
        """The coefficient-domain tensor products of the four inputs over Q
        (x [4, ..., L, n]) and over B_sk (x_bsk [4, ..., K, n])."""
        return tuple(ntt.inverse_plain(self.tensor_spectra(ntt.forward_plain(src, tbx), tbx), tbx)
                     for src, tbx in ((x, self.ctx.tables), (x_bsk, self.bsk_tables)))

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """BFV multiply: (c0, c1) x (d0, d1) -> size-3 ciphertext over Q."""
        _check_pair(ct1, ct2)
        x = torch.stack([*ct1.polys, *ct2.polys])  # [4, ..., L, n]
        e_q, e_bsk = self.tensor_products(x, self._to_bsk(x))
        out = self._sk_to_q(self._fast_floor(e_q, e_bsk))
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
    p, q2 = ctx.prof, ctx.q2
    k = ctx.L
    groups = tuple(groups) if groups is not None else _digit_groups(k, 1)
    D = len(groups)
    if inject is not None:
        a = ntt.forward(torch.stack([a for a, _ in inject]), ctx.tables)
        e_ntt = ntt.forward(torch.stack([e for _, e in inject]), ctx.tables)
    else:
        a = sampling.uniform_rq(generator, ctx, (D,))
        e_ntt = ntt.forward(sampling.cbd_poly(generator, ctx, (D,)), ctx.tables)
    b = p.neg(p.add(p.mulmod_shoup(a, sk.s_ntt, sk.s_shoup, q2), e_ntt, q2), q2)
    # + g_j T: only the group's limbs receive the target.
    sel = torch.zeros((D, k, 1), dtype=torch.int64, device=ctx.device)
    for j, group in enumerate(groups):
        sel[j, list(group)] = 1
    b = p.add(b, target_ntt * sel, q2)
    return KSwitchKeys(k0=b, k0_shoup=shoup(ctx, b), k1=a, k1_shoup=shoup(ctx, a),
                       groups=groups)


def create_relin_keys(ctx: BFVContext, sk: SecretKey, generator: torch.Generator | None,
                      inject=None, width: int | None = None) -> KSwitchKeys:
    """Relinearization keys; ``width=None`` picks ``default_relin_width``,
    or 1 when ``inject`` (per-digit randomness) is given."""
    s2 = ctx.prof.mulmod_shoup(sk.s_ntt, sk.s_ntt, sk.s_shoup, ctx.q2)
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
    (r0 mod q_j) + (q0 mod q_j) t mod q_j. Residues are below 2^62, so the
    reductions ``% q`` are exact in int64 on both profiles; the products
    go through Shoup companions of the profile's width."""
    p, q2 = ctx.prof, ctx.q2
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
    col = lambda v: torch.tensor(v, dtype=torch.int64, device=poly.device).reshape(-1, 1)  # noqa: E731
    q1c = col([q1])
    d = p.sub(r1, r0 % q1c, q1c)
    inv, inv_s = shoup_ints([pow(q0, -1, q1)], [q1], p.shoup_bits)
    t = p.mulmod_shoup(d, col(inv), col(inv_s), q1c)
    w, ws = shoup_ints([q0] * len(moduli), moduli, p.shoup_bits)
    return p.add(r0 % q2, p.mulmod_shoup(t, col(w), col(ws), q2), q2)


def key_products(ctx: BFVContext, d_ntt: torch.Tensor, keys: KSwitchKeys) -> torch.Tensor:
    """sum_j d_ntt[j] * (k0[j], k1[j]) mod q of digit spectra [D, ..., L, n]
    -> spectra [2, ..., L, n]. The sum is reduced after every term: two m62
    residues already come near 2^63."""
    p, q2 = ctx.prof, ctx.q2
    lead = (d_ntt.shape[0],) + (1,) * (d_ntt.dim() - 3) + tuple(d_ntt.shape[-2:])

    def acc(key, key_s):
        t = p.mulmod_shoup(d_ntt, key.reshape(lead), key_s.reshape(lead), q2)
        out = t[0]
        for j in range(1, t.shape[0]):
            out = p.add(out, t[j], q2)
        return out

    return torch.stack([acc(keys.k0, keys.k0_shoup), acc(keys.k1, keys.k1_shoup)])


def keyswitch_contributions_grouped(ctx: BFVContext, poly: torch.Tensor,
                                    keys: KSwitchKeys, groups):
    """sum_j NTT(lift_j(poly)) * key[j] -> (d0, d1) in the coefficient domain;
    one forward NTT per digit (all digits in one stacked transform)."""
    lifted = torch.stack([lift_digit_grouped(ctx, poly, g) for g in groups])
    d_ntt = ntt.forward_plain(lifted, ctx.tables)  # [D, ..., L, n]
    return tuple(ntt.inverse_plain(key_products(ctx, d_ntt, keys), ctx.tables).unbind(0))


def keyswitch_contributions(ctx: BFVContext, poly: torch.Tensor, keys: KSwitchKeys):
    """Per-limb digits: ``keyswitch_contributions_grouped`` at width 1."""
    return keyswitch_contributions_grouped(ctx, poly, keys, _digit_groups(ctx.L, 1))


def relinearize(ctx: BFVContext, ct: Ciphertext, rlk: KSwitchKeys) -> Ciphertext:
    """Size 3 -> size 2: key-switch c2 with the gadget the keys were built for."""
    if ct.size != 3 or ct.domain != "coeff":
        raise ValueError("relinearize takes a size-3 coefficient-domain ciphertext")
    p, q2 = ctx.prof, ctx.q2
    c0, c1, c2 = ct.polys
    d0, d1 = keyswitch_contributions_grouped(ctx, c2, rlk, rlk.digit_groups(ctx.L))
    return Ciphertext((p.add(c0, d0, q2), p.add(c1, d1, q2)), "coeff")


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
