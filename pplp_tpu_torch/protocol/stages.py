"""Protocol stages as torch functions on one BFV context.

Counterpart of ``pplp_tpu.protocol.jitted``. PyTorch runs eagerly, so there
is nothing to trace; each stage batches its transforms so one NTT launch
covers a stage's polynomials where the reference traced one graph.
Randomness comes from a ``torch.Generator`` or is injected as numpy arrays
(signed small polynomials [..., n], residues [L, n]).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bfv import sampling
from ..bfv.ciphertext import Ciphertext
from ..bfv.context import BFVContext
from ..bfv.decryptor import Decryptor
from ..bfv.encryptor import Encryptor
from ..bfv.evaluator import Evaluator
from ..bfv.keys import KeyGenerator, PublicKey, SecretKey, make_keys
from ..bfv.plaintext import Plaintext
from ..ops import ntt
from ..utils.hexcodec import uint64_to_hex_string

__all__ = ["keygen", "keygen_injected", "encrypt_batch", "blind_distance",
           "ct_value", "plain_pair"]


def keygen(ctx: BFVContext, generator: torch.Generator) -> tuple[SecretKey, PublicKey]:
    """Ternary secret s, uniform a (NTT domain), CBD noise e -> (sk, pk)."""
    kg = KeyGenerator(ctx, generator)
    return kg.secret_key(), kg.create_public_key()


def keygen_injected(ctx: BFVContext, s, a_ntt, e) -> tuple[SecretKey, PublicKey]:
    """Keys from injected numpy randomness: signed s, e [n]; a_ntt [L, n]."""
    a = torch.as_tensor(np.asarray(a_ntt, dtype=np.int64), device=ctx.device)
    return make_keys(ctx, sampling.lift_signed(s, ctx), a, sampling.lift_signed(e, ctx))


def encrypt_batch(ctx: BFVContext, pk: PublicKey, m_lo, m_hi,
                  generator: torch.Generator | None = None, inject=None) -> Ciphertext:
    """Encrypt a batch of host plaintext pairs [B, n] -> polys [B, L, n].

    ``inject``: per message (u, e0, e1) signed numpy arrays [n]; otherwise
    ``generator`` draws them."""
    enc = Encryptor(ctx, pk)
    if inject is None:
        return enc.encrypt_pairs(m_lo, m_hi, generator)
    u, e0, e1 = (sampling.lift_signed(np.stack(v), ctx) for v in zip(*inject))
    return enc.assemble(m_lo, m_hi, u, e0, e1)


def blind_distance(ctx: BFVContext, c1: Ciphertext, c2: Ciphertext, c3: Ciphertext,
                   z, xb, yb, s, sr) -> Ciphertext:
    """s*(c1 + z - (c2*xb + c3*yb)) + s*r, the homomorphic blind distance.

    Plaintext operands are host (lo, hi) pairs. The six ciphertext
    polynomials transform in one stacked NTT, the three plaintext spectra in
    another, the result comes back in one inverse."""
    ev = Evaluator(ctx)
    c1 = ev.add_plain(c1, z)
    spec = ntt.forward(torch.stack(c1.polys + c2.polys + c3.polys), ctx.tables)
    c1s = Ciphertext((spec[0], spec[1]), "ntt")
    c2s = Ciphertext((spec[2], spec[3]), "ntt")
    c3s = Ciphertext((spec[4], spec[5]), "ntt")
    lo = np.stack([xb[0], yb[0], s[0]])
    hi = np.stack([xb[1], yb[1], s[1]])
    m_ntt, m_shoup = ev.plain_spectrum((lo, hi))
    xb_s, yb_s, s_s = ((m_ntt[i], m_shoup[i]) for i in range(3))
    acc = ev.sub(c1s, ev.add(ev.multiply_plain_ntt(c2s, xb_s),
                             ev.multiply_plain_ntt(c3s, yb_s)))
    out = ev.from_ntt(ev.multiply_plain_ntt(acc, s_s))
    return ev.add_plain(out, sr)


def ct_value(ctx: BFVContext, sk: SecretKey, ct: Ciphertext) -> torch.Tensor:
    """Residues of c0 + c1*s mod q."""
    return Decryptor(ctx, sk).ct_value_rns(ct)


def plain_pair(value: int, t: int, n: int):
    """Hex-encoded plaintext (lo, hi) u32 host arrays for ``value`` mod t."""
    return Plaintext(uint64_to_hex_string(value % t), n=n).pair_u32(n)
