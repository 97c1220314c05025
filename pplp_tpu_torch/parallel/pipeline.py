"""Batched proximity pipeline: the server's evaluation and the client's
decryption for a batch of checks, as one device step.

Counterpart of ``pplp_tpu.parallel.pipeline`` (BASELINE config[3]: 100k
encrypted distance + radius checks). For B independent queries, or B*n
coefficient-packed ones, the step runs

    bd_ct = s*(c1 + z - xb*c2 - yb*c3) + s*r          (ct x plain ops)
    x     = bd_ct.c0 + bd_ct.c1 * sk                  (decrypt, device part)

then, packed, the device BEHZ decode (``bfv.rns_decrypt``), the blinded key
(bd << w_len) | w and the Bloom probe. Inputs and outputs are [B, L, n]
int64 residue tensors on the context's device.

All of it is exact ring arithmetic and the NTT is a ring isomorphism, so
the step transforms the six ciphertext polynomials in one forward NTT,
combines them with the plaintext spectra and the secret key in the NTT
domain, and returns through one inverse NTT: the same residues as the
reference's op-by-op chain, bit for bit. ``make_packed_inputs`` encrypts
the three messages of every query in one batched encryption (one NTT launch
per direction). Not ported: meshes, shardings and multi-device runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bfv import Evaluator, Plaintext
from ..bfv.encryptor import Encryptor
from ..bfv.rns_decrypt import get_decoder
from ..ops import ntt
from ..ops.modmath import M32
from ..primitives.bloom import BloomFilter, BloomParameters, probe
from ..utils.hexcodec import uint64_to_hex_string

__all__ = [
    "build_batched_pipeline",
    "build_packed_pipeline",
    "build_packed_pipeline_bf",
    "blinded_keys",
    "bf_probe",
    "build_pipeline_filter",
    "make_batch_inputs",
    "make_packed_inputs",
]


def _split(m: np.ndarray):
    """uint64 host values -> (lo, hi) u32 host arrays."""
    return ((m & np.uint64(M32)).astype(np.uint32),
            (m >> np.uint64(32)).astype(np.uint32))


def _plain_pairs(ctx, value: int, full: bool = False):
    """Constant-poly pairs; full=True replicates the value in every
    coefficient (for coefficient-packed batches, where additive terms must
    reach every slot)."""
    if full:
        return _split(np.full(ctx.n, value % ctx.t, np.uint64))
    return Plaintext(uint64_to_hex_string(value % ctx.t), n=ctx.n).pair_u32(ctx.n)


def build_batched_pipeline(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int,
                           packed: bool = False):
    """Returns fn(c1_polys, c2_polys, c3_polys) -> residues [B, L, n] of the
    decrypted blind distance, x = c0 + c1 s.

    Ciphertext arguments are the (c0, c1) pairs of coefficient-domain
    ciphertexts with [B, L, n] polynomials. packed=True makes the additive
    terms (z, s*r) reach every coefficient slot."""
    p, q2, tb = ctx.prof, ctx.q2, ctx.tables
    z = ctx.scale_plain(*_plain_pairs(ctx, xb * xb + yb * yb, full=packed))
    sr = ctx.scale_plain(*_plain_pairs(ctx, s_blind * r_blind, full=packed))
    pairs = [_plain_pairs(ctx, v) for v in (xb, yb, s_blind)]
    m_ntt, m_shoup = Evaluator(ctx).plain_spectrum(
        (np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])))

    def times(x, i):  # x * (xb, yb, s)[i] in the NTT domain
        return p.mulmod_shoup(x, m_ntt[i], m_shoup[i], q2)

    def step(c1_polys, c2_polys, c3_polys):
        c1_0 = p.add(c1_polys[0], z, q2)
        spec = ntt.forward(torch.stack([c1_0, c1_polys[1], *c2_polys, *c3_polys]), tb)
        acc0 = p.sub(spec[0], p.add(times(spec[2], 0), times(spec[4], 1), q2), q2)
        acc1 = p.sub(spec[1], p.add(times(spec[3], 0), times(spec[5], 1), q2), q2)
        # s*acc0 + (s*acc1) * sk, back to coefficients once, plus s*r.
        val = p.add(times(acc0, 2),
                    p.mulmod_shoup(times(acc1, 2), sk.s_ntt, sk.s_shoup, q2), q2)
        return p.add(ntt.inverse(val, tb), sr, q2)

    return step


def build_packed_pipeline(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int):
    """Coefficient-packed pipeline: n proximity checks per ciphertext row.

    Every coefficient j of the plaintext carries one client's (u_j, 2xa_j,
    2ya_j); the server's ops are scalar plain multiplies and adds, which act
    coefficient-wise, so one [B, L, n] ciphertext batch evaluates B*n
    independent checks. Returns fn(c1, c2, c3 polys) -> blind distances
    [B, n] mod t (device decode; requires t < 2^30)."""
    step = build_batched_pipeline(ctx, sk, xb, yb, s_blind, r_blind, packed=True)
    decoder = get_decoder(ctx)

    def packed(c1_polys, c2_polys, c3_polys):
        return decoder.decode_mod_t(step(c1_polys, c2_polys, c3_polys))

    return packed


def blinded_keys(bd: torch.Tensor, w: int, w_len: int):
    """key = (bd << w_len) | w for blind distances bd < 2^32, as (lo, hi)
    32-bit words (w < 2^w_len, 0 < w_len < 32)."""
    if not 0 < w_len < 32:
        raise ValueError(f"w_len must be in (0, 32), got {w_len}")
    return ((bd << w_len) | w) & M32, bd >> (32 - w_len)


def bf_probe(bd: torch.Tensor, w: int, w_len: int, bits: torch.Tensor,
             salts: torch.Tensor, table_size: int, mixed: bool = True) -> torch.Tensor:
    """Bloom membership of the blinded keys of ``bd`` [...] -> bool [...]:
    the AP hash of every key against every salt, then one gather on the
    unpacked bit table."""
    klo, khi = blinded_keys(bd, w, w_len)
    return probe(bits, klo.reshape(-1), khi.reshape(-1), salts, table_size,
                 mixed).reshape(bd.shape)


def build_pipeline_filter(t: int, s_blind: int, r_blind: int, w: int,
                          device) -> BloomFilter:
    """The server's filter for the pipeline: the r^2 blinded keys
    ((s (di + r) mod t) << w_len) | w for di < r^2, w_len = bitlen(w) (the
    sound mod-t reduction of the blind distance), inserted on ``device``.
    fpp 1e-4 in ``mixed`` index mode, as BASELINE config[3] builds it
    (``bench.py:195-234``)."""
    p = BloomParameters(projected_element_count=r_blind * r_blind,
                        false_positive_probability=1e-4,
                        random_seed=0xA5A5A5A5, index_mode="mixed")
    if not p.compute_optimal_parameters():
        raise ValueError("no Bloom filter parameters for these settings")
    bf = BloomFilter(p, device)
    di = torch.arange(r_blind * r_blind, dtype=torch.int64, device=device)
    bf.insert_u64_batch(*blinded_keys(s_blind * (di + r_blind) % t, w, w.bit_length()))
    return bf


def build_packed_pipeline_bf(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int,
                             w: int, w_len: int, mixed: bool = True):
    """The whole BASELINE config[3] step: homomorphic evaluation, device
    decode, blinded-key formation and the Bloom probe.

    The reference ends every proximity check with ``bf.contains((bd << w_len)
    | w)`` (``pplp:src/demo.cc:171-177``). Returns
    ``fn(c1_polys, c2_polys, c3_polys, bits, salts, table_size) -> bool [B, n]``
    where ``bits``/``salts``/``table_size`` are a ``BloomFilter``'s
    ``bits_device``, ``_salts_device()`` and ``table_size``. Requires
    t < 2^30 and 0 < w_len < 32."""
    if not 0 < w_len < 32:
        raise ValueError(f"w_len must be in (0, 32), got {w_len}")
    step = build_packed_pipeline(ctx, sk, xb, yb, s_blind, r_blind)

    def fn(c1_polys, c2_polys, c3_polys, bits, salts, table_size):
        bd = step(c1_polys, c2_polys, c3_polys)
        return bf_probe(bd, w, w_len, bits, salts, table_size, mixed)

    return fn


def _encrypt3(encryptor: Encryptor, m: np.ndarray, generator, words):
    """Encrypt three message batches m [3, B, n] (uint64) in one pass ->
    the three (c0, c1) pairs with [B, L, n] polynomials.

    ``words``: (ternary words [3, B, n], CBD words [3, B, 2, n] twice) for
    the samplers' ``*_from_bits`` forms; else ``generator`` draws them."""
    lo, hi = _split(m)
    if words is None:
        ct = encryptor.encrypt_pairs(lo, hi, generator)
    else:
        ct = encryptor.encrypt_pairs_from_bits(lo, hi, *words)
    c0, c1 = ct.polys
    return tuple((c0[i], c1[i]) for i in range(3))


def make_packed_inputs(ctx, encryptor: Encryptor, xa, ya,
                       generator: torch.Generator | None = None, words=None):
    """Encrypt N = B*n client coordinate pairs packed into coefficients.

    xa, ya: uint arrays [N] with N a multiple of n. Returns the three
    ciphertexts' (c0, c1) pairs with [B, L, n] polynomials."""
    xa = np.asarray(xa, np.uint64)
    ya = np.asarray(ya, np.uint64)
    n = ctx.n
    if xa.size % n:
        raise ValueError(f"{xa.size} checks do not fill whole rows of {n}")
    m = np.stack([xa * xa + ya * ya, xa * np.uint64(2), ya * np.uint64(2)])
    m = (m % np.uint64(ctx.t)).reshape(3, xa.size // n, n)
    return _encrypt3(encryptor, m, generator, words)


def make_batch_inputs(ctx, encryptor: Encryptor, xa, ya,
                      generator: torch.Generator | None = None, words=None):
    """Encrypt a batch of client coordinates, one query per ciphertext (the
    value in coefficient 0) -> the three (c0, c1) pairs, [B, L, n] each."""
    xa = np.asarray(xa, np.uint64)
    ya = np.asarray(ya, np.uint64)
    m = np.zeros((3, xa.shape[0], ctx.n), np.uint64)
    m[:, :, 0] = np.stack([xa * xa + ya * ya, xa * np.uint64(2), ya * np.uint64(2)])
    return _encrypt3(encryptor, m % np.uint64(ctx.t), generator, words)
