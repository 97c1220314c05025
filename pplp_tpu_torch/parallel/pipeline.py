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
the step transforms the six ciphertext polynomials forward, combines them
with the plaintext spectra and the secret key in the NTT domain, and
returns through one inverse NTT: the same residues as the reference's
op-by-op chain, bit for bit. The plain step does it in torch (one stacked
forward NTT); it is the CPU, m62 and sharded path and every builder's
``.plain``. CUDA residues of an m31 chain outside a mesh take the fused
route of ``ops.pipeline_cuda``: the forward transforms write u32 spectra
straight from the int64 ciphertexts, one kernel combines them (with z and
s*r added as their spectra), and after the u32 inverse one kernel decodes.
``make_packed_inputs`` encrypts the three messages of every query in one
batched encryption (one NTT launch per direction).

Sharded (``mesh=``, counterpart of the reference's step under ``jax.jit``
with ``ct_sharding``): every op of the step is limb-local, so on a dp x limb
mesh a rank runs it on its block with its rows of the plaintext spectra and
the secret key, without communication; a ``coeff`` axis adds the C -> R
exchange before the forward transform and R -> C after the inverse
(``parallel.ntt_dist``). The packed step decodes and probes in C (every limb
of a coefficient slice, so the mesh has no ``limb`` axis) against a
replicated filter and gathers the verdicts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bfv import Evaluator, Plaintext
from ..bfv.encryptor import Encryptor
from ..bfv.rns_decrypt import get_decoder
from ..ops import ntt, pipeline_cuda
from ..ops.modmath import M32
from ..primitives.blinding import blinded_keys
from ..primitives.bloom import BloomFilter, BloomParameters, probe
from ..utils.hexcodec import uint64_to_hex_string
from ..utils.profiling import span
from .mesh import gather
from .ntt_dist import DistNtt

__all__ = [
    "build_batched_pipeline",
    "build_packed_pipeline",
    "build_packed_pipeline_bf",
    "blinded_keys",
    "bf_probe",
    "build_pipeline_filter",
    "make_batch_inputs",
    "step_constants",
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


def step_constants(ctx, xb: int, yb: int, s_blind: int, r_blind: int, packed: bool):
    """The step's plaintext terms: z = xb^2 + yb^2 and s r scaled into R_q
    ([L, n] coefficients, in every slot when ``packed``), and the spectra of
    xb, yb and s with their Shoup companions ([3, L, n] each)."""
    z = ctx.scale_plain(*_plain_pairs(ctx, xb * xb + yb * yb, full=packed))
    sr = ctx.scale_plain(*_plain_pairs(ctx, s_blind * r_blind, full=packed))
    pairs = [_plain_pairs(ctx, v) for v in (xb, yb, s_blind)]
    m_ntt, m_shoup = Evaluator(ctx).plain_spectrum(
        (np.stack([a for a, _ in pairs]), np.stack([b for _, b in pairs])))
    return z, sr, m_ntt, m_shoup


def _step_parts(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int, packed: bool, mesh):
    """(the plain step, the fused ``pipeline_cuda.Combine`` or None): the
    fused one exists where its route can run, on an m31 chain's card
    tables outside a mesh."""
    p, q2, tb = ctx.prof, ctx.q2, ctx.tables
    z, sr, m_ntt, m_shoup = step_constants(ctx, xb, yb, s_blind, r_blind, packed)
    if mesh is not None:
        return _sharded_step(ctx, sk, z, sr, m_ntt, m_shoup, mesh), None
    fused = None
    if pipeline_cuda.route(tb.q, tb) == "fused":
        fused = pipeline_cuda.Combine(tb, z, sr, m_ntt, m_shoup, sk.s_ntt, sk.s_shoup)

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

    return step, fused


def build_batched_pipeline(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int,
                           packed: bool = False, mesh=None):
    """Returns fn(c1_polys, c2_polys, c3_polys) -> residues [B, L, n] of the
    decrypted blind distance, x = c0 + c1 s.

    Ciphertext arguments are the (c0, c1) pairs of coefficient-domain
    ciphertexts with [B, L, n] polynomials. packed=True makes the additive
    terms (z, s*r) reach every coefficient slot. With ``mesh``, the
    arguments and the result are this rank's blocks (``mesh.shard``).
    CUDA residues of an m31 chain outside a mesh take the fused route
    (``ops.pipeline_cuda``); ``fn.plain`` is the torch chain, bit for bit
    the same, on any device."""
    plain, fused = _step_parts(ctx, sk, xb, yb, s_blind, r_blind, packed, mesh)

    def step(c1_polys, c2_polys, c3_polys):
        if fused is not None and pipeline_cuda.route(c1_polys[0], ctx.tables) == "fused":
            return fused(c1_polys, c2_polys, c3_polys, wide=True)
        return plain(c1_polys, c2_polys, c3_polys)

    step.plain = plain
    return step


def _sharded_step(ctx, sk, z, sr, m_ntt, m_shoup, mesh):
    """``build_batched_pipeline``'s step on this rank's block of a
    dp x limb x coeff mesh: C block in, C block out."""
    dn = DistNtt(ctx.tables, mesh, "coeff", "dp", "limb")
    if dn.limb_block.stop == dn.limb_block.start:
        raise ValueError(f"a limb axis of {mesh.size('limb')} over {ctx.L} limbs")
    blk, rows, tr = dn.limb_block, dn.limbs, dn.tables
    pc, qc = ctx.tables.limbs(blk).prof, ctx.q2[blk]
    z, sr = z[blk, dn.coeffs], sr[blk, dn.coeffs]
    if tr is not None:
        pr, qr = tr.prof, tr.q_b(1)
        m_ntt, m_shoup = m_ntt[:, rows], m_shoup[:, rows]
        s_ntt, s_shoup = sk.s_ntt[rows], sk.s_shoup[rows]

    def times(x, i):
        return pr.mulmod_shoup(x, m_ntt[i], m_shoup[i], qr)

    def step(c1_polys, c2_polys, c3_polys):
        c1_0 = pc.add(c1_polys[0], z, qc)
        spec = dn.forward(torch.stack([c1_0, c1_polys[1], *c2_polys, *c3_polys]))
        if tr is None:  # no rows here: pass the empty block on
            return pc.add(dn.inverse(spec[0]), sr, qc)
        acc0 = pr.sub(spec[0], pr.add(times(spec[2], 0), times(spec[4], 1), qr), qr)
        acc1 = pr.sub(spec[1], pr.add(times(spec[3], 0), times(spec[5], 1), qr), qr)
        val = pr.add(times(acc0, 2), pr.mulmod_shoup(times(acc1, 2), s_ntt, s_shoup, qr), qr)
        return pc.add(dn.inverse(val), sr, qc)

    return step


def build_packed_pipeline(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int, mesh=None):
    """Coefficient-packed pipeline: n proximity checks per ciphertext row.

    Every coefficient j of the plaintext carries one client's (u_j, 2xa_j,
    2ya_j); the server's ops are scalar plain multiplies and adds, which act
    coefficient-wise, so one [B, L, n] ciphertext batch evaluates B*n
    independent checks. Returns fn(c1, c2, c3 polys) -> blind distances
    [B, n] mod t (device decode; requires t < 2^30). With ``mesh`` (no
    ``limb`` axis: the decode reads every limb), blocks in and out. The
    spans ``pipeline.evaluate`` and ``pipeline.decode`` carry the route
    (``ops.pipeline_cuda.route``): "fused" keeps x in u32 between the
    inverse transform and the decode kernel. ``fn.plain`` is the torch
    chain."""
    if mesh is not None and mesh.size("limb") != 1:
        raise ValueError("the packed step decodes every limb of a coefficient: "
                         "shard it over dp and coeff only")
    plain, fused = _step_parts(ctx, sk, xb, yb, s_blind, r_blind, True, mesh)
    decoder = get_decoder(ctx)

    def packed(c1_polys, c2_polys, c3_polys):
        route = "plain" if fused is None else pipeline_cuda.route(c1_polys[0], ctx.tables)
        with span("pipeline.evaluate", route=route):
            if route == "fused":
                x = fused(c1_polys, c2_polys, c3_polys, wide=False)
            else:
                x = plain(c1_polys, c2_polys, c3_polys)
        with span("pipeline.decode", route=route):
            if route == "fused":  # u32 x: the kernel
                return pipeline_cuda.decode(x, *decoder.kernel_constants)
            return decoder.decode_mod_t_plain(x)  # a sharded block stays plain too

    def packed_plain(c1_polys, c2_polys, c3_polys):
        return decoder.decode_mod_t_plain(plain(c1_polys, c2_polys, c3_polys))

    packed.plain = packed_plain
    return packed


def bf_probe(bd: torch.Tensor, w: int, w_len: int, table: torch.Tensor,
             salts: torch.Tensor, table_size: int, mixed: bool = True) -> torch.Tensor:
    """Bloom membership of the blinded keys (bd << w_len) | w of ``bd`` [...]
    -> bool [...], in a filter's device table (``BloomFilter.bits_device``):
    on the card one launch of the probe kernel, which makes the keys itself;
    on the CPU the plain hash and gather."""
    return probe(table, salts, table_size, mixed, blind_distances=(bd, w, w_len))


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
    bf = BloomFilter(p, device=device)
    di = torch.arange(r_blind * r_blind, dtype=torch.int64, device=device)
    bf.insert_u64_batch(*blinded_keys(s_blind * (di + r_blind) % t, w, w.bit_length()))
    return bf


def build_packed_pipeline_bf(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int,
                             w: int, w_len: int, mixed: bool = True, mesh=None):
    """The whole BASELINE config[3] step: homomorphic evaluation, device
    decode, blinded-key formation and the Bloom probe.

    The reference ends every proximity check with ``bf.contains((bd << w_len)
    | w)`` (``pplp:src/demo.cc:171-177``). Returns
    ``fn(c1_polys, c2_polys, c3_polys, table, salts, table_size) -> bool [B, n]``
    where ``table``/``salts``/``table_size`` are a ``BloomFilter``'s
    ``bits_device`` (packed words on the card), ``_salts_device()`` and
    ``table_size``. Requires
    t < 2^30 and 0 < w_len < 32. With ``mesh`` (dp x coeff), the
    ciphertexts are this rank's blocks, every rank holds the whole filter,
    and every rank gets all [B, n] verdicts."""
    if not 0 < w_len < 32:
        raise ValueError(f"w_len must be in (0, 32), got {w_len}")
    step = build_packed_pipeline(ctx, sk, xb, yb, s_blind, r_blind, mesh=mesh)

    def run(step):
        def fn(c1_polys, c2_polys, c3_polys, table, salts, table_size):
            with span("pipeline.step") as rec:
                bd = step(c1_polys, c2_polys, c3_polys)
                with span("pipeline.probe"):
                    near = bf_probe(bd, w, w_len, table, salts, table_size, mixed)
                rec.set(checks=near.numel())
                return near if mesh is None else gather(near, mesh, ("dp", "coeff"))

        return fn

    fn = run(step)
    fn.plain = run(step.plain)
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
