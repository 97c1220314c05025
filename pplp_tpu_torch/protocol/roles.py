"""Protocol roles A (client) and B (server) as transport-agnostic sessions.

Counterpart of ``pplp_tpu.protocol.roles``, with the same messages, byte
for byte:

    client                                server
      parms ------------------------------->   (raw bytes)
      ct(u), ct(2xa), ct(2ya) ------------->
      <---------------------- w64 ‖ BF blob
      <------------------- blind-distance ct
      decrypt + BF probe -> near/far

Each role works on an explicit torch device. Randomness comes from a
``torch.Generator`` seeded from ``cfg.seed`` (fresh when it is None), or is
injected as numpy arrays for known-answer runs.
"""

from __future__ import annotations

import secrets
import struct

import numpy as np
import torch

from ..bfv import BFVContext, Ciphertext, Plaintext
from ..bfv.serialize import load_ciphertext, load_parms, save_ciphertext, save_parms
from ..primitives import Blinding, BloomFilter, BloomParameters, pack_key
from ..utils.hexcodec import get_bitlen, uint64_to_hex_string
from ..utils.profiling import span
from . import stages
from .config import ProtocolConfig

__all__ = ["ProximityClient", "ProximityServer", "send_bf"]


def send_bf(chan, server) -> int:
    """Send w || BF as one frame: ``server.bf_message()``, the reference's
    bytes in one host buffer."""
    return chan.send_frame(server.bf_message())


class ProximityClient:
    """Role A: owns the keys and coordinates (xa, ya)."""

    def __init__(self, cfg: ProtocolConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(secrets.randbits(62) if cfg.seed is None else cfg.seed)
        self.parms = cfg.encryption_parameters()
        self.ctx = BFVContext.build(self.parms, self.device)
        self.is_near: bool | None = None
        self.blind_distance: int | None = None

    def parms_message(self) -> bytes:
        return save_parms(self.parms)

    def keygen(self, inject=None):
        """``inject``: (s, a_ntt, e) numpy randomness instead of the generator."""
        if inject is None:
            self.sk, self.pk = stages.keygen(self.ctx, self.generator)
        else:
            self.sk, self.pk = stages.keygen_injected(self.ctx, *inject)

    def ciphertext_messages(self, inject=None) -> list[bytes]:
        """Encrypt u = xa^2 + ya^2, 2*xa, 2*ya in one batch (demo.cc:131-140).

        ``inject``: three (u, e0, e1) numpy triples, one per message."""
        cfg, ctx = self.cfg, self.ctx
        values = (cfg.xa * cfg.xa + cfg.ya * cfg.ya, cfg.xa << 1, cfg.ya << 1)
        with span("bfv.plain_encode", count=len(values)):
            pairs = [Plaintext(uint64_to_hex_string(v), n=ctx.n).pair_u32(ctx.n)
                     for v in values]
        m_lo = np.stack([p[0] for p in pairs])
        m_hi = np.stack([p[1] for p in pairs])
        ct = stages.encrypt_batch(ctx, self.pk, m_lo, m_hi, self.generator, inject)
        c0, c1 = ct.polys
        return [
            save_ciphertext(Ciphertext((c0[i], c1[i]), "coeff"), ctx)
            for i in range(len(values))
        ]

    def receive_bf(self, blob: bytes):
        (self.w,) = struct.unpack_from("<Q", blob, 0)
        # The client probes one key on the host (contains_u64), as the
        # reference does: the filter stays on the CPU and reads its table in
        # place in ``blob``.
        self.bf = BloomFilter.deserialize(memoryview(blob)[8:],
                                          index_mode=self.cfg.bf_index_mode, device="cpu")

    def receive_blind_distance(self, blob: bytes) -> bool:
        with span("roles.decrypt"):
            ct = load_ciphertext(blob, self.ctx)
            residues = stages.ct_value(self.ctx, self.sk, ct).cpu().numpy()
            plain = Plaintext(self.ctx.decode_plain_from_ct_value(residues))
            # The blind distance is the constant coefficient; nonzero higher
            # coefficients mean the noise budget was exhausted (flagged).
            self.decrypt_consistent = plain.significant_coeff_count() <= 1
            self.blind_distance = int(plain.coeffs[0]) if plain.coeffs else 0
        key = pack_key(self.blind_distance, self.w, get_bitlen(self.w))
        with span("roles.probe"):
            self.is_near = self.bf.contains_u64(key)
        return self.is_near


class ProximityServer:
    """Role B: owns (xb, yb), the blinding values, and the Bloom filter."""

    def __init__(self, cfg: ProtocolConfig, device, blinding: Blinding | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self._blinding = blinding  # resolved lazily (needs parms for q)

    def _noise_aware_s_bits(self) -> int:
        """Cap log2(s) so s * max(xb,yb) * nu_fresh < Delta/2.

        The blind-distance noise is ~ s*(nu1 + xb*nu2 + yb*nu3); fresh RLWE
        noise here has ||nu||_inf well under 2^16 for n <= 32768 (ternary u
        convolved with CBD(21) noise). Margin bits cover the sum and rounding.
        """
        delta_bits = self.ctx.delta.bit_length()
        coord_bits = get_bitlen(max(self.cfg.xb, self.cfg.yb, 1))
        nu_bits = 16
        margin = 3
        return delta_bits - 1 - coord_bits - nu_bits - margin

    @property
    def blinding(self) -> Blinding:
        if self._blinding is None:
            cfg = self.cfg
            if cfg.safe_blinding:
                # Bounded by the t of the parameters received, which the
                # client chose: the server's own plain_modulus_bits may differ.
                self._blinding = Blinding.for_protocol(
                    self.ctx.t.bit_length() - 1,
                    cfg.sq_radius,
                    cfg.seed,
                    max_s_bits=self._noise_aware_s_bits(),
                )
            else:
                self._blinding = (
                    Blinding.sample()
                    if cfg.seed is None
                    else Blinding.deterministic(cfg.seed)
                )
        return self._blinding

    def receive_parms(self, blob: bytes):
        self.parms = load_parms(blob)
        err = self.parms.validate()
        if err:
            raise ValueError(f"received invalid parameters: {err}")
        self.ctx = BFVContext.build(self.parms, self.device)

    def build_bloom_filter(self):
        """r^2 blinded-key inserts on the device: on the card one insert
        whose kernels make the keys themselves
        (``BloomFilter.insert_blind_distances``)."""
        cfg = self.cfg
        p = BloomParameters(
            projected_element_count=cfg.sq_radius,
            false_positive_probability=cfg.false_positive_probability,
            random_seed=cfg.bf_seed,
            index_mode=cfg.bf_index_mode,
        )
        assert p.compute_optimal_parameters()
        self.bf = BloomFilter(p, device=self.device)
        self.bf.insert_blind_distances(self.blinding, cfg.sq_radius)

    def bf_message(self) -> memoryview:
        """w || filter, the reference's bytes, as a read-only memoryview of
        one host buffer (``BloomFilter.host_buffer``: page-locked for a
        filter on a CUDA device): w, the filter's header and tail are
        written into it, then the table crosses once, into its place
        (``table_into``), where the filter's host table then reads it. It
        compares with ``bytes`` and goes to a socket (``send_bf``) or a join
        as it is."""
        bf = self.bf
        with span("roles.bf_join") as rec:
            message = bf.host_buffer(8 + bf.compute_serialization_size())
            struct.pack_into("<Q", message, 0, self.blinding.w)
            table = bf.frame_into(message[8:])
            rec.set(bytes=message.shape[0])
        bf.table_into(table)
        message.flags.writeable = False
        return memoryview(message)

    def receive_ciphertexts(self, blobs: list[bytes]):
        self.c1, self.c2, self.c3 = (load_ciphertext(b, self.ctx) for b in blobs)

    def blind_distance_message(self) -> bytes:
        """Homomorphic blind distance (demo.cc:148-160):

        c1 <- s*(u + z - 2*xa*xb - 2*ya*yb) + s*r = s*(d^2 + r)
        """
        cfg, bl = self.cfg, self.blinding
        t, n = self.ctx.t, self.ctx.n
        z = cfg.xb * cfg.xb + cfg.yb * cfg.yb
        out = stages.blind_distance(
            self.ctx, self.c1, self.c2, self.c3,
            stages.plain_pair(z, t, n), stages.plain_pair(cfg.xb, t, n),
            stages.plain_pair(cfg.yb, t, n), stages.plain_pair(bl.s, t, n),
            stages.plain_pair(bl.s * bl.r, t, n),
        )
        return save_ciphertext(out, self.ctx)
