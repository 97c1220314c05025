"""Batched DGK operations: the comparison path on B lanes at once.

Counterpart of ``pplp_tpu.dgk.batched``: batch encrypt, batch decrypt
(shared-exponent c^vpq, then the host hash map or a device fingerprint
table), the baby-step/giant-step device decrypt and the server's blind
distance for 10k+ parallel checks (BASELINE.md config[2]). Numbers are
[B, D] int64 rows of 16-bit digits (``modexp``), equal to the reference's.

On a CUDA device every exponentiation and product goes to the hand-written
kernel (``ops/dgk_cuda.py``: ``encrypt_batch`` is three launches,
``blind_distance_batch`` one, a decrypt's c^vpq one, a BSGS giant step
one of one Montgomery product a lane); on the CPU to the plain version.
The fingerprint fold and the table probe are plain torch on both.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import dgk_cuda
from .dgk import DGKPrivateKey, DGKPublicKey
from .modexp import MontgomeryCtx, from_digits, to_digits

__all__ = ["DGKBatch", "DGKDeviceTable"]


@dataclass(frozen=True, eq=False)
class DGKBatch:
    pub: DGKPublicKey
    mc: MontgomeryCtx

    @staticmethod
    def build(pub: DGKPublicKey, *, device) -> "DGKBatch":
        return DGKBatch(pub=pub, mc=MontgomeryCtx.build(pub.n, device=device))

    @property
    def device(self) -> torch.device:
        return self.mc.device

    def _dig(self, ints):
        return to_digits(ints, self.mc.D, self.device)

    @functools.cached_property
    def _bases(self):
        """g and h as digit rows on the device, made once: a copy from the
        host would wait for the kernels queued before it."""
        return self._dig([self.pub.g]), self._dig([self.pub.h])

    def encrypt_batch(self, ms, rs):
        """[B] messages (< u) + randomness -> [B, D] ciphertext digits:
        c = g^m h^r mod n, each exponentiation with per-lane exponents on a
        shared base."""
        # h^r first: packing its wide exponents is the long host step, and
        # packing g^m's then overlaps h^r's kernel.
        g, h = self._bases
        hr = dgk_cuda.powmod(self.mc, h, rs)
        gm = dgk_cuda.powmod(self.mc, g, ms)
        return dgk_cuda.mulmod(self.mc, gm, hr)

    def decrypt_batch(self, priv: DGKPrivateKey, cts) -> list[int]:
        """[B, D] ciphertext digits -> messages: c^vpq, then the host hash
        map (the oracle of the device paths)."""
        cv = dgk_cuda.powmod_shared_exp(self.mc, cts, priv.vpq)
        return [priv.rtab[v] for v in from_digits(cv)]

    def build_device_table(self, priv: DGKPrivateKey) -> "DGKDeviceTable":
        """The device decrypt table (once per private key)."""
        return DGKDeviceTable.build(priv, self.mc.D, device=self.device)

    def decrypt_batch_device(self, priv: DGKPrivateKey, dtab: "DGKDeviceTable", cts):
        """Device-resident decrypt: c^vpq, 64-bit fingerprint, probed lookup
        -> [B] int64 messages (``DGKDeviceTable.MISS`` where absent)."""
        return dtab.lookup(dgk_cuda.powmod_shared_exp(self.mc, cts, priv.vpq))

    def build_bsgs_table(self, priv: DGKPrivateKey) -> "DGKDeviceTable":
        """Baby-step table {G^j : j < isqrt(u) + 1}, G = g^vpq."""
        G = pow(priv.g, priv.vpq, priv.n)
        table, acc = {}, 1
        for j in range(math.isqrt(self.pub.u) + 1):
            table[acc] = j
            acc = acc * G % priv.n
        return DGKDeviceTable.from_map(table, self.mc.D, device=self.device)

    def decrypt_batch_device_bsgs(self, priv: DGKPrivateKey, btab: "DGKDeviceTable", cts):
        """Device decrypt by baby-step/giant-step with an O(sqrt(u)) table:
        each giant step probes the table and multiplies by G^-m, one
        Montgomery product a lane by G^-m in the Montgomery domain, as the
        reference runs it (``ph.cc``'s compute_dlog_bsgs on B lanes)."""
        u = self.pub.u
        m_steps = math.isqrt(u) + 1
        G = pow(priv.g, priv.vpq, priv.n)
        giant = pow(G, -m_steps, priv.n)
        z = dgk_cuda.powmod_shared_exp(self.mc, cts, priv.vpq)
        miss = DGKDeviceTable.MISS
        out = torch.full((z.shape[0],), miss, dtype=torch.int64, device=z.device)
        for i in range((u + m_steps - 1) // m_steps + 1):
            j = btab.lookup(z)
            hit = (j != miss) & (out == miss)
            out = torch.where(hit, i * m_steps + j, out)
            z = dgk_cuda.mulmod_const(self.mc, z, giant)
        return out

    # -- the comparison/proximity pipeline ------------------------------

    def blind_distance_batch(self, c1, c2, c3, xb: int, yb: int, s_blind: int, cz, cr):
        """Server side of the DGK pplp flow, batched:
        ((c1 c2^xb c3^yb)^s) cz cr over [B, D] ciphertexts."""
        return dgk_cuda.blind_distance(self.mc, c1, c2, c3, xb, yb, s_blind, cz, cr)


# -- device decrypt table ------------------------------------------------

_FP_A1 = np.uint32(0x9E3779B1)   # golden-ratio odd multipliers
_FP_A2 = np.uint32(0x85EBCA77)
_PROBE_MAX = 32


def _fp_powers(mult: np.uint32, D: int, device) -> torch.Tensor:
    """mult^i mod 2^32 for i < D, as int64."""
    pw = [1]
    for _ in range(D - 1):
        pw.append(pw[-1] * int(mult) & 0xFFFFFFFF)
    return torch.tensor(pw, dtype=torch.int64, device=device)


def _fp_device(digs: torch.Tensor, powers: torch.Tensor) -> torch.Tensor:
    """The Horner fold of [B, D] little-endian 16-bit digit rows into u32
    fingerprints, as one weighted sum: sum_i d_i mult^i mod 2^32. Each
    term is below 2^48 and a sum of D <= 2^15 of them below 2^63, so int64
    holds it exactly, and mod 2^32 it equals the wrapping u32 Horner fold."""
    return (digs * powers).sum(-1) & 0xFFFFFFFF


@dataclass(frozen=True, eq=False)
class DGKDeviceTable:
    """Open-addressed (linear probe) fingerprint table of {g^(vpq m) : m < u}.

    Entries are 64-bit fingerprints (two independent u32 Horner folds of the
    value's 16-bit digits); a lookup gathers ``probes`` slots and selects the
    first two-sided match. False-match probability ~ u 2^-64. Slots are
    int64 tensors holding u32 values, equal to the reference's slot for
    slot."""

    size: int
    probes: int
    fp1: torch.Tensor   # [S]
    fp2: torch.Tensor   # [S]
    msg: torch.Tensor   # [S] (MISS = empty)
    pw1: torch.Tensor   # [D]: _FP_A1^i mod 2^32
    pw2: torch.Tensor   # [D]: _FP_A2^i mod 2^32

    MISS = 0xFFFFFFFF

    @staticmethod
    def build(priv: DGKPrivateKey, D: int, *, device) -> "DGKDeviceTable":
        if not priv.rtab:
            priv.init_table()
        return DGKDeviceTable.from_map(priv.rtab, D, device=device)

    @staticmethod
    def from_map(table: dict, D: int, *, device) -> "DGKDeviceTable":
        """Build from any {group element -> u32 message/index} map."""
        u = len(table)
        size = 1 << max(4, (u * 4 - 1).bit_length())  # load factor <= 0.25
        vals = np.frombuffer(
            b"".join(int(v).to_bytes(D * 2, "little") for v in table), dtype="<u2",
        ).reshape(u, D)
        digs = torch.from_numpy(vals.astype(np.int64))
        fp1 = _fp_device(digs, _fp_powers(_FP_A1, D, "cpu")).numpy()
        fp2 = _fp_device(digs, _fp_powers(_FP_A2, D, "cpu")).numpy()
        if len(set(zip(fp1.tolist(), fp2.tolist()))) != u:  # pragma: no cover - p ~ 2^-33
            raise RuntimeError("fingerprint collision in DGK table; rebuild")
        msgs = np.fromiter(table.values(), np.uint32, count=u)
        t_fp1 = np.zeros(size, np.uint32)
        t_fp2 = np.zeros(size, np.uint32)
        t_msg = np.full(size, DGKDeviceTable.MISS, np.uint32)
        mask = size - 1
        probes = 1
        for f1, f2, m in zip(fp1, fp2, msgs):
            idx = int(f1) & mask
            steps = 1
            while t_msg[idx] != DGKDeviceTable.MISS:
                idx = (idx + 1) & mask
                steps += 1
            if steps > _PROBE_MAX:  # pragma: no cover
                raise RuntimeError("probe chain too long; grow the table")
            probes = max(probes, steps)
            t_fp1[idx], t_fp2[idx], t_msg[idx] = f1, f2, m
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(a.astype(np.int64)).to(dev)

        return DGKDeviceTable(size=size, probes=probes, fp1=put(t_fp1), fp2=put(t_fp2),
                              msg=put(t_msg), pw1=_fp_powers(_FP_A1, D, dev),
                              pw2=_fp_powers(_FP_A2, D, dev))

    def lookup(self, digs: torch.Tensor) -> torch.Tensor:
        """[B, D] digit rows -> [B] int64 messages (MISS when absent)."""
        f1 = _fp_device(digs, self.pw1)
        f2 = _fp_device(digs, self.pw2)
        mask = self.size - 1
        idx = f1 & mask
        out = torch.full_like(f1, self.MISS)
        for _ in range(self.probes):
            hit = (self.fp1[idx] == f1) & (self.fp2[idx] == f2) & (out == self.MISS)
            out = torch.where(hit, self.msg[idx], out)
            idx = (idx + 1) & mask
        return out
