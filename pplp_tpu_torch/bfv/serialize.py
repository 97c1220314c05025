"""Binary wire format for parameters and ciphertexts.

Counterpart of ``pplp_tpu.bfv.serialize``, byte-identical to it: versioned
little-endian frames; per-limb residues packed to the minimal byte width of
the limb's modulus.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .ciphertext import Ciphertext
from .context import BFVContext
from .params import SCHEME_BFV, EncryptionParameters

__all__ = ["save_parms", "load_parms", "save_ciphertext", "load_ciphertext"]

_MAGIC_PARMS = b"PPLPprm1"
_MAGIC_CT = b"PPLPctx1"


def save_parms(parms: EncryptionParameters) -> bytes:
    out = [
        _MAGIC_PARMS,
        struct.pack(
            "<BQQH",
            0 if parms.scheme == SCHEME_BFV else 255,
            parms.poly_modulus_degree,
            parms.plain_modulus,
            len(parms.coeff_modulus),
        ),
    ]
    for q in parms.coeff_modulus:
        out.append(struct.pack("<Q", q))
    return b"".join(out)


def load_parms(buf: bytes) -> EncryptionParameters:
    if buf[:8] != _MAGIC_PARMS:
        raise ValueError("bad parms magic")
    scheme, n, t, L = struct.unpack_from("<BQQH", buf, 8)
    off = 8 + struct.calcsize("<BQQH")
    chain = struct.unpack_from(f"<{L}Q", buf, off)
    return EncryptionParameters(SCHEME_BFV if scheme == 0 else "?", n, tuple(chain), t)


def _limb_widths(ctx: BFVContext) -> list[int]:
    return [(m.bit_count + 7) // 8 for m in ctx.moduli]


def _pack_residues(res: np.ndarray, widths) -> bytes:
    """res: integer array [L, n] -> per-limb minimal-width little-endian bytes."""
    parts = []
    for li, w in enumerate(widths):
        full = res[li].astype("<u8").tobytes()
        parts.append(np.frombuffer(full, np.uint8).reshape(-1, 8)[:, :w].tobytes())
    return b"".join(parts)


def _unpack_residues(buf: bytes, off: int, n: int, widths) -> tuple[np.ndarray, int]:
    rows = []
    for w in widths:
        raw = np.frombuffer(buf, np.uint8, n * w, off).reshape(n, w)
        full = np.zeros((n, 8), np.uint8)
        full[:, :w] = raw
        rows.append(np.frombuffer(full.tobytes(), "<u8"))
        off += n * w
    return np.stack(rows), off


def save_ciphertext(ct: Ciphertext, ctx: BFVContext) -> bytes:
    assert ct.domain == "coeff"
    widths = _limb_widths(ctx)
    out = [_MAGIC_CT, struct.pack("<QHB", ctx.n, ctx.L, ct.size)]
    for poly in ct.polys:
        out.append(_pack_residues(poly.cpu().numpy(), widths))
    return b"".join(out)


def load_ciphertext(buf: bytes, ctx: BFVContext) -> Ciphertext:
    if buf[:8] != _MAGIC_CT:
        raise ValueError("bad ciphertext magic")
    n, L, k = struct.unpack_from("<QHB", buf, 8)
    if (n, L) != (ctx.n, ctx.L):
        raise ValueError("ciphertext/context mismatch")
    off = 8 + struct.calcsize("<QHB")
    widths = _limb_widths(ctx)
    polys = []
    for _ in range(k):
        res, off = _unpack_residues(buf, off, n, widths)
        polys.append(torch.as_tensor(res.astype(np.int64), device=ctx.device))
    return Ciphertext(tuple(polys), "coeff")
