"""Binary wire format for parameters, ciphertexts and keys.

Counterpart of ``pplp_tpu.bfv.serialize``, byte-identical to it: versioned
little-endian frames; per-limb residues packed to the minimal byte width of
the limb's modulus. Keys live in the NTT domain; on the wire they are in
coefficient order, so a save runs the inverse transform and a load the
forward one (the NTT kernels on a CUDA context) and recomputes the Shoup
companions.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops import ntt
from ..utils.profiling import span
from .behz import KSwitchKeys, _digit_groups
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import PublicKey, SecretKey, shoup
from .params import SCHEME_BFV, EncryptionParameters

__all__ = ["save_parms", "load_parms", "save_ciphertext", "load_ciphertext",
           "save_public_key", "load_public_key", "save_secret_key", "load_secret_key",
           "save_kswitch_keys", "load_kswitch_keys", "save_sp_keys", "load_sp_keys"]

_MAGIC_PARMS = b"PPLPprm1"
_MAGIC_CT = b"PPLPctx1"
_MAGIC_PK = b"PPLPpub1"
_MAGIC_SK = b"PPLPsec1"
_MAGIC_KSW = b"PPLPksw1"
_MAGIC_SPK = b"PPLPspk1"


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
    with span("bfv.save_ciphertext") as rec:
        widths = _limb_widths(ctx)
        out = [_MAGIC_CT, struct.pack("<QHB", ctx.n, ctx.L, ct.size)]
        for poly in ct.polys:
            out.append(_pack_residues(poly.cpu().numpy(), widths))
        blob = b"".join(out)
        rec.set(bytes=len(blob))
    return blob


def load_ciphertext(buf: bytes, ctx: BFVContext) -> Ciphertext:
    if buf[:8] != _MAGIC_CT:
        raise ValueError("bad ciphertext magic")
    n, L, k = struct.unpack_from("<QHB", buf, 8)
    if (n, L) != (ctx.n, ctx.L):
        raise ValueError("ciphertext/context mismatch")
    with span("bfv.load_ciphertext", bytes=len(buf)):
        off = 8 + struct.calcsize("<QHB")
        widths = _limb_widths(ctx)
        polys = []
        for _ in range(k):
            res, off = _unpack_residues(buf, off, n, widths)
            polys.append(torch.as_tensor(res.astype(np.int64), device=ctx.device))
        return Ciphertext(tuple(polys), "coeff")


def _header(buf: bytes, magic: bytes, fmt: str, ctx: BFVContext, what: str):
    """The fields of a key header after checking its magic and context."""
    if buf[:8] != magic:
        raise ValueError(f"bad {what} magic")
    fields = struct.unpack_from(fmt, buf, 8)
    if fields[:2] != (ctx.n, ctx.L):
        raise ValueError(f"{what}/context mismatch")
    return fields, 8 + struct.calcsize(fmt)


def _save_spectra(spectra: torch.Tensor, ctx: BFVContext) -> list[bytes]:
    """NTT-domain polynomials [k, L, n] -> their packed coefficient residues,
    one inverse transform for all of them."""
    widths = _limb_widths(ctx)
    coeff = ntt.inverse(spectra.contiguous(), ctx.tables).cpu().numpy()
    return [_pack_residues(poly, widths) for poly in coeff]


def _load_spectra(buf: bytes, off: int, count: int, ctx: BFVContext):
    """``count`` packed coefficient polynomials -> their spectra [count, L, n]
    and Shoup companions on the context's device, one forward transform."""
    widths = _limb_widths(ctx)
    polys = []
    for _ in range(count):
        res, off = _unpack_residues(buf, off, ctx.n, widths)
        polys.append(res.astype(np.int64))
    x = torch.as_tensor(np.stack(polys), device=ctx.device)
    spec = ntt.forward(x, ctx.tables)
    return spec, shoup(ctx, spec)


def save_public_key(pk: PublicKey, ctx: BFVContext) -> bytes:
    """pk0 ‖ pk1 in coefficient order."""
    blobs = _save_spectra(torch.stack([pk.pk0_ntt, pk.pk1_ntt]), ctx)
    return b"".join([_MAGIC_PK, struct.pack("<QH", ctx.n, ctx.L), *blobs])


def load_public_key(buf: bytes, ctx: BFVContext) -> PublicKey:
    _, off = _header(buf, _MAGIC_PK, "<QH", ctx, "public key")
    spec, sh = _load_spectra(buf, off, 2, ctx)
    return PublicKey(pk0_ntt=spec[0], pk1_ntt=spec[1], pk0_shoup=sh[0], pk1_shoup=sh[1])


def save_secret_key(sk: SecretKey, ctx: BFVContext) -> bytes:
    blobs = _save_spectra(sk.s_ntt[None], ctx)
    return b"".join([_MAGIC_SK, struct.pack("<QH", ctx.n, ctx.L), *blobs])


def load_secret_key(buf: bytes, ctx: BFVContext) -> SecretKey:
    _, off = _header(buf, _MAGIC_SK, "<QH", ctx, "secret key")
    spec, sh = _load_spectra(buf, off, 1, ctx)
    return SecretKey(s_ntt=spec[0], s_shoup=sh[0])


def save_kswitch_keys(keys: KSwitchKeys, ctx: BFVContext) -> bytes:
    """RNS-gadget key-switching keys: the k digit rows of k0, then of k1."""
    k = keys.k0.shape[0]
    blobs = _save_spectra(torch.cat([keys.k0, keys.k1]), ctx)
    return b"".join([_MAGIC_KSW, struct.pack("<QHH", ctx.n, ctx.L, k), *blobs])


def load_kswitch_keys(buf: bytes, ctx: BFVContext) -> KSwitchKeys:
    """Keys with their gadget groups rebuilt from the digit count: keys are
    built with contiguous equal-width groups, so k digits of L limbs have
    width ceil(L / k)."""
    (_, L, k), off = _header(buf, _MAGIC_KSW, "<QHH", ctx, "kswitch keys")
    spec, sh = _load_spectra(buf, off, 2 * k, ctx)
    return KSwitchKeys(k0=spec[:k], k0_shoup=sh[:k], k1=spec[k:], k1_shoup=sh[k:],
                       groups=_digit_groups(L, (L + k - 1) // k))


def save_sp_keys(spk, ctx: BFVContext) -> bytes:
    """Special-prime keys: n, L, k, P, then the k digit rows of k0 and then
    of k1, each in coefficient order over Q ∪ {P}."""
    k = spk.k0.shape[0]
    blobs = _save_spectra(torch.cat([spk.k0, spk.k1]), spk.ctx_qp)
    return b"".join([_MAGIC_SPK, struct.pack("<QHHQ", ctx.n, ctx.L, k, spk.P), *blobs])


def load_sp_keys(buf: bytes, ctx: BFVContext):
    """Special-prime keys over ``ctx`` extended by the P the bytes name."""
    from .keyswitch import SPKeys

    (_, _, k, P), off = _header(buf, _MAGIC_SPK, "<QHHQ", ctx, "sp keys")
    ctx_qp = BFVContext.build(
        ctx.parms.with_coeff_modulus(tuple(m.value for m in ctx.moduli) + (P,)), ctx.device)
    spec, sh = _load_spectra(buf, off, 2 * k, ctx_qp)
    return SPKeys(ctx_qp=ctx_qp, P=P, k0=spec[:k], k0_shoup=sh[:k], k1=spec[k:],
                  k1_shoup=sh[k:])
