"""Networked CKKS aggregation over the framed transport.

Counterpart of ``pplp_tpu.ckks.netmain``: contributors send encrypted values
to an untrusted aggregator, which sums the ciphertexts and returns the
encrypted total to the key holder.

Wire flow (one aggregator, the key holder contributing every value):

    key holder -> server : parms, pk, scale
    key holder -> server : ct(value_i), one frame each
    server -> key holder : ct(sum)
    key holder           : decrypt + decode
"""

from __future__ import annotations

import numpy as np
import torch

from ..bfv.context import BFVContext
from ..bfv.keys import KeyGenerator
from ..bfv.serialize import (load_ciphertext, load_parms, load_public_key, save_ciphertext,
                             save_parms, save_public_key)
from ..device import cuda_device
from ..protocol.transport import Channel
from .ckks import CKKSContext, CKKSEncoder, ckks_add, ckks_decrypt, ckks_encrypt

__all__ = ["run_aggregation_server", "run_aggregation_keyholder",
           "run_aggregation_contributor"]


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else cuda_device()


def run_aggregation_server(chan: Channel, n_values: int, device=None):
    """The untrusted aggregator: receives parms and pk, sums ``n_values``
    ciphertexts on ``device`` (the CUDA card unless given), returns the sum."""
    ctx = BFVContext.build(load_parms(chan.recv_frame()), _device(device))
    load_public_key(chan.recv_frame(), ctx)  # the pk contributors encrypt under
    scale = np.frombuffer(chan.recv_frame(), np.float64)[0]
    cctx = CKKSContext(base=ctx, scale=float(scale))
    acc = None
    for _ in range(n_values):
        ct = load_ciphertext(chan.recv_frame(), ctx)
        acc = ct if acc is None else ckks_add(cctx, acc, ct)
    chan.send_frame(save_ciphertext(acc, ctx))


def run_aggregation_keyholder(chan: Channel, values, n=2048, scale=float(1 << 30), seed=0,
                              device=None) -> float:
    """The key holder drives the round: shares parms and pk, contributes
    every value (standing in for the contributors on one channel) and
    decrypts the sum. Keys from ``seed``, encryptions from ``seed + 1``."""
    device = _device(device)
    ctx = CKKSContext.build(n=n, scale=scale, device=device)
    enc = CKKSEncoder(ctx)
    kg = KeyGenerator(ctx.base, torch.Generator(device=device).manual_seed(seed))
    sk, pk = kg.secret_key(), kg.create_public_key()
    chan.send_frame(save_parms(ctx.base.parms))
    chan.send_frame(save_public_key(pk, ctx.base))
    chan.send_frame(np.float64(scale).tobytes())
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for v in values:
        run_aggregation_contributor(chan, v, ctx, pk, gen)
    total_ct = load_ciphertext(chan.recv_frame(), ctx.base)
    coeffs = ckks_decrypt(ctx, sk, total_ct)
    return float(np.real(enc.decode(coeffs.astype(np.float64))[0]))


def run_aggregation_contributor(chan: Channel, value: float, ctx: CKKSContext, pk,
                                generator: torch.Generator):
    """A contributor without the secret key: one value under the shared pk."""
    enc = CKKSEncoder(ctx)
    m = enc.coeffs_to_rns(enc.encode([value]))
    chan.send_frame(save_ciphertext(ckks_encrypt(ctx, pk, m, generator), ctx.base))
