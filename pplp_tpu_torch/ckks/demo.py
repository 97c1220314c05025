"""CKKS aggregation demo: sum encrypted values across parties.

Counterpart of ``pplp_tpu.ckks.demo``: parties encrypt their values, an
untrusted aggregator sums the ciphertexts without keys, the key holder
decrypts the total. The roles run in one process; every ciphertext crosses
as bytes (``save_ciphertext``/``load_ciphertext``), as it would on the wire.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bfv.keys import KeyGenerator
from ..bfv.serialize import load_ciphertext, save_ciphertext
from ..device import cuda_device
from .ckks import CKKSContext, CKKSEncoder, ckks_add, ckks_decrypt, ckks_encrypt

__all__ = ["AggregationResult", "run_aggregation_demo"]


@dataclass
class AggregationResult:
    values: list[float]
    decrypted_sum: float
    true_sum: float

    @property
    def abs_error(self) -> float:
        return abs(self.decrypted_sum - self.true_sum)


def run_aggregation_demo(values=None, n=2048, scale=float(1 << 30), seed=0, verbose=True,
                         device=None) -> AggregationResult:
    """Keys from ``seed``, each value's encryption randomness from
    ``seed + 1``, on ``device`` (the CUDA card unless given)."""
    values = list(values) if values is not None else [23.0, 41.5, 35.0, 58.25]
    device = torch.device(device) if device is not None else cuda_device()
    ctx = CKKSContext.build(n=n, scale=scale, device=device)
    enc = CKKSEncoder(ctx)
    kg = KeyGenerator(ctx.base, torch.Generator(device=device).manual_seed(seed))
    sk, pk = kg.secret_key(), kg.create_public_key()

    # Each party encrypts its value into slot 0; the blobs cross the wire.
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    blobs = [save_ciphertext(ckks_encrypt(ctx, pk, enc.coeffs_to_rns(enc.encode([v])), gen),
                             ctx.base) for v in values]

    # The aggregator sums the ciphertexts without keys.
    acc = load_ciphertext(blobs[0], ctx.base)
    for blob in blobs[1:]:
        acc = ckks_add(ctx, acc, load_ciphertext(blob, ctx.base))

    # The key holder decrypts and decodes slot 0.
    coeffs = ckks_decrypt(ctx, sk, acc)
    total = float(np.real(enc.decode(coeffs.astype(np.float64))[0]))
    true = float(sum(values))
    if verbose:
        print(f"Encrypted aggregation of {len(values)} values")
        print(f"decrypted sum = {total:.4f} (true {true}), "
              f"mean = {total / len(values):.4f}")
    return AggregationResult(values=values, decrypted_sum=total, true_sum=true)
