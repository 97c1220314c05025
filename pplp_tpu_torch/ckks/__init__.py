"""CKKS approximate arithmetic on PyTorch: the aggregation-demo capability.

Counterpart of ``pplp_tpu.ckks``: the encoder (canonical embedding by a
host FFT), keygen shared with the BFV stack, encrypt / add / decrypt, the
ct x ct multiply with relinearization and rescaling, and the aggregation
demo, in process (``demo``) and over the framed transport (``netmain``).
"""

from .ckks import CKKSContext, CKKSEncoder, ckks_add, ckks_decrypt, ckks_encrypt
from .demo import run_aggregation_demo

__all__ = [
    "CKKSContext",
    "CKKSEncoder",
    "ckks_encrypt",
    "ckks_decrypt",
    "ckks_add",
    "run_aggregation_demo",
]
