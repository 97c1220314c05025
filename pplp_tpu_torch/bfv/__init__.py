"""BFV on PyTorch: parameters, context, keys, encrypt, evaluate, decrypt.

Counterpart of ``pplp_tpu.bfv`` for what the proximity protocol uses, on
both residue profiles (``m31``: primes below 2^30; ``m62``: primes in
[2^32, 2^62)), the device decode of the packed pipeline (``rns_decrypt``),
and the ct x ct multiply with relinearization and modulus switching
(``behz``, ``behz_fused``, ``rescale``), special-prime key switching
(``keyswitch``), Galois rotations (``galois``) and the batch encoder
(``batch_encoder``), on both.
"""

from .params import EncryptionParameters, SCHEME_BFV
from .context import BFVContext
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import KeyGenerator, PublicKey, SecretKey
from .encryptor import Encryptor
from .evaluator import Evaluator
from .decryptor import Decryptor
from .batch_encoder import BatchEncoder
from .keyswitch import SPKeys, create_sp_galois_keys, create_sp_relin_keys, sp_relinearize
from .galois import apply_galois, create_galois_keys, rotate_columns, rotate_rows

__all__ = [
    "EncryptionParameters",
    "SCHEME_BFV",
    "BFVContext",
    "Plaintext",
    "Ciphertext",
    "KeyGenerator",
    "PublicKey",
    "SecretKey",
    "Encryptor",
    "Evaluator",
    "Decryptor",
    "BatchEncoder",
    "SPKeys",
    "create_sp_relin_keys",
    "create_sp_galois_keys",
    "sp_relinearize",
    "create_galois_keys",
    "apply_galois",
    "rotate_rows",
    "rotate_columns",
]
