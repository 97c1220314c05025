"""BFV on PyTorch: parameters, context, keys, encrypt, evaluate, decrypt.

Counterpart of ``pplp_tpu.bfv`` for what the proximity protocol uses and
the ct x ct multiply with relinearization (``behz``, ``behz_fused``), on the
``m31`` arithmetic (primes below 2^30).
"""

from .params import EncryptionParameters, SCHEME_BFV
from .context import BFVContext
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import KeyGenerator, PublicKey, SecretKey
from .encryptor import Encryptor
from .evaluator import Evaluator
from .decryptor import Decryptor

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
]
