"""DGK additively-homomorphic cryptosystem back-end (reference C14-C18).

Damgård–Geisler–Krøigaard encryption over Z_n* with small prime message space
u: c = g^m * h^r mod n. Host keygen uses Maurer provable primes (as the
reference's vendored C does); decryption replaces the reference's linear
65536-entry table scan with a hash-map lookup and offers the Pohlig–Hellman
discrete-log path as the alternative decryptor.

Port of ``pplp_tpu.dgk`` with the same exports. The host modules (``dgk``,
``maurer``, ``gdsa``, ``ph``) are copies; the batched path
(``batched.DGKBatch``) runs its exponentiations in the hand-written kernel
``csrc/dgk_mont.cu`` on a CUDA device and in ``modexp`` on the CPU.
"""

from .dgk import DGKPublicKey, DGKPrivateKey, dgk_gen_keys, dgk_encrypt, dgk_decrypt
from .maurer import maurer, prime_prod
from .gdsa import gdsa_prime, get_invertible_num

__all__ = [
    "DGKPublicKey",
    "DGKPrivateKey",
    "dgk_gen_keys",
    "dgk_encrypt",
    "dgk_decrypt",
    "maurer",
    "prime_prod",
    "gdsa_prime",
    "get_invertible_num",
]
