"""pplp_tpu_torch — the proximity protocol in PyTorch, with CUDA kernels.

A port of ``pplp_tpu`` (JAX/Pallas) to PyTorch and CUDA on NVIDIA Hopper.
``pplp_tpu`` stays the reference; this package imports torch and never jax.
It covers the local demo (``python -m pplp_tpu_torch.cli demo``): BFV keygen,
encryption, the homomorphic blind distance, decryption and the Bloom-filter
probe, on the ``tpu`` coefficient-modulus profile (primes below 2^30). Every
NTT on a CUDA tensor runs the hand-written kernel in ``csrc/ntt.cu``.
"""

__version__ = "0.1.0"
