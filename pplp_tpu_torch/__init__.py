"""pplp_tpu_torch — the proximity protocol in PyTorch, with CUDA kernels.

A port of ``pplp_tpu`` (JAX/Pallas) to PyTorch and CUDA on NVIDIA Hopper.
``pplp_tpu`` stays the reference; this package imports torch and never jax.
It covers the local demo (``python -m pplp_tpu_torch.cli demo``): BFV keygen,
encryption, the homomorphic blind distance, decryption and the Bloom-filter
probe; and the BFV ct x ct multiply with relinearization; on the ``tpu``
coefficient-modulus profile (primes below 2^30). On a CUDA tensor every NTT
runs the hand-written kernel in ``csrc/ntt.cu`` and the multiply the one in
``csrc/behz.cu``.
"""

__version__ = "0.1.0"
