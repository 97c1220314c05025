"""pplp_tpu_torch — the proximity protocol in PyTorch, with CUDA kernels.

A port of ``pplp_tpu`` (JAX/Pallas) to PyTorch and CUDA on NVIDIA Hopper.
``pplp_tpu`` stays the reference; this package imports torch and never jax.
It covers the local demo (``python -m pplp_tpu_torch.cli demo``): BFV keygen,
encryption, the homomorphic blind distance, decryption and the Bloom-filter
probe, on the ``seal`` coefficient-modulus profile (the default: 36-56-bit
primes, ``m62`` arithmetic) and the ``tpu`` one (primes below 2^30, ``m31``);
the coefficient-packed 100k-check pipeline with the device decode and Bloom
probe (``parallel.pipeline``); and the BFV ct x ct multiply with
relinearization, on ``tpu`` only. On a CUDA tensor every NTT runs a
hand-written kernel in ``csrc/ntt.cu`` (u32 or u64 by profile) and the
multiply the one in ``csrc/behz.cu``.
"""

__version__ = "0.1.0"
