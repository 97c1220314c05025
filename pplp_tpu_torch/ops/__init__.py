"""Modular arithmetic, the NTT, and the loader and wrappers of the CUDA
kernels (NTT, BEHZ multiply + relinearization, mulmod chain)."""
