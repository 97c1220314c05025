"""Modular arithmetic, the NTT and its CUDA kernel wrapper."""
