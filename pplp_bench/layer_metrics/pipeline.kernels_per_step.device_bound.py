"""Kernels the device ran a step, over the traced steps (copies left out;
a device-bound cell)."""

from pplp_bench.readers import kernels_per_step as read  # noqa: F401
