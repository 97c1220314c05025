"""90th percentile of the host-clock milliseconds of a step, from its
launch to its verdicts on the host, over the steps before the profiler
started (a device-bound cell)."""

from pplp_bench.readers import unit_ms_p90 as read  # noqa: F401
