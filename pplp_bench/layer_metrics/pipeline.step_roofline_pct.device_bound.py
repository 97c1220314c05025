"""The packed step's share of its roofline (``readers.step_roofline_pct``;
a device-bound cell)."""

from pplp_bench.readers import step_roofline_pct as read  # noqa: F401
