"""Share of the traced stretch in which no kernel and no copy ran on the
device (a demo cell)."""

from pplp_bench.readers import idle_pct as read  # noqa: F401
