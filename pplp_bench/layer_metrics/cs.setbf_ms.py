"""Mean host-clock milliseconds of the server's ``setBF`` stage (its filter
built and filled on the sub-slice route), as the server process's own
``sweep.run_server`` timed it, over the sessions before the profiler
started (a client/server cell)."""

from pplp_bench.readers import stage_ms

read = stage_ms("server.setBF")
