"""Mean host-clock milliseconds of the server's ``sendBF`` stage (the
table's copies to the host and ``send_bf``'s streamed frame), as the server
process's own ``sweep.run_server`` timed it, over the sessions before the
profiler started (a client/server cell)."""

from pplp_bench.readers import stage_ms

read = stage_ms("server.sendBF")
