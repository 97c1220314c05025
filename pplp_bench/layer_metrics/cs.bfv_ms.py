"""Mean host-clock milliseconds a session spends in the BFV stages: the
client's ``kGen`` + ``enc`` and the server's ``homoCalc`` (as the server
process's own ``sweep.run_server`` timed it), over the sessions before the
profiler started (a client/server cell)."""

from pplp_bench.readers import stage_ms

read = stage_ms("kGen", "enc", "server.homoCalc")
