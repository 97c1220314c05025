"""Mean host-clock milliseconds of the client's ``dec`` stage (the blind
distance decrypted and probed in the filter received in ``recvBF``), over
the sessions before the profiler started (a client/server cell)."""

from pplp_bench.readers import stage_ms

read = stage_ms("dec")
