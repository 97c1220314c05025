"""Mean host-clock milliseconds of the client's ``recvBF`` stage (the w ||
filter frame read off the socket and ``receive_bf``), over the sessions
before the profiler started (a client/server cell)."""

from pplp_bench.readers import stage_ms

read = stage_ms("recvBF")
