"""Mean host-clock milliseconds of a test's ``dec`` stage (the w || filter
message made, read back into the client's filter, the blind distance
decrypted and probed), over the tests before the profiler started."""

from pplp_bench.readers import stage_ms

read = stage_ms("dec")
