"""Mean host-clock milliseconds of a test's ``setBF`` stage (the server's
filter built and filled), over the tests before the profiler started."""

from pplp_bench.readers import stage_ms

read = stage_ms("setBF")
