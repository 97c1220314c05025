"""Mean host-clock milliseconds a test spends in the BFV stages ``kGen`` +
``enc`` + ``homoCalc``, over the tests before the profiler started."""

from pplp_bench.readers import stage_ms

read = stage_ms("kGen", "enc", "homoCalc")
