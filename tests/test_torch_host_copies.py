"""The port's copies of host-only modules against their originals, on the CPU.

* ``utils.csvwriter``: the same inputs give the same strings and files as
  ``pplp_tpu.utils.csvwriter``;
* ``utils.profiling.StageTimer``: the same stages on the same clock give the
  same report, with ``block_on`` given as tensors or as a device;
* the packages ``utils`` and ``benchmark`` and the module
  ``protocol.netmain`` export the reference's names.
"""

import time

import pytest
import torch

from pplp_tpu.utils import csvwriter as rcsvwriter
from pplp_tpu.utils import profiling as rprofiling
from pplp_tpu_torch.utils import csvwriter, profiling

ROWS = [[1, "plain", 2.5], ["a,b", 'say "hi"', "two\nlines"], [], [0]]


def _write(mod, path, append_rows):
    w = mod.CSVWriter(",")
    for row in ROWS:
        w.new_row().add_all(*row)
    w.write_to_file(str(path))
    more = mod.CSVWriter(";")
    more.add("first").add("x;y")
    for row in append_rows:
        more.new_row().add_all(*row)
    more.write_to_file(str(path), append=True)
    return w.to_string(), more.to_string()


def test_csvwriter_matches_reference(tmp_path):
    extra = [[3, 4], ["", None]]
    assert (_write(csvwriter, tmp_path / "port.csv", extra)
            == _write(rcsvwriter, tmp_path / "ref.csv", extra))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "ref.csv").read_text()
    empty = tmp_path / "empty.csv"
    csvwriter.CSVWriter().write_to_file(str(empty))
    assert empty.read_text() == ""


@pytest.mark.parametrize("block_on", [torch.ones(3), [torch.ones(2), 5], torch.device("cpu")],
                         ids=["tensor", "tensors", "device"])
def test_stage_timer_matches_reference(monkeypatch, block_on):
    """On a clock that ticks 1.5 ms a reading, the same stages give the same
    ``ns`` and report; a stage waits for the device that ``block_on`` names
    or holds its tensors (on the CPU, none)."""
    tick = iter(range(0, 10**12, 1_500_000))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(tick))
    reports = []
    for mod, block in ((profiling, block_on), (rprofiling, None)):
        timer, out = mod.StageTimer(), []
        for name in ("kGen", "enc", "kGen"):
            with timer.stage(name, block_on=block):
                pass
        timer.report(out=out.append)
        reports.append((dict(timer.ns), out))
    assert reports[0] == reports[1]
    assert reports[0][1][0] == "d_kGen\t3.000ms"


def test_package_exports_match_reference():
    """``utils``, ``benchmark`` and ``protocol.netmain`` export the reference's
    names, and nothing more."""
    import pplp_tpu.benchmark as rbenchmark
    import pplp_tpu.protocol.netmain as rnetmain
    import pplp_tpu.utils as rutils

    import pplp_tpu_torch.benchmark as benchmark
    import pplp_tpu_torch.protocol.netmain as netmain
    import pplp_tpu_torch.utils as utils

    for ours, theirs in ((utils, rutils), (benchmark, rbenchmark), (netmain, rnetmain),
                         (csvwriter, rcsvwriter)):
        assert sorted(ours.__all__) == sorted(theirs.__all__), ours.__name__
    assert set(profiling.__all__) < set(rprofiling.__all__)
