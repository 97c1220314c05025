"""The port's DGK proximity protocol (``dgk.protocol``) against the
reference's on the CPU, at (k, t, l) = (512, 64, 12) with one key pair:
``pplp_dgk`` gives the same verdicts on a near and a far pair (the cases
of ``tests/test_dgk.py``), and ``dgk_sweep_main`` writes the reference's
CSV header and columns, one row per radius, with the same verdicts printed.
"""

import csv

import pytest

from pplp_tpu.dgk import dgk_gen_keys
from pplp_tpu.dgk import protocol as rprotocol
from pplp_tpu_torch.dgk import protocol

K, T, L = 512, 64, 12
# r, (xa, ya, xb, yb), seed: d^2 = 1700 < 44^2 and d^2 = 2000 > 31^2, both
# below u (no wrap mod u).
CASES = {"near": (44, (100, 100, 140, 110), 8), "far": (31, (100, 100, 140, 120), 9)}


@pytest.fixture(scope="module")
def keys():
    return dgk_gen_keys(K, T, L, seed=7)


@pytest.mark.parametrize("case", CASES)
def test_pplp_dgk_matches_reference(keys, case):
    radius, (xa, ya, xb, yb), seed = CASES[case]
    kw = dict(xa=xa, ya=ya, xb=xb, yb=yb, k=K, t=T, l=L, seed=seed, keys=keys)
    got = protocol.pplp_dgk(radius, device="cpu", **kw)
    assert got.is_near == rprotocol.pplp_dgk(radius, **kw).is_near == (case == "near")
    assert len(got.stage_rows()) == len(protocol.DGK_CSV_COLUMNS) - 1
    assert all(v >= 0 for v in got.stage_rows())


def test_dgk_sweep_csv_matches_reference(tmp_path, keys, capsys):
    kw = dict(radii=[16, 32], seed=10, k=K, t=T, l=L, keys=keys)
    assert protocol.dgk_sweep_main(str(tmp_path / "port.csv"), device="cpu", **kw) == 0
    port_out = capsys.readouterr().out
    assert rprotocol.dgk_sweep_main(str(tmp_path / "ref.csv"), **kw) == 0
    assert port_out == capsys.readouterr().out
    with open(tmp_path / "port.csv") as f:
        port = list(csv.reader(f))
    with open(tmp_path / "ref.csv") as f:
        ref = list(csv.reader(f))
    assert port[0] == ref[0] == rprotocol.DGK_CSV_COLUMNS == protocol.DGK_CSV_COLUMNS
    assert port[0][:3] == ["radius ", "d_AkGen", "d_ApreClac"]
    assert [r[0] for r in port[1:]] == [r[0] for r in ref[1:]] == ["16", "32"]
    assert all(len(r) == len(port[0]) for r in port)


def test_dgk_example_matches_reference():
    assert protocol.dgk_example(k=K, t=T, l=L, seed=11)
    assert rprotocol.dgk_example(k=K, t=T, l=L, seed=11)


def test_protocol_defaults_to_the_card():
    import inspect

    for fn in (protocol.pplp_dgk, protocol.dgk_sweep_main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
