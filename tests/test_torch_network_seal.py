"""The networked layer across packages on the seal profile (the CLI's
default; m62 arithmetic), at -d 12 -b 40, r = 32, on the CPU: a port client
against a reference server, near and far, and the port's tc leg/opt against
a reference ts. The reverse pairs are in
``test_torch_network_seal_server.py``, the helpers and the tpu cases in
``test_torch_network.py``: the files stand apart so that the reference's m62
compiles (its server's stages here, its client's there) run on separate
workers.
"""

import pytest

from test_torch_network import PAIRS, netmain_pair, sweep_pair


@pytest.mark.parametrize("pair", PAIRS, ids=["near", "far"])
def test_seal_port_client_reference_server(pair):
    netmain_pair("seal", True, pair)


@pytest.mark.parametrize("send_pk", [True, False], ids=["leg", "opt"])
def test_seal_port_tc_reference_ts(send_pk):
    sweep_pair("seal", True, send_pk, PAIRS[0])
