"""The networked layer across packages on the seal profile, the pairs with
the port as the server: a reference client against a port server, near and
far, and a reference tc leg/opt against the port's ts, at -d 12 -b 40,
r = 32, on the CPU (see ``test_torch_network_seal.py``).
"""

import pytest

from test_torch_network import PAIRS, netmain_pair, sweep_pair


@pytest.mark.parametrize("pair", PAIRS, ids=["near", "far"])
def test_seal_reference_client_port_server(pair):
    netmain_pair("seal", False, pair)


@pytest.mark.parametrize("send_pk", [True, False], ids=["leg", "opt"])
def test_seal_reference_tc_port_ts(send_pk):
    sweep_pair("seal", False, send_pk, PAIRS[0])
