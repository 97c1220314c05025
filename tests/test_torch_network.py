"""The port's networked layer against the reference's, on the CPU.

Both roles run on threads over ``socket.socketpair()`` (or 127.0.0.1 for the
CLI), as ``tests/test_network.py`` runs the reference, at -d 12 -b 40 and
r = 32 on the tpu profile (``test_torch_network_seal.py`` holds the seal
cases, so that the reference's m62 compile lands on another worker):

* the transport: round trip, refused headers (malformed, over the cap),
  ``send_frame_stream``'s length check and its bytes, equal to
  ``send_frame``'s and to the reference ``Channel``'s, and ``send_bf``'s;
* the sweep's radius negotiation frame, port to port and across packages;
* cross-package pairs: a port client against a reference server and the
  reverse (``protocol.netmain``), and the port's tc leg/opt against a
  reference ts and the reverse (``benchmark.sweep``); each exchange
  completes and the verdict is the clear oracle's;
* the CSVs of a port tc/ts sweep over TCP, whose headers and columns equal
  the reference's ``parse2csv_*`` output, and the CLI's ``client`` and
  ``server`` over TCP.
"""

import csv
import socket
import threading
import time

import pytest

from pplp_tpu.benchmark import harness as rharness
from pplp_tpu.benchmark import sweep as rsweep
from pplp_tpu.protocol import netmain as rnetmain
from pplp_tpu.protocol.config import ProtocolConfig as RProtocolConfig
from pplp_tpu.protocol.transport import Channel as RChannel
from pplp_tpu_torch import cli
from pplp_tpu_torch.benchmark import harness, sweep
from pplp_tpu_torch.protocol import netmain
from pplp_tpu_torch.protocol.config import ProtocolConfig
from pplp_tpu_torch.protocol.roles import ProximityClient, ProximityServer, send_bf
from pplp_tpu_torch.protocol.transport import Channel

SMALL = dict(poly_modulus_degree_bits=12, plain_modulus_bits=40, radius=32,
             false_positive_probability=1e-4, seed=1212)
# (xa, ya, xb, yb): d^2 = 500 < 32^2 (near) and d^2 = 2,000 > 32^2 (far).
PAIRS = [(1010, 1020, 1000, 1000), (1040, 1020, 1000, 1000)]


def run_pair(client_fn, server_fn, client_cls=Channel, server_cls=Channel):
    """client_fn(chan) here and server_fn(chan) on a thread, over a socket
    pair; returns (client result, server result, client chan, server chan)."""
    a, b = socket.socketpair()
    ca, cb = client_cls(a), server_cls(b)
    out, err = {}, []

    def serve():
        try:
            out["server"] = server_fn(cb)
        except Exception as e:  # reported by the assert below
            err.append(e)

    th = threading.Thread(target=serve)
    th.start()
    try:
        client = client_fn(ca)
    finally:
        th.join(timeout=300)
        a.close()
        b.close()
    assert not th.is_alive(), "the server thread did not finish"
    assert not err, err
    return client, out["server"], ca, cb


def _cfgs(profile, xa, ya, xb, yb):
    kw = dict(SMALL, profile=profile)
    return (dict(kw, xa=xa, ya=ya), dict(kw, xb=xb, yb=yb))


def _oracle(xa, ya, xb, yb, radius):
    return (xa - xb) ** 2 + (ya - yb) ** 2 < radius * radius


def netmain_pair(profile, port_client: bool, pair):
    """A port client against a reference server, or the reverse: the
    verdict is the clear oracle's, the blind distance s(d^2 + r) mod t with
    the server's blinding, and the byte counts agree."""
    xa, ya, xb, yb = pair
    ckw, skw = _cfgs(profile, *pair)
    if port_client:
        client_fn = lambda ch: netmain.run_client_protocol(  # noqa: E731
            ch, ProtocolConfig(**ckw), verbose=False, device="cpu")
        server_fn = lambda ch: rnetmain.run_server_protocol(  # noqa: E731
            ch, RProtocolConfig(**skw), verbose=False)
        classes = dict(client_cls=Channel, server_cls=RChannel)
    else:
        client_fn = lambda ch: rnetmain.run_client_protocol(  # noqa: E731
            ch, RProtocolConfig(**ckw), verbose=False)
        server_fn = lambda ch: netmain.run_server_protocol(  # noqa: E731
            ch, ProtocolConfig(**skw), verbose=False, device="cpu")
        classes = dict(client_cls=RChannel, server_cls=Channel)
    client, server, ca, cb = run_pair(client_fn, server_fn, **classes)
    radius, t = SMALL["radius"], 1 << SMALL["plain_modulus_bits"]
    assert client.is_near == _oracle(xa, ya, xb, yb, radius)
    bl = server.blinding
    assert client.blind_distance == bl.s * ((xa - xb) ** 2 + (ya - yb) ** 2 + bl.r) % t
    assert (ca.bytes_sent, ca.bytes_received) == (cb.bytes_received, cb.bytes_sent)
    # parms and three ciphertexts out; w || BF and one ciphertext back.
    ct_bytes = (ca.bytes_sent - 4 * 128 - len(client.parms_message())) // 3
    assert ca.bytes_received == 2 * 128 + 8 + server.bf.compute_serialization_size() + ct_bytes
    return client, server


def sweep_pair(profile, port_client: bool, send_pk: bool, pair):
    """One tc/ts radius, leg (pk sent) or opt, across packages: the exchange
    completes, the verdict is the clear oracle's and the traffic counts of
    both sides agree."""
    xa, ya, xb, yb = pair
    ckw, skw = _cfgs(profile, *pair)
    if port_client:
        client_fn = lambda ch: sweep._run_client(  # noqa: E731
            ch, ProtocolConfig(**ckw), send_pk, device="cpu")
        server_fn = lambda ch: rsweep._run_server(  # noqa: E731
            ch, RProtocolConfig(**skw), send_pk)
        classes = dict(client_cls=Channel, server_cls=RChannel)
    else:
        client_fn = lambda ch: rsweep._run_client(  # noqa: E731
            ch, RProtocolConfig(**ckw), send_pk)
        server_fn = lambda ch: sweep._run_server(  # noqa: E731
            ch, ProtocolConfig(**skw), send_pk, device="cpu")
        classes = dict(client_cls=RChannel, server_cls=Channel)
    (traffic, dur, client), sdur, ca, cb = run_pair(client_fn, server_fn, **classes)
    assert client.is_near == _oracle(xa, ya, xb, yb, SMALL["radius"])
    assert traffic.c_total == traffic.c_totalSend + traffic.c_totalRecv
    assert (traffic.c_sendPk > 0) == send_pk
    assert ca.bytes_sent == cb.bytes_received == traffic.c_totalSend + 128 * (4 + send_pk)
    assert ca.bytes_received == cb.bytes_sent == traffic.c_totalRecv + 128 * 2
    assert sdur.d_setBF > 0 and sdur.d_homoCalc > 0 and dur.d_total > 0


@pytest.mark.parametrize("pair", PAIRS, ids=["near", "far"])
@pytest.mark.parametrize("port_client", [True, False], ids=["port-client", "port-server"])
def test_netmain_pairs_across_packages(port_client, pair):
    netmain_pair("tpu", port_client, pair)


@pytest.mark.parametrize("send_pk", [True, False], ids=["leg", "opt"])
@pytest.mark.parametrize("port_client", [True, False], ids=["port-tc", "port-ts"])
def test_sweep_pairs_across_packages(port_client, send_pk):
    sweep_pair("tpu", port_client, send_pk, PAIRS[0])


# -- the transport (tests/test_network.py:135-165, on the port's Channel) --


def test_frame_round_trip_and_counts():
    payloads = [b"hello", b"x" * 100_000, b""]

    def client(ch):
        for p in payloads:
            ch.send_frame(p)
        return ch.recv_frame()

    got, _, ca, cb = run_pair(
        client, lambda ch: ch.send_frame(b"ack" + b"".join(ch.recv_frame() for _ in payloads)[:9]))
    assert got == b"ack" + (b"hello" + b"x" * 100_000)[:9]
    assert ca.bytes_sent == cb.bytes_received == 3 * 128 + sum(map(len, payloads))
    assert ca.bytes_received == cb.bytes_sent == 128 + 12


def test_malformed_frame_header_rejected():
    for header, match in ((b"notanumber", "malformed frame header"),
                          (str(Channel.MAX_FRAME + 1).encode(), "exceeds cap")):
        a, b = socket.socketpair()
        try:
            a.sendall(header.ljust(128, b"\x00"))
            with pytest.raises(ConnectionError, match=match):
                Channel(b).recv_frame()
        finally:
            a.close()
            b.close()
    assert Channel.MAX_FRAME == RChannel.MAX_FRAME == 1 << 32


def _wire(send):
    """The bytes ``send(channel)`` puts on a socket pair."""
    a, b = socket.socketpair()
    try:
        send(Channel(a))
        a.shutdown(socket.SHUT_WR)
        return b"".join(iter(lambda: b.recv(1 << 16), b""))
    finally:
        a.close()
        b.close()


def test_send_frame_stream_bytes_and_length_check():
    """The streamed frame's wire bytes equal ``send_frame``'s and the
    reference Channel's; a stream shorter or longer than declared raises."""
    chunks = [b"w" * 8, b"", b"abc" * 1000, b"z"]
    wire = {name: _wire(send) for name, send in (
        ("frame", lambda ch: ch.send_frame(b"".join(chunks))),
        ("stream", lambda ch: ch.send_frame_stream(sum(map(len, chunks)), iter(chunks))),
        ("reference", lambda ch: RChannel(ch.sock).send_frame_stream(
            sum(map(len, chunks)), iter(chunks))),
    )}
    assert wire["frame"] == wire["stream"] == wire["reference"]
    assert wire["frame"][:128].rstrip(b"\x00") == str(3009).encode()
    for declared in (3008, 3010):
        a, b = socket.socketpair()
        try:
            with pytest.raises(ConnectionError, match="stream length mismatch"):
                Channel(a).send_frame_stream(declared, iter(chunks))
        finally:
            a.close()
            b.close()


def test_send_bf_streams_the_bf_message():
    """``send_bf`` streams w || BF from the filter: one frame, the same wire
    bytes as ``send_frame(server.bf_message())``."""
    client = ProximityClient(ProtocolConfig(**dict(SMALL, profile="tpu")), "cpu")
    server = ProximityServer(ProtocolConfig(**dict(SMALL, profile="tpu")), "cpu")
    server.receive_parms(client.parms_message())
    server.build_bloom_filter()
    streamed = _wire(lambda ch: send_bf(ch, server))
    assert streamed == _wire(lambda ch: ch.send_frame(server.bf_message()))
    assert len(streamed) == 128 + 8 + server.bf.compute_serialization_size()


@pytest.mark.parametrize("announce,receive", [
    (sweep._announce_radii, sweep._recv_radii),
    (sweep._announce_radii, rsweep._recv_radii),
    (rsweep._announce_radii, sweep._recv_radii),
], ids=["port", "port-to-reference", "reference-to-port"])
def test_radius_negotiation_frame(announce, receive):
    """tc announces the sweep; ts iterates exactly that list."""
    a, b = socket.socketpair()
    try:
        announce(Channel(a), [16, 32, 64, 4096])
        assert receive(Channel(b)) == [16, 32, 64, 4096]
    finally:
        a.close()
        b.close()
    assert sweep.RADIUS_SWEEP == rsweep.RADIUS_SWEEP == [16 << i for i in range(9)]


# -- the entry points over TCP on 127.0.0.1 ----------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _patient_connect(connect):
    """``connect`` retried until the peer's thread listens (at most 60 s)."""
    def retry(*args, **kw):
        deadline = time.monotonic() + 60
        while True:
            try:
                return connect(*args, **kw)
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
    return retry


def _run_cli(server_argv, client_argv):
    """The server's CLI on a thread, the client's here; both exit codes."""
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("server", cli.main(server_argv)))
    th.start()
    try:
        rc["client"] = cli.main(client_argv)
    finally:
        th.join(timeout=300)
    assert not th.is_alive(), "the server's CLI did not finish"
    return rc


def test_cli_client_server_over_tcp(monkeypatch, capsys):
    """``client`` and ``server`` over TCP, at the client's default t = 2^56:
    the server CLI has no -b and blinds for its own default t, as the
    reference's does, so a client at another t would get a wrong verdict."""
    monkeypatch.setattr(netmain, "connect_to_server", _patient_connect(netmain.connect_to_server))
    port = str(_free_port())
    common = ["-p", port, "-r", "32", "--profile", "tpu", "--device", "cpu"]
    rc = _run_cli(["server", "-x", "1000", "-y", "1000", *common],
                  ["client", "-x", "1010", "-y", "1020", "-d", "12", *common])
    assert rc == {"server": 0, "client": 0}
    out = capsys.readouterr().out.splitlines()
    assert "Result of proximity test: near" in out
    assert "Send w || BF" in out and "Recv 3 ciphertexts" in out


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_tc_ts_sweep_writes_the_reference_csvs(monkeypatch, tmp_path, capsys):
    """A port tc/ts pair over TCP (r = 16 and 32, leg then opt, prewarm on):
    four CSVs whose headers equal the reference's ``parse2csv_*`` output,
    one row per radius, the traffic totals consistent."""
    monkeypatch.setenv("PPLP_SWEEP_MAX_RADIUS", "32")
    monkeypatch.setattr(sweep, "connect_to_server", _patient_connect(sweep.connect_to_server))
    port = str(_free_port())
    common = ["-p", port, "--profile", "tpu", "--device", "cpu"]
    out = {k: str(tmp_path / f"{k}.csv") for k in ("cl", "co", "sl", "so")}
    rc = _run_cli(
        ["ts", "-x", "1000", "-y", "1000", "--out-leg", out["sl"], "--out-opt", out["so"],
         *common],
        ["tc", "-x", "1010", "-y", "1020", "-d", "12", "--out-leg", out["cl"],
         "--out-opt", out["co"], *common])
    assert rc == {"server": 0, "client": 0}
    lines = capsys.readouterr().out.splitlines()
    for role in ("tc", "ts"):
        assert any(x.startswith(f"{role} prewarm done in") for x in lines), role
    # The reference's headers, written by its own emitters.
    ref = {}
    for key, emit, args in (
        ("cl", rharness.parse2csv_client_leg, (rharness.TrafficLoad(), rharness.DurationClient())),
        ("co", rharness.parse2csv_client_opt, (rharness.TrafficLoad(), rharness.DurationClient())),
        ("sl", rharness.parse2csv_server_leg, (rharness.DurationServer(),)),
        ("so", rharness.parse2csv_server_opt, (rharness.DurationServer(),)),
    ):
        emit(str(tmp_path / f"ref_{key}.csv"), 16, True, *args)
        ref[key] = _read_csv(tmp_path / f"ref_{key}.csv")[0]
    for key, path in out.items():
        rows = _read_csv(path)
        assert rows[0] == ref[key], key
        assert [r[0] for r in rows[1:]] == ["16", "32"], key
        for row in rows[1:]:
            rec = dict(zip(rows[0], map(int, row)))
            if key in ("cl", "co"):
                assert rec["c_total"] == rec["c_totalSend"] + rec["c_totalRecv"]
                assert (rec["c_sendPk"] > 0) == (key == "cl")
            else:
                assert rec["d_setBF"] > 0 and rec["d_homoCalc"] > 0


def test_harness_copy_writes_the_reference_files(tmp_path):
    """The port's four emitters write the same files as the reference's on
    the same records, header row and appended rows."""
    vals = lambda cls: {f: i * 7 + 1 for i, f in enumerate(cls.__dataclass_fields__)}  # noqa: E731
    for name, recs in (
        ("parse2csv_client_leg", ("TrafficLoad", "DurationClient")),
        ("parse2csv_client_opt", ("TrafficLoad", "DurationClient")),
        ("parse2csv_server_leg", ("DurationServer",)),
        ("parse2csv_server_opt", ("DurationServer",)),
    ):
        for mod, tag in ((harness, "port"), (rharness, "ref")):
            args = [getattr(mod, r)(**vals(getattr(mod, r))) for r in recs]
            for i, radius in enumerate((16, 32, 64)):
                getattr(mod, name)(str(tmp_path / f"{tag}_{name}.csv"), radius, i == 0, *args)
        assert ((tmp_path / f"port_{name}.csv").read_text()
                == (tmp_path / f"ref_{name}.csv").read_text()), name

