"""The port's networked layer against the reference's, on the CPU.

Both roles run on threads over ``socket.socketpair()`` (or 127.0.0.1 for the
CLI), as ``tests/test_network.py`` runs the reference, at -d 12 -b 40 and
r = 32 on the tpu profile (``test_torch_network_seal.py`` holds the seal
cases, so that the reference's m62 compile lands on another worker):

* the transport: round trip, refused headers (malformed, over the cap),
  ``send_frame``'s bytes, of ``bytes`` and of a read-only view, equal to
  the reference ``Channel``'s, and ``send_bf``'s frame equal to the
  reference's ``send_bf``;
* the sweep's radius negotiation frame, port to port and across packages;
* cross-package pairs: a port client against a reference server and the
  reverse (``protocol.netmain``), and the port's tc leg/opt against a
  reference ts and the reverse (``benchmark.sweep``); each exchange
  completes and the verdict is the clear oracle's;
* the CSVs of a port tc/ts sweep over TCP, whose headers and columns equal
  the reference's ``parse2csv_*`` output, and the CLI's ``client`` and
  ``server`` over TCP;
* one opt session over loopback TCP with the server's blinding and the
  client's key seed given (the benchmark's client/server cell): its blind
  distance, verdict and raw filter frame against ``pplp_bench``'s plain
  reference; the transport's timeouts and a listener kept open for the next
  connection; the ``transport.*`` program spans.
"""

import csv
import socket
import threading
import time

import numpy as np
import pytest

from pplp_tpu.benchmark import harness as rharness
from pplp_tpu.benchmark import sweep as rsweep
from pplp_tpu.protocol import netmain as rnetmain
from pplp_tpu.protocol.config import ProtocolConfig as RProtocolConfig
from pplp_tpu.protocol.roles import ProximityServer as RServer
from pplp_tpu.protocol.roles import send_bf as rsend_bf
from pplp_tpu.protocol.transport import Channel as RChannel
from pplp_tpu_torch import cli
from pplp_tpu_torch.benchmark import harness, sweep
from pplp_tpu_torch.protocol import netmain
from pplp_tpu_torch.protocol.config import ProtocolConfig
from pplp_tpu_torch.protocol.roles import ProximityClient, ProximityServer, send_bf
from pplp_tpu_torch.primitives import Blinding
from pplp_tpu_torch.protocol import transport
from pplp_tpu_torch.protocol.transport import Channel
from pplp_tpu_torch.utils import profiling
from pplp_bench.reference import frames as ref_frames
from pplp_bench.reference import proximity as ref_proximity
from pplp_bench.traffic import DemoTraffic

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
        client_fn = lambda ch: sweep.run_client(  # noqa: E731
            ch, ProtocolConfig(**ckw), send_pk, device="cpu")
        server_fn = lambda ch: rsweep._run_server(  # noqa: E731
            ch, RProtocolConfig(**skw), send_pk)
        classes = dict(client_cls=Channel, server_cls=RChannel)
    else:
        client_fn = lambda ch: rsweep._run_client(  # noqa: E731
            ch, RProtocolConfig(**ckw), send_pk)
        server_fn = lambda ch: sweep.run_server(  # noqa: E731
            ch, ProtocolConfig(**skw), send_pk, device="cpu")
        classes = dict(client_cls=RChannel, server_cls=Channel)
    (traffic, dur, client, *_), sdur, ca, cb = run_pair(client_fn, server_fn, **classes)
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


@pytest.mark.parametrize("port_server", [True, False], ids=["port-server", "reference-server"])
def test_client_t_differs_from_the_server_default(port_server):
    """A port client at -b 40 against a server left at its default t = 2^56
    (the server CLI has no -b), near pair, the same seed. The port's server
    blinds for the t of the parameters it receives: s(d^2 + r) < 2^40, and
    the client reads near. The reference's blinds for its own t: the blind
    distance wraps mod 2^40 and the client reads far (the reference's fault,
    left as it is)."""
    xa, ya, xb, yb = PAIRS[0]
    ckw, skw = _cfgs("tpu", *PAIRS[0])
    del skw["plain_modulus_bits"]
    t = 1 << SMALL["plain_modulus_bits"]
    client_fn = lambda ch: netmain.run_client_protocol(  # noqa: E731
        ch, ProtocolConfig(**ckw), verbose=False, device="cpu")
    if port_server:
        server_fn = lambda ch: netmain.run_server_protocol(  # noqa: E731
            ch, ProtocolConfig(**skw), verbose=False, device="cpu")
    else:
        server_fn = lambda ch: rnetmain.run_server_protocol(  # noqa: E731
            ch, RProtocolConfig(**skw), verbose=False)
    client, server, _, _ = run_pair(client_fn, server_fn,
                                    server_cls=Channel if port_server else RChannel)
    bl, d2 = server.blinding, (xa - xb) ** 2 + (ya - yb) ** 2
    assert client.blind_distance == bl.s * (d2 + bl.r) % t
    assert (bl.s * (d2 + bl.r) < t) == port_server
    assert client.is_near == port_server


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


def test_send_frame_of_bytes_and_a_read_only_view_matches_reference():
    """``send_frame`` of ``bytes`` and of a read-only ``memoryview`` of one
    host buffer (what ``bf_message`` returns) puts the reference Channel's
    ``send_frame`` and ``send_frame_stream`` bytes on the wire, and counts
    them."""
    chunks = [b"w" * 8, b"", b"abc" * 1000, b"z"]
    payload = b"".join(chunks)
    buf = np.frombuffer(payload, np.uint8).copy()
    buf.flags.writeable = False
    view = memoryview(buf)
    assert view.readonly and len(view) == len(payload)
    sent = {}

    def send_view(ch):
        sent["n"] = ch.send_frame(view)
        sent["bytes_sent"] = ch.bytes_sent

    wire = {name: _wire(send) for name, send in (
        ("bytes", lambda ch: ch.send_frame(payload)),
        ("view", send_view),
        ("reference", lambda ch: RChannel(ch.sock).send_frame(payload)),
        ("reference-stream", lambda ch: RChannel(ch.sock).send_frame_stream(
            len(payload), iter(chunks))),
    )}
    assert wire["bytes"] == wire["view"] == wire["reference"] == wire["reference-stream"]
    assert wire["bytes"] == ref_frames.frame(payload)
    assert wire["bytes"][:128].rstrip(b"\x00") == str(3009).encode()
    assert sent == {"n": 3009, "bytes_sent": 128 + 3009}


def test_send_bf_streams_the_bf_message():
    """``send_bf`` puts ``bf_message()`` on the socket as one frame, the
    wire bytes of the reference's ``send_bf`` (which streams the table): one
    ``roles.bf_join``, one ``bloom.table_to_host`` and one
    ``transport.send_frame`` of the whole message."""
    kw = dict(SMALL, profile="tpu")
    client = ProximityClient(ProtocolConfig(**kw), "cpu")
    server, rserver = ProximityServer(ProtocolConfig(**kw), "cpu"), RServer(RProtocolConfig(**kw))
    for s in (server, rserver):
        s.receive_parms(client.parms_message())
        s.build_bloom_filter()
    size = 8 + server.bf.compute_serialization_size()
    profiling.drain()
    profiling.enable()
    try:
        wire = _wire(lambda ch: send_bf(ch, server))
    finally:
        profiling.disable()
    spans = [(s.name, s.attrs) for s in profiling.drain()]
    assert wire == _wire(lambda ch: rsend_bf(RChannel(ch.sock), rserver))
    assert wire == ref_frames.frame(bytes(server.bf_message())) and len(wire) == 128 + size
    assert spans == [("roles.bf_join", {"bytes": size}),
                     ("bloom.table_to_host", {"bytes": server.bf.table_size // 8, "pinned": 0}),
                     ("transport.send_frame", {"bytes": size})]


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
    """``client`` and ``server`` over TCP, at the client's default t = 2^56
    (the server CLI has no -b; it blinds for the t the client sends)."""
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



# -- one opt session against the plain reference; timeouts; spans -----------

# The client/server cell's deployment at a CPU size: seal, n = 4096, t = 2^40.
CS = dict(profile="seal", poly_modulus_degree_bits=12, plain_modulus_bits=40,
          false_positive_probability=1e-4)
CS_MIX = {"radius": 16, "near_share": 0.5, "far_radius_factor": 4, "coordinate_span": 4096}


def _loopback_session(server_fn, client_fn, timeout=120):
    """server_fn(chan) on a thread behind a listener on 127.0.0.1, client_fn(chan)
    here over TCP; (client result, server result)."""
    listener = transport.listen("127.0.0.1", 0)
    out, err = {}, []

    def serve():
        try:
            out["server"] = server_fn(transport.accept(listener, timeout))
        except Exception as e:  # reported by the assert below
            err.append(e)

    th = threading.Thread(target=serve)
    th.start()
    try:
        chan = transport.connect_to_server("127.0.0.1", listener.getsockname()[1],
                                           timeout=timeout)
        try:
            client = client_fn(chan)
        finally:
            chan.close()
    finally:
        th.join(timeout=300)
        listener.close()
    assert not th.is_alive(), "the server thread did not finish"
    assert not err, err
    return client, out["server"]


@pytest.mark.parametrize("near", [True, False], ids=["near", "far"])
@pytest.mark.parametrize("seed", [5, 2**31 + 7, 2**40 + 3])
def test_opt_session_matches_the_plain_reference(seed, near):
    """The opt session with the server's blinding and the client's key seed
    given: the blind distance s(d^2 + r) mod t, the verdict, and the w ||
    filter frame as the client read it, header included, are the plain
    reference's (``pplp_bench/reference``)."""
    traffic = DemoTraffic(CS_MIX, CS["plain_modulus_bits"], seed)
    test = next(traffic.test(i) for i in range(8) if traffic.test(i).near == near)
    radius, t = CS_MIX["radius"], 1 << CS["plain_modulus_bits"]
    session, sdur = _loopback_session(
        lambda ch: sweep.run_server(ch, ProtocolConfig(xb=test.xb, yb=test.yb, radius=radius, **CS),
                                    recv_pk=False, device="cpu",
                                    blinding=Blinding(r=test.r, s=test.s, w=test.w)),
        lambda ch: sweep.run_client(ch, ProtocolConfig(xa=test.xa, ya=test.ya, radius=radius,
                                                       seed=test.key_seed, **CS),
                                    send_pk=False, device="cpu"))
    want = ref_proximity.demo_test(test, radius, t, CS["false_positive_probability"],
                                   ProtocolConfig.bf_seed, True, "cpu", wire=True)
    client = session.client
    assert client.blind_distance == want["blind_distance"] == test.s * (test.d2 + test.r) % t
    assert client.is_near == want["near"] == near and client.decrypt_consistent
    header, payload = session.bf_frame
    assert header + payload == ref_frames.frame(want["wire"])
    assert session.traffic.c_recvBF == len(payload) and sdur.d_setBF > 0


@pytest.mark.parametrize("send_pk", [True, False], ids=["leg", "opt"])
def test_sessions_without_blinding_keep_the_csv_columns(tmp_path, send_pk):
    """Without a blinding or a key seed, tc's and ts's session functions give
    the records whose CSVs have the reference's columns."""
    ckw, skw = _cfgs("tpu", *PAIRS[0])
    kind = "leg" if send_pk else "opt"
    client_fn = getattr(sweep, f"test_client_{kind}")
    server_fn = getattr(sweep, f"test_server_{kind}")
    (traffic, dur), sdur, _, _ = run_pair(
        lambda ch: client_fn(ch, SMALL["radius"], ckw["xa"], ckw["ya"], 12, 40, "tpu",
                             device="cpu"),
        lambda ch: server_fn(ch, SMALL["radius"], skw["xb"], skw["yb"], "tpu", device="cpu"))
    for key, emit, rec, args in (
        ("client", f"parse2csv_client_{kind}", (traffic, dur),
         (rharness.TrafficLoad(), rharness.DurationClient())),
        ("server", f"parse2csv_server_{kind}", (sdur,), (rharness.DurationServer(),)),
    ):
        getattr(harness, emit)(str(tmp_path / f"{key}.csv"), SMALL["radius"], True, *rec)
        getattr(rharness, emit)(str(tmp_path / f"ref_{key}.csv"), SMALL["radius"], True, *args)
        got, ref = _read_csv(tmp_path / f"{key}.csv"), _read_csv(tmp_path / f"ref_{key}.csv")
        assert got[0] == ref[0] and len(got[1]) == len(ref[1]), key


def _silent_sender(a, b):
    """A frame far larger than the socket buffers, to a peer that never reads."""
    Channel(a, timeout=0.5).send_frame(b"x" * (64 << 20))


@pytest.mark.parametrize("wait,error", [
    (lambda a, b: (b.close(), Channel(a, timeout=5).recv_frame()), ConnectionError),
    (lambda a, b: Channel(a, timeout=0.5).recv_frame(), TimeoutError),
    (_silent_sender, TimeoutError),
    (lambda a, b: transport.accept(transport.listen("127.0.0.1", 0), 0.5), TimeoutError),
], ids=["closed-peer", "silent-peer-recv", "silent-peer-send", "no-peer-accept"])
def test_a_wait_raises_within_its_timeout(wait, error):
    """A closed peer raises at once; a silent one (or none) within the
    timeout set, rather than hanging."""
    a, b = socket.socketpair()
    t0 = time.monotonic()
    try:
        with pytest.raises(error):
            wait(a, b)
    finally:
        a.close()
        b.close()
    assert time.monotonic() - t0 < 5


def test_listener_takes_a_new_connection_after_a_failed_one():
    """A server that keeps its listener accepts the next connection once a
    session fails, and the new connection carries frames."""
    listener = transport.listen("127.0.0.1", 0)
    port = listener.getsockname()[1]
    try:
        transport.connect_to_server("127.0.0.1", port, timeout=5).close()
        first = transport.accept(listener, 5)
        with pytest.raises(ConnectionError, match="peer closed"):
            first.recv_frame()
        first.close()
        client = transport.connect_to_server("127.0.0.1", port, timeout=5)
        second = transport.accept(listener, 5)
        client.send_frame(b"again")
        assert second.recv_frame() == b"again"
        client.close()
        second.close()
    finally:
        listener.close()


def test_frames_are_program_spans_with_their_bytes():
    """With the recorder on, ``send_frame`` and ``recv_frame`` record
    ``transport.send_frame`` and ``transport.recv_frame`` with ``bytes``
    equal to each payload's length."""
    a, b = socket.socketpair()
    payload = b"w" * 8 + b"abc" * 1000
    profiling.drain()
    profiling.enable()
    try:
        ca, cb = Channel(a, timeout=5), Channel(b, timeout=5)
        ca.send_frame(b"hello")
        ca.send_frame(payload)
        assert cb.recv_frame() == b"hello"
        assert cb.recv_frame_with_header() == (ref_frames.header(3008), payload)
    finally:
        profiling.disable()
        a.close()
        b.close()
    got = [(s.name, s.attrs) for s in profiling.drain() if s.name.startswith("transport.")]
    assert got == [("transport.send_frame", {"bytes": 5}),
                   ("transport.send_frame", {"bytes": 3008}),
                   ("transport.recv_frame", {"bytes": 5}),
                   ("transport.recv_frame", {"bytes": 3008})]
