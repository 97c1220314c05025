"""Interactive networked client/server mains (the reference's ``./client`` and
``./server`` binaries, src/client.cc:24-168 / src/server.cc:24-158).

Counterpart of ``pplp_tpu.protocol.netmain``: the same messages in the same
order and the same printed lines. Message order (client view): send parms;
send 3 cts; recv w‖BF; recv bd ct; decrypt + probe. The pk never crosses
the wire. Each role runs on an explicit torch device.
"""

from __future__ import annotations

import time

from .config import ProtocolConfig
from .roles import ProximityClient, ProximityServer, send_bf
from .transport import Channel, connect_to_client, connect_to_server

__all__ = ["client_main", "server_main", "run_client_protocol", "run_server_protocol"]


def run_client_protocol(chan: Channel, cfg: ProtocolConfig, verbose=True, *, device):
    log = print if verbose else (lambda *a: None)
    begin = time.perf_counter()
    client = ProximityClient(cfg, device)
    chan.send_frame(client.parms_message())
    log(f"Send parms(context), bytes: {chan.bytes_sent}")
    client.keygen()
    for i, blob in enumerate(client.ciphertext_messages()):
        n = chan.send_frame(blob)
        log(f"Send the ciphertext {i}, bytes: {n}")
    bf_blob = chan.recv_frame()
    client.receive_bf(bf_blob)
    log(f"Recv the BF and hash key, bytes: {len(bf_blob)}")
    bd_blob = chan.recv_frame()
    log(f"Recv the encrypted blind distance, bytes: {len(bd_blob)}")
    is_near = client.receive_blind_distance(bd_blob)
    elapsed = time.perf_counter() - begin
    log(f"blind_distance: {client.blind_distance}")
    log(f"Result of proximity test: {'near' if is_near else 'far'}")
    log(f"Time measured: {elapsed:.3f} seconds")
    return client


def run_server_protocol(chan: Channel, cfg: ProtocolConfig, verbose=True, *, device):
    log = print if verbose else (lambda *a: None)
    server = ProximityServer(cfg, device)
    server.receive_parms(chan.recv_frame())
    log("Recv parms")
    # Reference order (server.cc:83-120): BF built before the cts arrive.
    server.build_bloom_filter()
    blobs = [chan.recv_frame() for _ in range(3)]
    server.receive_ciphertexts(blobs)
    log("Recv 3 ciphertexts")
    send_bf(chan, server)
    log("Send w || BF")
    chan.send_frame(server.blind_distance_message())
    log("Send blind distance")
    return server


def client_main(args) -> int:
    cfg = ProtocolConfig(
        xa=args.xa,
        ya=args.ya,
        radius=args.radius,
        plain_modulus_bits=args.plain_modulus_bits,
        poly_modulus_degree_bits=args.poly_modulus_degree,
        false_positive_probability=1e-4,  # src/server.cc:85 parity
        profile=args.profile,
    )
    try:
        chan = connect_to_server(args.host, args.port, ipv6=args.ipv6)
    except OSError as e:
        print(f"connect: {e.strerror or e}")
        return 1
    print("Connected to the server,  proximity test start...")
    print(f"Client's coordinates:\t({cfg.xa}, {cfg.ya})")
    print(f"Radius:\t\t\t\t{cfg.radius}")
    try:
        client = run_client_protocol(chan, cfg, device=args.device)
    finally:
        chan.close()
    return 0 if client.is_near is not None else 1


def server_main(args) -> int:
    cfg = ProtocolConfig(
        xb=args.xb,
        yb=args.yb,
        radius=args.radius,
        false_positive_probability=1e-4,
        profile=args.profile,
    )
    print("listening...............")
    chan = connect_to_client(args.host, args.port, ipv6=args.ipv6)
    print("Connected to client")
    try:
        run_server_protocol(chan, cfg, device=args.device)
    finally:
        chan.close()
    return 0
