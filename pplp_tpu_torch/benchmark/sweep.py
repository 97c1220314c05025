"""The tc/ts benchmark pair: radius sweep over leg + opt protocol variants.

Counterpart of ``pplp_tpu.benchmark.sweep``, reproducing
``src/test/test_client.cc`` / ``test_server.cc``: for radius in 16, 32, ...,
4096 run the instrumented protocol twice — "leg" (legacy: pk is
transmitted, parms sent after keygen) and "opt" (no pk transfer, parms sent
before keygen) — and emit client_leg/client_opt/server_leg/server_opt CSVs
with the reference's exact schemas. Both sides run on a torch device
(``--device``). Every stage is a ``StageTimer`` stage blocking on that
device: on a card its clock stops after a synchronize, so a stage is
charged the device work it queued, and ts prints the device memory of each radius (its peak, and what is still
held once the radius's server is gone).

``run_client`` and ``run_server`` are one session of either variant, the
one implementation of a tc/ts session. The server may be given its blinding
and the client its key seed (``ProtocolConfig.seed``), so that a session can
be held against a reference; the client hands back the w || filter frame as
it came off the socket.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import torch

from ..bfv.serialize import load_public_key, save_public_key
from ..primitives import Blinding
from ..protocol.config import ProtocolConfig
from ..protocol.demo import run_local_demo
from ..protocol.roles import ProximityClient, ProximityServer, send_bf
from ..protocol.transport import Channel, connect_to_client, connect_to_server
from ..utils.profiling import StageTimer
from .harness import (
    DurationClient,
    DurationServer,
    TrafficLoad,
    parse2csv_client_leg,
    parse2csv_client_opt,
    parse2csv_server_leg,
    parse2csv_server_opt,
)

__all__ = [
    "RADIUS_SWEEP",
    "ClientSession",
    "run_client",
    "run_server",
    "test_client_leg",
    "test_client_opt",
    "test_server_leg",
    "test_server_opt",
    "tc_main",
    "ts_main",
]

RADIUS_SWEEP = [16 << i for i in range(9)]  # 16..4096 (test_client.cc:52-69)


def _radii(args):
    """Reference sweep by default; PPLP_SWEEP_MAX_RADIUS trims it (short
    runs: the r=4096 Bloom build inserts 16.7M keys)."""
    cap = int(os.environ.get("PPLP_SWEEP_MAX_RADIUS", "0"))
    return [r for r in RADIUS_SWEEP if not cap or r <= cap]


def _announce_radii(chan, radii):
    """tc leads the sweep: the radius list crosses the wire once so both
    sides always iterate the same sweep regardless of local env."""
    chan.send_frame(struct.pack(f"<H{len(radii)}I", len(radii), *radii))


def _recv_radii(chan):
    buf = chan.recv_frame()
    (n,) = struct.unpack_from("<H", buf, 0)
    return list(struct.unpack_from(f"<{n}I", buf, 2))


def _client_cfg(radius, xa, ya, d_bits, b_bits, profile):
    return ProtocolConfig(
        xa=xa,
        ya=ya,
        radius=radius,
        plain_modulus_bits=b_bits,
        poly_modulus_degree_bits=d_bits,
        false_positive_probability=1e-4,  # test_server.cc:118 parity
        profile=profile,
    )


class ClientSession(NamedTuple):
    """What one client session gives: its traffic and stage durations, the
    client (its verdict and blind distance), and the w || filter frame as
    read off the socket: (128-byte header, payload)."""
    traffic: TrafficLoad
    durations: DurationClient
    client: ProximityClient
    bf_frame: tuple[bytes, bytes]


def run_client(chan: Channel, cfg: ProtocolConfig, send_pk: bool, device) -> ClientSession:
    """One client session: leg (``send_pk``) or opt."""
    st, dev = StageTimer(), torch.device(device)
    with st.stage("setParms", block_on=dev):
        client = ProximityClient(cfg, device)
    if not send_pk:  # opt: parms go out before keygen
        with st.stage("sendParms", block_on=dev):
            c_sendParms = chan.send_frame(client.parms_message())
    with st.stage("kGen", block_on=dev):
        client.keygen()
    if send_pk:  # leg: parms after keygen, then pk
        with st.stage("sendParms", block_on=dev):
            c_sendParms = chan.send_frame(client.parms_message())
        with st.stage("sendPk", block_on=dev):
            c_sendPk = chan.send_frame(save_public_key(client.pk, client.ctx))
    else:
        c_sendPk = 0
    with st.stage("enc", block_on=dev):
        blobs = client.ciphertext_messages()
    with st.stage("sendCip", block_on=dev):
        c_sendCips = sum(chan.send_frame(b) for b in blobs)
    with st.stage("recvBF", block_on=dev):
        bf_frame = chan.recv_frame_with_header()
        client.receive_bf(bf_frame[1])
    c_recvBF = len(bf_frame[1])
    with st.stage("recvBD", block_on=dev):
        bd_blob = chan.recv_frame()
    c_recvBD = len(bd_blob)
    with st.stage("dec", block_on=dev):
        client.receive_blind_distance(bd_blob)
    d_total = st.total_ns()

    s = {"sendPk": 0, **st.ns}
    if send_pk:
        stage1 = s["setParms"] + s["kGen"]
        stage2 = 0
        stage3 = s["enc"] + s["dec"]
    else:
        stage1 = s["setParms"] + s["kGen"] + s["enc"]
        stage2 = 0
        stage3 = s["dec"]
    dur = DurationClient(
        d_setParms=s["setParms"],
        d_kGen=s["kGen"],
        d_enc=s["enc"],
        d_sendPk=s["sendPk"],
        d_sendParms=s["sendParms"],
        d_sendCip=s["sendCip"],
        d_recvBF=s["recvBF"],
        d_recvBD=s["recvBD"],
        d_dec=s["dec"],
        d_stage1=stage1,
        d_stage2=stage2,
        d_stage3=stage3,
        d_total=d_total,
        d_totalCalc=stage1 + stage2 + stage3,
        d_totalTraffic=0,
    )
    c_totalSend = c_sendParms + c_sendPk + c_sendCips
    c_totalRecv = c_recvBF + c_recvBD
    traffic = TrafficLoad(
        c_sendParms=c_sendParms,
        c_sendPk=c_sendPk,
        c_sendCips=c_sendCips,
        c_recvBF=c_recvBF,
        c_recvBD=c_recvBD,
        c_totalSend=c_totalSend,
        c_totalRecv=c_totalRecv,
        c_total=c_totalSend + c_totalRecv,
    )
    return ClientSession(traffic, dur, client, bf_frame)


def test_client_leg(chan, radius, xa, ya, d_bits, b_bits, profile="seal", *, device):
    cfg = _client_cfg(radius, xa, ya, d_bits, b_bits, profile)
    t, d, *_ = run_client(chan, cfg, send_pk=True, device=device)
    return t, d


def test_client_opt(chan, radius, xa, ya, d_bits, b_bits, profile="seal", *, device):
    cfg = _client_cfg(radius, xa, ya, d_bits, b_bits, profile)
    t, d, *_ = run_client(chan, cfg, send_pk=False, device=device)
    return t, d


def run_server(chan: Channel, cfg: ProtocolConfig, recv_pk: bool, device,
               blinding: Blinding | None = None) -> DurationServer:
    """One server session: leg (``recv_pk``) or opt; ``blinding`` as
    ``ProximityServer`` takes it (None draws it)."""
    st, dev = StageTimer(), torch.device(device)
    server = ProximityServer(cfg, device, blinding=blinding)
    with st.stage("recvParms", block_on=dev):
        parms_blob = chan.recv_frame()
    if recv_pk:
        with st.stage("recvPk", block_on=dev):
            pk_blob = chan.recv_frame()
    with st.stage("setParms", block_on=dev):
        server.receive_parms(parms_blob)
        if recv_pk:
            load_public_key(pk_blob, server.ctx)  # parity: parsed, unused
    with st.stage("setBF", block_on=dev):
        server.build_bloom_filter()
    with st.stage("recvCips", block_on=dev):
        server.receive_ciphertexts([chan.recv_frame() for _ in range(3)])
    with st.stage("homoCalc", block_on=dev):
        bd_blob = server.blind_distance_message()
    with st.stage("sendBF", block_on=dev):
        send_bf(chan, server)
    with st.stage("sendBD", block_on=dev):
        chan.send_frame(bd_blob)
    d_total = st.total_ns()

    s = {"recvPk": 0, **st.ns}
    if recv_pk:  # leg stage split (test_server.cc:217-219)
        stage1, stage2, stage3 = s["setParms"], s["setBF"], s["homoCalc"]
    else:  # opt split (test_server.cc:365-367)
        stage1, stage2, stage3 = s["setParms"] + s["setBF"], s["homoCalc"], 0
    return DurationServer(
        d_recvParms=s["recvParms"],
        d_recvPk=s["recvPk"],
        d_setParms=s["setParms"],
        d_setBF=s["setBF"],
        d_sendBF=s["sendBF"],
        d_recvCips=s["recvCips"],
        d_homoCalc=s["homoCalc"],
        d_sendBD=s["sendBD"],
        d_stage1=stage1,
        d_stage2=stage2,
        d_stage3=stage3,
        d_total=d_total,
        d_totalTraffic=0,
        d_totalCalc=stage1 + stage2 + stage3,
    )


def test_server_leg(chan, radius, xb, yb, profile="seal", *, device):
    cfg = ProtocolConfig(
        xb=xb, yb=yb, radius=radius, false_positive_probability=1e-4, profile=profile
    )
    return run_server(chan, cfg, recv_pk=True, device=device)


def test_server_opt(chan, radius, xb, yb, profile="seal", *, device):
    cfg = ProtocolConfig(
        xb=xb, yb=yb, radius=radius, false_positive_probability=1e-4, profile=profile
    )
    return run_server(chan, cfg, recv_pk=False, device=device)


def _prewarm(args, role: str):
    """One untimed in-process protocol round before the first connect.

    The sweep's first timed radius would otherwise absorb the process's
    start-up: on a CUDA device the first use of the NTT kernels loads their
    library (and builds it on a cold ``_build/``), and the first transforms
    and allocations at the sweep's n pay their own set-up. The reference's
    own first radius measures only protocol work (test_client.cc:52-69), so
    pre-warming is parity, not flattery. tc warms at its -d/-b; ts has
    neither flag and warms at ``ProtocolConfig``'s defaults (n = 8192,
    t = 2^56), which are tc's too, so what a tc at its defaults sends.
    """
    timer = StageTimer()
    with timer.stage("prewarm", block_on=torch.device(args.device)):
        cfg = ProtocolConfig(
            radius=16,
            plain_modulus_bits=getattr(args, "plain_modulus_bits",
                                       ProtocolConfig.plain_modulus_bits),
            poly_modulus_degree_bits=getattr(args, "poly_modulus_degree",
                                             ProtocolConfig.poly_modulus_degree_bits),
            false_positive_probability=1e-4,
            profile=args.profile,
        )
        run_local_demo(cfg, verbose=False, device=args.device)
        # The leg variant also saves and loads the public key.
        client = ProximityClient(cfg, args.device)
        client.keygen()
        load_public_key(save_public_key(client.pk, client.ctx), client.ctx)
    print(f"{role} prewarm done in {timer.ns['prewarm'] / 1e9:.1f}s")


def tc_main(args) -> int:
    """Benchmark client: sweep leg then opt, write client_leg/opt CSVs."""
    _prewarm(args, "tc")
    chan = connect_to_server(args.host, args.port, ipv6=args.ipv6)
    try:
        radii = _radii(args)
        _announce_radii(chan, radii)
        for variant, fn, emit, fname in (
            ("leg", test_client_leg, parse2csv_client_leg, args.out_leg),
            ("opt", test_client_opt, parse2csv_client_opt, args.out_opt),
        ):
            for i, radius in enumerate(radii):
                t, d = fn(
                    chan, radius, args.xa, args.ya,
                    args.poly_modulus_degree, args.plain_modulus_bits,
                    args.profile, device=args.device,
                )
                emit(fname, radius, i == 0, t, d)
                print(f"tc {variant} radius={radius} total={d.d_total/1e9:.3f}s")
    finally:
        chan.close()
    return 0


def ts_main(args) -> int:
    """Benchmark server: counterpart of tc_main, writes server_leg/opt CSVs."""
    device = torch.device(args.device)
    _prewarm(args, "ts")  # before bind: LISTEN then signals readiness
    chan = connect_to_client(args.host, args.port, ipv6=args.ipv6)
    try:
        radii = _recv_radii(chan)
        for variant, fn, emit, fname in (
            ("leg", test_server_leg, parse2csv_server_leg, args.out_leg),
            ("opt", test_server_opt, parse2csv_server_opt, args.out_opt),
        ):
            for i, radius in enumerate(radii):
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                d = fn(chan, radius, args.xb, args.yb, args.profile, device=device)
                emit(fname, radius, i == 0, d)
                print(f"ts {variant} radius={radius} total={d.d_total/1e9:.3f}s")
                if device.type == "cuda":
                    print(f"ts {variant} radius={radius} device memory: peak "
                          f"{torch.cuda.max_memory_allocated(device)} bytes, "
                          f"{torch.cuda.memory_allocated(device)} bytes held after")
    finally:
        chan.close()
    return 0
