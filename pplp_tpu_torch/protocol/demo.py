"""Single-process demo: both roles in one process (the reference's ``./pplp``).

Counterpart of ``pplp_tpu.protocol.demo``: BF build, encryption,
homomorphic blind distance, decrypt, membership test and the wall-clock
report, with per-stage times. On a CUDA device each stage ends with a
synchronize, so its host-clock time covers the device work it queued.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .config import ProtocolConfig
from .roles import ProximityClient, ProximityServer

__all__ = ["DemoResult", "run_local_demo"]


@dataclass
class DemoResult:
    is_near: bool
    blind_distance: int
    elapsed_s: float
    stage_ns: dict = field(default_factory=dict)
    # Where the server's Bloom filter lived and how large it was.
    bf_device: torch.device | None = None
    bf_table_bits: int = 0
    bf_wire_bytes: int = 0

    @property
    def verdict(self) -> str:
        return "near" if self.is_near else "far"


def run_local_demo(cfg: ProtocolConfig | None = None, verbose: bool = True,
                   print_bf: bool = False, *, device) -> DemoResult:
    cfg = cfg or ProtocolConfig()
    device = torch.device(device)
    log = print if verbose else (lambda *a, **k: None)
    log(f"Client's coordinates:\t({cfg.xa}, {cfg.ya})")
    log(f"Server's coordinates:\t({cfg.xb}, {cfg.yb})")
    log(f"Radius(Threshold):\t\t\t{cfg.radius}")

    stage_ns = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    class timed:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            sync()
            self.t0 = time.perf_counter_ns()

        def __exit__(self, *exc):
            sync()
            stage_ns[self.name] = time.perf_counter_ns() - self.t0

    begin = time.perf_counter_ns()

    client = ProximityClient(cfg, device)
    server = ProximityServer(cfg, device)

    with timed("setParms"):
        server.receive_parms(client.parms_message())
    with timed("kGen"):
        client.keygen()
    with timed("setBF"):
        server.build_bloom_filter()
    if print_bf:  # demo.cc:123-124: print each blinded distance in hex
        bl = server.blinding
        log(" ".join(
            format(bl.s * (di + bl.r) & ((1 << 64) - 1), "x")
            for di in range(cfg.sq_radius)
        ))
        log(format(bl.r * bl.s & ((1 << 64) - 1), "x"))  # demo.cc:128
    with timed("enc"):
        blobs = client.ciphertext_messages()
    with timed("homoCalc"):
        server.receive_ciphertexts(blobs)
        bd_blob = server.blind_distance_message()
    with timed("dec"):
        bf_blob = server.bf_message()
        client.receive_bf(bf_blob)
        is_near = client.receive_blind_distance(bd_blob)

    elapsed = (time.perf_counter_ns() - begin) * 1e-9
    log(f"blind_distance: {client.blind_distance:x}")
    log("near" if is_near else "far")
    log(f"Time measured: {elapsed:.3f} seconds.")
    return DemoResult(
        is_near=is_near,
        blind_distance=client.blind_distance,
        elapsed_s=elapsed,
        stage_ns=stage_ns,
        bf_device=server.bf.bits_device.device,
        bf_table_bits=server.bf.table_size,
        bf_wire_bytes=len(bf_blob),
    )
