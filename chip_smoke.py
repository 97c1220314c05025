#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pplp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. device  -- require CUDA; print the card (nvidia-smi name and power
              limit), the CUDA version and the nvcc version;
2. build   -- compile ``pplp_tpu_torch/csrc/ntt.cu`` for sm_90a;
3. kernels -- the NTT kernel against its plain PyTorch version on the card,
              bit-exact (tolerance 0: all arithmetic is exact integer
              arithmetic), at n = 4096/L = 4, n = 8192/L = 8 and
              n = 32768/L = 31 with 64 rows per limb, and at the shapes the
              demo gives it; round trips; CUDA-event times of both;
4. slice   -- the local proximity demo (``run_local_demo``) at -d 13 -b 56
              on the tpu profile: r = 4096 with a near pair and r = 128 with
              a far pair. Each verdict must equal the clear oracle, the blind
              distance must equal s(d^2 + r) mod t, the NTT kernel must have
              been launched and the Bloom filter must live on the card.

The last lines are a JSON object with one entry per kernel, the card's name
and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

KERNEL_SHAPES = ((4096, 4), (8192, 8), (32768, 31))
ROWS_PER_LIMB = 64
DEMO_N_BITS = 13
DEMO_T_BITS = 56
# (radius, xa, ya, xb, yb): d^2 = 99,700 is below 4096^2 and above 128^2.
DEMO_CASES = ((4096, 1234, 1212, 1000, 1000), (128, 1234, 1212, 1000, 1000))
REPLACES = "pplp_tpu/ops/ntt_vmem.py:272"
SOURCE = "pplp_tpu_torch/csrc/ntt.cu"


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device():
    import torch

    from pplp_tpu_torch.device import cuda_device
    from pplp_tpu_torch.ops import ntt_cuda

    dev = cuda_device(0)
    log(f"[device] nvidia-smi: {smi_line()}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, count {torch.cuda.device_count()}")
    nvcc = ntt_cuda.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"[device] nvcc: {nvcc}: {ver}")
    return dev


def phase_build():
    from pplp_tpu_torch.ops import ntt_cuda

    t0 = time.perf_counter()
    path = ntt_cuda.build()
    ntt_cuda.load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in ntt_cuda.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] ptxas: {line.strip()}")


def _random_residues(tb, batch, gen):
    import torch

    x = torch.randint(0, 1 << 62, batch + (tb.L, tb.n), generator=gen,
                      device=tb.device, dtype=torch.int64)
    return x % tb.q_b(1)


def phase_kernels(dev, demo_shapes):
    """Kernel vs plain version; returns per-kernel max error and times."""
    import torch

    from pplp_tpu_torch.ops import ntt, ntt_cuda
    from pplp_tpu_torch.ops.primes import Modulus, tpu_default

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    card = torch.cuda.get_device_name(dev)
    err = {"ntt_forward": 0, "ntt_inverse": 0}
    times = {}
    cases = [(n, L, (ROWS_PER_LIMB,)) for n, L in KERNEL_SHAPES]
    cases += [(1 << DEMO_N_BITS, None, b) for b in demo_shapes]
    tables = {}
    for n, L, batch in cases:
        if n not in tables:
            tables[n] = ntt.build_tables(
                [Modulus(q) for q in tpu_default(n)], n, dev)
        tb = tables[n]
        x = _random_residues(tb, batch, gen)
        fk = ntt_cuda.forward(x, tb)
        fp = ntt.forward_plain(x, tb)
        ik = ntt_cuda.inverse(fp, tb)
        ip = ntt.inverse_plain(fp, tb)
        torch.cuda.synchronize()
        e_f = int((fk - fp).abs().max())
        e_i = int((ik - ip).abs().max())
        assert e_f == 0, f"forward kernel differs from plain at {tuple(x.shape)}: {e_f}"
        assert e_i == 0, f"inverse kernel differs from plain at {tuple(x.shape)}: {e_i}"
        assert torch.equal(ik, x), f"round trip is not the identity at {tuple(x.shape)}"
        err["ntt_forward"] = max(err["ntt_forward"], e_f)
        err["ntt_inverse"] = max(err["ntt_inverse"], e_i)
        t = {
            "ntt_forward": (cuda_ms(lambda: ntt_cuda.forward(x, tb)),
                            cuda_ms(lambda: ntt.forward_plain(x, tb))),
            "ntt_inverse": (cuda_ms(lambda: ntt_cuda.inverse(fp, tb)),
                            cuda_ms(lambda: ntt.inverse_plain(fp, tb))),
        }
        times[tuple(x.shape)] = t
        log(f"[kernels] shape {tuple(x.shape)} bit-exact fwd+inv, round trip ok; "
            f"forward {t['ntt_forward'][0]:.4f} ms (plain {t['ntt_forward'][1]:.4f}), "
            f"inverse {t['ntt_inverse'][0]:.4f} ms (plain {t['ntt_inverse'][1]:.4f}) "
            f"[{card}]")
    return err, times


def phase_slice(dev):
    import torch

    from pplp_tpu_torch.ops import ntt_cuda
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    launches = {k: 0 for k in ntt_cuda.launches_by_kernel}
    for radius, xa, ya, xb, yb in DEMO_CASES:
        cfg = ProtocolConfig(
            xa=xa, ya=ya, xb=xb, yb=yb, radius=radius,
            plain_modulus_bits=DEMO_T_BITS,
            poly_modulus_degree_bits=DEMO_N_BITS, profile="tpu", seed=7,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ntt_cuda.reset_launches()
        res = run_local_demo(cfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        run_launches = dict(ntt_cuda.launches_by_kernel)
        peak = torch.cuda.max_memory_allocated(dev)
        d2 = (xa - xb) ** 2 + (ya - yb) ** 2
        near = d2 < radius * radius
        bl = Blinding.for_protocol(cfg.plain_modulus_bits, cfg.sq_radius, cfg.seed)
        assert res.is_near == near, f"r={radius}: verdict {res.verdict}, oracle {near}"
        assert res.blind_distance == bl.s * (d2 + bl.r) % cfg.plain_modulus, (
            f"r={radius}: blind distance {res.blind_distance:#x} is not s(d^2+r) mod t")
        assert all(v > 0 for v in run_launches.values()), (
            f"r={radius}: NTT kernel launches {run_launches}")
        assert res.bf_device.type == "cuda", "Bloom filter is not on the card"
        for k, v in run_launches.items():
            launches[k] += v
        stages = ", ".join(f"{k} {v / 1e6:.3f} ms" for k, v in res.stage_ns.items())
        log(f"[slice] r={radius} d^2={d2}: {res.verdict} (oracle "
            f"{'near' if near else 'far'}), blind distance {res.blind_distance:#x}, "
            f"launches {run_launches}")
        log(f"[slice] r={radius} stages: {stages}; total {res.elapsed_s:.3f} s")
        log(f"[slice] r={radius} BF {res.bf_table_bits} bits held as "
            f"{res.bf_table_bits} bytes on {res.bf_device}, {res.bf_wire_bytes} "
            f"wire bytes; peak device memory {peak} bytes")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = phase_device()
    phase_build()
    from pplp_tpu_torch.ops.primes import tpu_default

    # The demo's transform shapes: one polynomial (decrypt), three
    # (encrypt, plaintext spectra) and six (the blind distance's stack).
    demo_shapes = [(), (3,), (6,)]
    err, times = phase_kernels(dev, demo_shapes)
    launches = phase_slice(dev)
    main_shape = (6, len(tpu_default(1 << DEMO_N_BITS)), 1 << DEMO_N_BITS)
    kernels = []
    for name in ("ntt_forward", "ntt_inverse"):
        ms, plain_ms = times[main_shape][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
        })
    log(f"[kernels] ms and plain_ms below are at shape {main_shape}")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
