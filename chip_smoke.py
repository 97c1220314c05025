#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pplp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. device   -- require CUDA; print the card (nvidia-smi name and power
               limit), the CUDA version and the nvcc version;
2. build    -- compile every ``pplp_tpu_torch/csrc/*.cu`` for sm_90a, one
               nvcc per source, all at once;
3. kernels  -- the NTT kernels against their plain PyTorch versions on the
               card, bit-exact (tolerance 0: all arithmetic is exact integer
               arithmetic): the u32 kernels on the tpu chains n = 4096/L = 4,
               8192/L = 8 and 32768/L = 31 in both I/O widths (int64 in and
               out; u32 out from int64 and from u32 rows), the u64 kernels on
               the seal chains n = 4096/L = 3, 8192/L = 5, 16384/L = 9 and
               32768/L = 16 (a row over a cluster of 2, 2, 2 and 4 blocks),
               with 64 rows per limb, and both at the shapes the demo gives
               them; the u64 kernels also at n = 64 and 1024 on 36-, 44- and
               61-bit primes, where a block holds several rows of a limb
               (35 and 3 rows per limb: a tail block); round trips; the
               kernels' device times (torch.profiler: at the demo's shapes a
               transform is shorter than its host launch path) and the plain
               versions' CUDA-event times;
4. slice    -- the local proximity demo (``run_local_demo``) at -d 13 -b 56,
               on the seal profile (the CLI's default) and on the tpu profile:
               r = 4096 with a near pair and r = 128 with a far pair. Each
               verdict must equal the clear oracle, the blind distance must
               equal s(d^2 + r) mod t, the profile's NTT kernel must have been
               launched and the Bloom filter must live on the card;
5. multiply -- the BFV ct x ct multiply at n = 4096 on the tpu chain
               (4 primes, |B_sk| = 6), t = 2^16, batch 256, through
               ``Evaluator``: multiply + relinearize with width-2 (default)
               and width-1 keys, multiply alone, relinearize alone, and one
               real product (encrypt, multiply + relinearize, decrypt) equal
               to the host negacyclic product; the fused kernels
               (behz_to_bsk, behz_tensor_ntt, behz_floor_sk, behz_relin_ntt)
               must have been launched. Each kernel's wrapper step is then
               held bit-exact against its plain version (the plain version
               runs the plain NTTs) and timed with CUDA events beside it;
6. probe    -- the mulmod chain (16 Shoup products) on [256, 4, 4096],
               bit-exact against its plain version, with times and mulmods/s,
               and its rate at 256 steps, where it is bound by integer work;
7. pipeline -- BASELINE config[3], ``build_packed_pipeline_bf``: 102,400
               coefficient-packed checks (25 rows at n = 4096, tpu chain,
               t = 2^20, s = 501, r = 99, w = 0xA5A5, a filter of r^2 keys at
               fpp 1e-4, half the points near). Every result must equal the
               host oracle (clear blind distance -> key -> probe) with no false
               negatives, the device decode must equal the host CRT decode on
               two rows, and the NTT kernel must have been launched; the
               step's CUDA-event time (median of windows), its split
               (homomorphic evaluation / decode / probe), checks/s, peak
               memory, and the device's busy share and largest kernels
               under ``torch.profiler``;
8. separate -- the multiply + relinearization at n = 32768 (31 primes,
               |B_sk| = 33, batch 2, width 2) through ``Evaluator``, where the
               fused kernels' rows do not fit in shared memory: the u32
               transforms around behz_tensor, behz_lift, behz_keyprod and
               behz_add, which must have been launched; the call bit-exact
               against the plain version, then each of those kernels' steps
               bit-exact against its plain step on the same inputs, and its
               device time per call (torch.profiler) beside the plain step's.
               It runs after the pipeline, so that its context does not
               count in the pipeline's peak memory;
9. seal_multiply -- the seal (m62) multiply + relinearization through
               ``Evaluator`` on the u64 route (``csrc/behz64.cu`` around the
               u64 transforms) on three seal chains: n = 4096 (3 primes,
               |B_sk| = 5), t = 2^16, batch 256, widths 1 (default) and 2;
               n = 8192 (5 primes, |B_sk| = 7), t = 2^56, batch 64, widths 2
               (default) and 1; n = 32768 (16 primes, |B_sk| = 18), t = 2^56,
               batch 2, width 2. Per chain: multiply + relinearize at each
               width, multiply alone and relinearize alone, bit-exact
               against the plain version (plain NTTs); the six behz64
               kernels must have been launched; the u64 transforms on the
               chain's 60-bit B_sk tables bit-exact against the plain NTT;
               each kernel's wrapper step bit-exact against its plain step
               on the same inputs (both widths), with its device time
               (torch.profiler) beside the plain step's CUDA-event time; on
               n = 4096 and 8192 one real product decrypted and equal to the
               host negacyclic product; on every chain ``mod_switch_to_next``
               on the card equal to the same call on a CPU copy and
               decrypting to the plaintext with the restricted key. After
               the pipeline, so that none of its contexts counts in the
               pipeline's peak;
10. network -- the networked entry points at the CLI's -d 13 -b 56, with
               fpp 1e-4 as the client and server use it. In process, over TCP
               on 127.0.0.1 (``run_server_protocol`` on
               ``connect_to_client`` in a thread, ``run_client_protocol`` on
               ``connect_to_server``), on seal and tpu, r = 4096 near and
               r = 128 far, each case twice with the same seed: the verdict
               equals the clear oracle, the blind distance s(d^2 + r) mod t
               from the server's blinding, the same both times; the
               profile's NTT kernels launched, the server's filter on the
               card, each side's bytes sent equal to the other's received,
               the BF frame 8 + ``compute_serialization_size()`` bytes. The
               key formats on both profiles: pk, sk and width-1/width-2
               relinearization keys saved from the card and from a CPU copy
               to the same bytes, loaded on the card to the CPU's tensors.
               Then the entry points as processes: ``cli server`` and
               ``cli client`` at r = 4096 (near), and ``cli ts`` / ``cli tc``
               over the reference's whole sweep (r = 16..4096, leg then opt,
               seal): four CSVs with the reference's columns and 9 rows,
               ``c_total = c_totalSend + c_totalRecv``, ``c_sendPk`` > 0 only
               in leg rows, ``d_setBF`` and ``d_homoCalc`` > 0, and no
               radius's server left on the card after it (ts's device
               memory lines). Per radius it prints the client's totals and
               the server's setBF, homoCalc and sendBF stages.

The last lines are a JSON object with one entry per kernel (launches on
the main paths, max error, ms and plain ms as measured here, ``ms_source``:
"profiler" where ms is the kernel's device time under torch.profiler,
"events" where it is the CUDA-event time of its wrapper step, the bound:
the larger of the bytes the kernel's interface moves over 3.35 TB/s and its
Shoup products over the card's integer-multiply peak,
``measure_multiply.MULMODS_PER_S``; ``library_ms`` null, since no PyTorch call computes
a negacyclic modular NTT, the BEHZ multiply or a Shoup chain), the card's
name and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SHAPES = (("tpu", 4096, 4), ("tpu", 8192, 8), ("tpu", 32768, 31),
                 ("seal", 4096, 3), ("seal", 8192, 5), ("seal", 16384, 9),
                 ("seal", 32768, 16))
ROWS_PER_LIMB = 64
# The u64 row kernels below the seal chains: (n, rows per limb, prime bits).
SMALL_U64 = ((64, 35, (36, 44, 61)), (1024, 3, (36, 44, 61)))
DEMO_N_BITS = 13
DEMO_T_BITS = 56
# (radius, xa, ya, xb, yb): d^2 = 99,700 is below 4096^2 and above 128^2.
DEMO_CASES = ((4096, 1234, 1212, 1000, 1000), (128, 1234, 1212, 1000, 1000))
MUL_N = 4096
MUL_T_BITS = 16
MUL_BATCH = 256
PROBE_SHAPE = (256, 4, 4096)
PIPE_N, PIPE_T_BITS, PIPE_ROWS = 4096, 20, 25
PIPE_XB, PIPE_YB, PIPE_S, PIPE_R, PIPE_W = 1000, 900, 501, 99, 0xA5A5
PIPE_PROFILE_STEPS = 10
PROFILE_NTT = {"tpu": ("ntt_forward", "ntt_inverse"),
               "seal": ("ntt_forward_u64", "ntt_inverse_u64")}
MUL_SEP_N = 32768  # the separate route: neither fused kernel fits
MUL_SEP_BATCH = 2
# The seal (m62) multiply: (n, log2 t, batch, gadget widths, the default first).
SEAL_MUL = ((4096, 16, 256, (1, 2)), (8192, 56, 64, (2, 1)), (32768, 56, 2, (2,)))
SEAL_REAL_MAX_N = 8192  # the real products: host negacyclic products up to here
NTT_TPU = "pplp_tpu/ops/ntt_vmem.py:272"
BEHZ_TPU = "pplp_tpu/bfv/behz_fused.py:257"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "ntt_forward": ("pplp_tpu_torch/csrc/ntt.cu", NTT_TPU),
    "ntt_inverse": ("pplp_tpu_torch/csrc/ntt.cu", NTT_TPU),
    "ntt_forward_u32": ("pplp_tpu_torch/csrc/ntt.cu", NTT_TPU),
    "ntt_inverse_u32": ("pplp_tpu_torch/csrc/ntt.cu", NTT_TPU),
    # No TPU kernel: the reference runs m62 through its XLA stage engine.
    "ntt_forward_u64": ("pplp_tpu_torch/csrc/ntt.cu", "pplp_tpu/ops/ntt.py:205"),
    "ntt_inverse_u64": ("pplp_tpu_torch/csrc/ntt.cu", "pplp_tpu/ops/ntt.py:205"),
    **{name: ("pplp_tpu_torch/csrc/behz.cu", BEHZ_TPU) for name in (
        "behz_to_bsk", "behz_tensor_ntt", "behz_floor_sk", "behz_relin_ntt",
        "behz_tensor", "behz_lift", "behz_keyprod", "behz_add")},
    "mulmod_chain": ("pplp_tpu_torch/csrc/mulmod_chain.cu",
                     "scripts/gated_profile.py:105"),
    # No TPU kernel: the reference runs the m62 multiply through XLA.
    **{name: ("pplp_tpu_torch/csrc/behz64.cu", "pplp_tpu/bfv/behz.py:388") for name in (
        "behz64_to_bsk", "behz64_tensor", "behz64_floor_sk", "behz64_lift", "behz64_keyprod",
        "behz64_add")},
}
FUSED = ("behz_to_bsk", "behz_tensor_ntt", "behz_floor_sk", "behz_relin_ntt")
SEPARATE = ("behz_tensor", "behz_lift", "behz_keyprod", "behz_add")


def _ntt_bound(name, shape) -> dict:
    """Bound of one transform of ``shape`` [..., L, n] as timed here: 8 B
    per residue in and out for int64, 4 B for u32; the u64 kernels' 64-bit
    Shoup products at their own rate (``MULMODS64_PER_S``)."""
    from pplp_tpu_torch.measure_multiply import transform_counts

    width = 4 if name.endswith("u32") else 8
    c = transform_counts(math.prod(shape[:-1]), shape[-1], "inverse" in name, width, width,
                         u64=name.endswith("u64"))
    return {"bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    from pplp_tpu_torch.device import window_ms

    for _ in range(warmup):
        fn()
    return window_ms(fn, iters)


def phase_device():
    import torch

    from pplp_tpu_torch.device import cuda_device, smi_line
    from pplp_tpu_torch.ops import cuda_build

    dev = cuda_device(0)
    log(f"[device] nvidia-smi: {smi_line()}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, count {torch.cuda.device_count()}")
    nvcc = cuda_build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"[device] nvcc: {nvcc}: {ver}")
    return dev


def phase_build():
    from pplp_tpu_torch.ops import behz64_cuda, behz_cuda, cuda_build, mulmod_chain, ntt_cuda

    t0 = time.perf_counter()
    paths = cuda_build.build(sorted(cuda_build.CSRC.glob("*.cu")))
    for mod in (ntt_cuda, behz_cuda, behz64_cuda, mulmod_chain):
        mod.load()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name, info in sorted(cuda_build.build_info.items()):
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {name} ptxas: {line.strip()}")


def _random_residues(tb, batch, gen):
    import torch

    x = torch.randint(0, 1 << 62, batch + (tb.L, tb.n), generator=gen,
                      device=tb.device, dtype=torch.int64)
    return x % tb.q_b(1)


def _chain(profile, n):
    from pplp_tpu_torch.ops.primes import bfv_default, tpu_default

    return (tpu_default if profile == "tpu" else bfv_default)(n)


def phase_kernels(dev, demo_shapes):
    """Kernels vs plain versions; returns per-kernel max error and times
    keyed by (profile, shape)."""
    import torch

    from pplp_tpu_torch.measure_ntt import device_ms
    from pplp_tpu_torch.ops import ntt, ntt_cuda
    from pplp_tpu_torch.ops.primes import Modulus, get_primes

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    card = torch.cuda.get_device_name(dev)
    err = {name: 0 for name in ntt_cuda.launches_by_kernel}
    times = {}
    cases = [(prof, n, (ROWS_PER_LIMB,)) for prof, n, _ in KERNEL_SHAPES]
    cases += [(prof, 1 << DEMO_N_BITS, b) for prof in PROFILE_NTT for b in demo_shapes]
    cases += [("seal", n, (rows,)) for n, rows, _ in SMALL_U64]
    small = {n: [get_primes(b, 1, n)[0] for b in bits] for n, _, bits in SMALL_U64}
    tables = {}
    for prof, n, batch in cases:
        if (prof, n) not in tables:
            tables[prof, n] = ntt.build_tables(
                [Modulus(q) for q in small.get(n) or _chain(prof, n)], n, dev)
        tb = tables[prof, n]
        assert tb.profile == ("m31" if prof == "tpu" else "m62")
        fwd, inv = PROFILE_NTT[prof]
        x = _random_residues(tb, batch, gen)
        fk = ntt_cuda.forward(x, tb)
        fp = ntt.forward_plain(x, tb)
        ik = ntt_cuda.inverse(fp, tb)
        ip = ntt.inverse_plain(fp, tb)
        torch.cuda.synchronize()
        shape = tuple(x.shape)
        e_f = int((fk - fp).abs().max())
        e_i = int((ik - ip).abs().max())
        assert e_f == 0, f"{fwd} differs from plain at {shape}: {e_f}"
        assert e_i == 0, f"{inv} differs from plain at {shape}: {e_i}"
        assert torch.equal(ik, x), f"{prof} round trip is not the identity at {shape}"
        err[fwd] = max(err[fwd], e_f)
        err[inv] = max(err[inv], e_i)
        # The plain m62 transforms run ~100 int64 ops per stage: fewer calls.
        iters, warm = (20, 3) if prof == "tpu" else (3, 1)
        t = {
            fwd: (device_ms(lambda: ntt_cuda.forward(x, tb)),
                  cuda_ms(lambda: ntt.forward_plain(x, tb), iters, warm)),
            inv: (device_ms(lambda: ntt_cuda.inverse(fp, tb)),
                  cuda_ms(lambda: ntt.inverse_plain(fp, tb), iters, warm)),
        }
        u32 = ""
        if prof == "tpu" and batch == (ROWS_PER_LIMB,):  # the u32-out kernels
            x32, fp32 = x.to(torch.int32), fp.to(torch.int32)
            got = {"ntt_forward_u32": (ntt_cuda.forward_u32(x, tb), fp),
                   "ntt_forward_u32 from u32": (ntt_cuda.forward_u32(x32, tb), fp),
                   "ntt_inverse_u32": (ntt_cuda.inverse_u32(fp32, tb), ip)}
            torch.cuda.synchronize()
            for what, (k, p) in got.items():
                e = int(((k.to(torch.int64) & 0xFFFFFFFF) - p).abs().max())
                assert e == 0, f"{what} differs from plain at {shape}: {e}"
                name = what.split()[0]
                err[name] = max(err[name], e)
            t["ntt_forward_u32"] = (device_ms(lambda: ntt_cuda.forward_u32(x32, tb)),
                                    t[fwd][1])
            t["ntt_inverse_u32"] = (device_ms(lambda: ntt_cuda.inverse_u32(fp32, tb)),
                                    t[inv][1])
            u32 = (f"; u32 in and out: forward {t['ntt_forward_u32'][0]:.4f} ms, "
                   f"inverse {t['ntt_inverse_u32'][0]:.4f} ms, bit-exact (also from int64)")
        times[prof, shape] = t
        bf, bi = _ntt_bound(fwd, shape), _ntt_bound(inv, shape)
        log(f"[kernels] {prof} shape {shape} bit-exact fwd+inv, round trip ok; device time "
            f"{fwd} {t[fwd][0]:.4f} ms (plain {t[fwd][1]:.4f}; bound {bf['bound_ms']:.4f} ms, "
            f"{bf['bound_by']}), {inv} {t[inv][0]:.4f} ms (plain {t[inv][1]:.4f}; bound "
            f"{bi['bound_ms']:.4f} ms, {bi['bound_by']}){u32} [{card}]")
    return err, times


def phase_slice(dev):
    """The demo on each profile; returns the NTT launches of these runs."""
    import torch

    from pplp_tpu_torch.ops import ntt_cuda
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    launches = {k: 0 for k in ntt_cuda.launches_by_kernel}
    for profile in ("seal", "tpu"):
        for radius, xa, ya, xb, yb in DEMO_CASES:
            cfg = ProtocolConfig(
                xa=xa, ya=ya, xb=xb, yb=yb, radius=radius,
                plain_modulus_bits=DEMO_T_BITS,
                poly_modulus_degree_bits=DEMO_N_BITS, profile=profile, seed=7,
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
            tag = f"{profile} r={radius}"
            assert res.is_near == near, f"{tag}: verdict {res.verdict}, oracle {near}"
            assert res.blind_distance == bl.s * (d2 + bl.r) % cfg.plain_modulus, (
                f"{tag}: blind distance {res.blind_distance:#x} is not s(d^2+r) mod t")
            assert all(run_launches[k] > 0 for k in PROFILE_NTT[profile]), (
                f"{tag}: NTT kernel launches {run_launches}")
            assert res.bf_device.type == "cuda", "Bloom filter is not on the card"
            for k, v in run_launches.items():
                launches[k] += v
            stages = ", ".join(f"{k} {v / 1e6:.3f} ms" for k, v in res.stage_ns.items())
            log(f"[slice] {tag} d^2={d2}: {res.verdict} (oracle "
                f"{'near' if near else 'far'}), blind distance {res.blind_distance:#x}, "
                f"launches {run_launches}")
            log(f"[slice] {tag} stages: {stages}; total {res.elapsed_s:.3f} s")
            log(f"[slice] {tag} BF {res.bf_table_bits} bits held as "
                f"{res.bf_table_bits} bytes on {res.bf_device}, {res.bf_wire_bytes} "
                f"wire bytes; peak device memory {peak} bytes")
    return launches


def _negacyclic_mod(a, b, t):
    """a * b mod (x^n + 1, t) on the host (int64 is exact: a, b < 2^16)."""
    import numpy as np

    n = len(a)
    full = np.concatenate([np.convolve(a, b), [0]])
    return [int(v) % t for v in full[:n] - full[n:]]


def _max_err(got, want) -> int:
    assert got.size == want.size, f"sizes {got.size} and {want.size}"
    return max(int((x - y).abs().max()) for x, y in zip(got.polys, want.polys))


def _u32_err(got, want) -> int:
    """Max |got - want| with got's residues read as u32 (int32 bits) or int64."""
    import torch

    return int(((got.to(torch.int64) & 0xFFFFFFFF) - want.reshape(got.shape)).abs().max())


def _synthetic(ctx, batch, gen):
    """Random canonical residues [batch, L, n], as bench.py::_synthetic_cts."""
    import torch

    x = torch.randint(0, 1 << 62, (batch, ctx.L, ctx.n), generator=gen,
                      device=ctx.device, dtype=torch.int64)
    return x % ctx.q2


def phase_multiply(dev):
    """BFV ct x ct multiply + relinearization through the BEHZ kernels."""
    import numpy as np
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import behz
    from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
    from pplp_tpu_torch.measure_multiply import kernel_counts
    from pplp_tpu_torch.ops import behz_cuda, ntt_cuda

    card = torch.cuda.get_device_name(dev)
    parms = bfv.EncryptionParameters.bfv(MUL_N, 1 << MUL_T_BITS, profile="tpu")
    ctx = bfv.BFVContext.build(parms, dev)
    mul = behz.multiplier(ctx)
    gen = torch.Generator(device=dev).manual_seed(4096)
    sk2, rlk2 = behz.make_keys(ctx, gen)
    rlk1 = behz.create_relin_keys(ctx, sk2, gen, width=1)
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rlk_real = behz.create_relin_keys(ctx, sk, gen)
    log(f"[multiply] n={ctx.n} L={ctx.L} |B_sk|={mul.K} t=2^{MUL_T_BITS} "
        f"batch={MUL_BATCH}; key groups width 2 {rlk2.groups}, width 1 {rlk1.groups}")

    ct1 = bfv.Ciphertext((_synthetic(ctx, MUL_BATCH, gen), _synthetic(ctx, MUL_BATCH, gen)))
    ct2 = bfv.Ciphertext((_synthetic(ctx, MUL_BATCH, gen), _synthetic(ctx, MUL_BATCH, gen)))
    rng = np.random.default_rng(7)
    ma, mb = (rng.integers(0, 1 << MUL_T_BITS, size=ctx.n) for _ in range(2))
    enc = bfv.Encryptor(ctx, pk)
    ca = enc.encrypt(bfv.Plaintext(ma.tolist()), gen)
    cb = enc.encrypt(bfv.Plaintext(mb.tolist()), gen)

    # The counted run: every call goes through the Evaluator, as a user's would.
    torch.cuda.synchronize()
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    ev = bfv.Evaluator(ctx)
    out2 = ev.multiply_relinearize(ct1, ct2, rlk2)
    out1 = ev.multiply_relinearize(ct1, ct2, rlk1)
    out3 = ev.multiply(ct1, ct2)
    rel2 = ev.relinearize(out3, rlk2)
    real = ev.multiply_relinearize(ca, cb, rlk_real)
    torch.cuda.synchronize()
    launches = dict(behz_cuda.launches_by_kernel)
    ntt_launches = dict(ntt_cuda.launches_by_kernel)
    assert all(launches[k] > 0 for k in FUSED), f"BEHZ kernel launches {launches}"
    log(f"[multiply] launches {launches}, standalone NTT {ntt_launches}")

    # Against the plain version with the plain NTTs (not counted).
    plain3 = mul.multiply(ct1, ct2)
    errs = {
        "multiply": _max_err(out3, plain3),
        "multiply_relinearize w2": _max_err(
            out2, behz.relinearize(ctx, plain3, rlk2)),
        "multiply_relinearize w1": _max_err(
            out1, behz.relinearize(ctx, plain3, rlk1)),
    }
    errs["relinearize w2"] = _max_err(
        rel2, behz.relinearize(ctx, plain3, rlk2))
    log(f"[multiply] max |kernel - plain| at batch {MUL_BATCH}: {errs}")
    assert all(e == 0 for e in errs.values()), f"kernel differs from plain: {errs}"
    got = bfv.Decryptor(ctx, sk).decrypt(real).coeffs[: ctx.n]
    want = _negacyclic_mod(ma, mb, 1 << MUL_T_BITS)
    assert got == want, "decrypted product differs from the host negacyclic product"
    log(f"[multiply] real product: decrypt(multiply_relinearize(enc a, enc b)) == "
        f"a * b mod (x^{ctx.n} + 1, 2^{MUL_T_BITS}); first coefficients {got[:4]}")

    # Each fused kernel's step against its plain version, and timed beside it.
    c0, c1 = ct1.polys
    d0, d1 = ct2.polys
    x = torch.stack([c0, c1, d0, d1])
    xb = behz_cuda.to_bsk(c0, c1, d0, d1, mul)
    xb_p = mul._to_bsk(x)
    eq, eb = behz_cuda.tensor_products(c0, c1, d0, d1, xb, mul)
    eq_p, eb_p = mul.tensor_products(x, xb_p)
    fl = behz_cuda.floor_sk(eq, eb, mul)
    fl_p = mul._sk_to_q(mul._fast_floor(eq_p, eb_p))
    rl = behz_cuda.relinearize(*plain3.polys, ctx, rlk2)
    rl_p = torch.stack(behz.relinearize(ctx, plain3, rlk2).polys)
    torch.cuda.synchronize()
    assert xb.dtype == eq.dtype == eb.dtype == torch.int32, "intermediates are not u32"
    step_err = {"behz_to_bsk": _u32_err(xb, xb_p),
                "behz_tensor_ntt": max(_u32_err(eq, eq_p), _u32_err(eb, eb_p)),
                "behz_floor_sk": int((fl - fl_p.reshape(fl.shape)).abs().max()),
                "behz_relin_ntt": int((rl - rl_p).abs().max())}
    assert all(e == 0 for e in step_err.values()), f"a step differs from plain: {step_err}"
    plain = dict(iters=3, warmup=1)
    step_ms = {
        "behz_to_bsk": (cuda_ms(lambda: behz_cuda.to_bsk(c0, c1, d0, d1, mul)),
                        cuda_ms(lambda: mul._to_bsk(x), **plain)),
        "behz_tensor_ntt": (cuda_ms(lambda: behz_cuda.tensor_products(c0, c1, d0, d1, xb, mul)),
                            cuda_ms(lambda: mul.tensor_products(x, xb_p), **plain)),
        "behz_floor_sk": (cuda_ms(lambda: behz_cuda.floor_sk(eq, eb, mul)),
                          cuda_ms(lambda: mul._sk_to_q(mul._fast_floor(eq_p, eb_p)), **plain)),
        "behz_relin_ntt": (cuda_ms(lambda: behz_cuda.relinearize(*plain3.polys, ctx, rlk2)),
                           cuda_ms(lambda: behz.relinearize(ctx, plain3, rlk2), **plain)),
    }
    counts = kernel_counts(ctx.n, ctx.L, mul.K, len(rlk2.groups), MUL_BATCH)
    rows = {}
    for name, (ms, plain_ms) in step_ms.items():
        c = counts[name]
        rows[name] = {"launches": launches[name], "max_abs_err": step_err[name], "ms": ms,
                      "ms_source": "events", "plain_ms": plain_ms, "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"]}
        log(f"[multiply] {name}: bit-exact against its plain step; {ms:.4f} ms (CUDA "
            f"events; plain {plain_ms:.4f} ms); {c['bytes'] / 1e6:.1f} MB, "
            f"{c['mulmods'] / 1e6:.1f}M Shoup products, bound {c['bound_ms']:.4f} ms ({c['bound_by']}), "
            f"{100 * c['bound_ms'] / ms:.1f}% of bound [{card}]")

    fused = FusedMultiplier(ctx, rlk2)
    fused1 = FusedMultiplier(ctx, rlk1)
    t = {
        "mr_w2": cuda_ms(lambda: fused.multiply_relinearize(ct1, ct2)),
        "mr_w1": cuda_ms(lambda: fused1.multiply_relinearize(ct1, ct2)),
        "multiply": cuda_ms(lambda: fused.multiply(ct1, ct2)),
        "plain_mr_w2": cuda_ms(lambda: behz.relinearize(
            ctx, mul.multiply(ct1, ct2), rlk2),
            iters=3, warmup=1),
    }
    rate = MUL_BATCH / (t["mr_w2"] / 1e3)
    log(f"[multiply] batch {MUL_BATCH}: multiply_relinearize w2 {t['mr_w2']:.4f} ms "
        f"({rate:.1f} mult+relin/s), w1 {t['mr_w1']:.4f} ms, multiply alone "
        f"{t['multiply']:.4f} ms; plain (plain NTTs) {t['plain_mr_w2']:.4f} ms [{card}]")
    return rows, ntt_launches


def phase_separate(dev):
    """The multiply + relinearization at n = 32768, where neither fused
    kernel's rows fit in shared memory: a path of its own, counted alone.
    Each separate kernel's step is then held against its plain step."""
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import behz
    from pplp_tpu_torch.measure_multiply import kernel_counts, profile_phases
    from pplp_tpu_torch.ops import behz_cuda, ntt, ntt_cuda
    from pplp_tpu_torch.ops.modmath import m31

    card = torch.cuda.get_device_name(dev)
    parms = bfv.EncryptionParameters.bfv(MUL_SEP_N, 1 << MUL_T_BITS, profile="tpu")
    ctx = bfv.BFVContext.build(parms, dev)
    mul = behz.multiplier(ctx)
    gen = torch.Generator(device=dev).manual_seed(MUL_SEP_N)
    _, rlk = behz.make_keys(ctx, gen)
    groups = rlk.digit_groups(ctx.L)
    ct1 = bfv.Ciphertext(tuple(_synthetic(ctx, MUL_SEP_BATCH, gen) for _ in range(2)))
    ct2 = bfv.Ciphertext(tuple(_synthetic(ctx, MUL_SEP_BATCH, gen) for _ in range(2)))
    ev = bfv.Evaluator(ctx)
    torch.cuda.synchronize()
    behz_cuda.reset_launches()
    ntt_cuda.reset_launches()
    out = ev.multiply_relinearize(ct1, ct2, rlk)
    torch.cuda.synchronize()
    launches = dict(behz_cuda.launches_by_kernel)
    ntt_launches = dict(ntt_cuda.launches_by_kernel)
    assert all(launches[k] > 0 for k in SEPARATE + ("behz_to_bsk", "behz_floor_sk")), (
        f"separate-route launches {launches}")
    assert ntt_launches["ntt_forward_u32"] > 0 and ntt_launches["ntt_inverse_u32"] > 0
    assert launches["behz_tensor_ntt"] == launches["behz_relin_ntt"] == 0
    plain3 = mul.multiply(ct1, ct2)
    err = _max_err(out, behz.relinearize(ctx, plain3, rlk))
    assert err == 0, f"the separate route differs from plain: {err}"
    log(f"[separate] n={ctx.n} L={ctx.L} |B_sk|={mul.K} batch {MUL_SEP_BATCH} width 2 "
        f"({len(groups)} digits): multiply_relinearize bit-exact against plain; launches "
        f"{launches}, NTT {ntt_launches}")

    # Each kernel's step and its plain step on the same inputs (plain NTTs
    # between them): (kernel, plain), each giving a tuple of results.
    x = torch.stack([*ct1.polys, *ct2.polys])
    tq, tb = ctx.tables, mul.bsk_tables
    spec = [(ntt.forward_plain(src, tbx), tbx) for src, tbx in ((x, tq), (mul._to_bsk(x), tb))]
    c0, c1, c2 = plain3.polys
    lifted = torch.stack([behz.lift_digit_grouped(ctx, c2, g) for g in groups])
    d_ntt = ntt.forward_plain(lifted, tq)
    d = ntt.inverse_plain(behz.key_products(ctx, d_ntt, rlk), tq)
    spec32 = [(s.to(torch.int32), tbx) for s, tbx in spec]
    d_ntt32, d32 = d_ntt.to(torch.int32), d.to(torch.int32)
    steps = {
        "behz_tensor": (lambda: [behz_cuda.tensor_spectra(s, tbx) for s, tbx in spec32],
                        lambda: [mul.tensor_spectra(s, tbx) for s, tbx in spec]),
        "behz_lift": (lambda: [behz_cuda.lift_digits(c2, ctx, rlk)],
                      lambda: [torch.stack([behz.lift_digit_grouped(ctx, c2, g)
                                            for g in groups])]),
        "behz_keyprod": (lambda: [behz_cuda.key_products(d_ntt32, ctx, rlk)],
                         lambda: [behz.key_products(ctx, d_ntt, rlk)]),
        "behz_add": (lambda: [behz_cuda.add_switched(c0, c1, d32, ctx)],
                     lambda: [torch.stack([m31.add(c, dj, ctx.q2)
                                           for c, dj in zip((c0, c1), d)])]),
    }
    prof = profile_phases(lambda: ev.multiply_relinearize(ct1, ct2, rlk), 3)["phases"]
    counts = kernel_counts(ctx.n, ctx.L, mul.K, len(groups), MUL_SEP_BATCH)
    rows = {}
    for name, (kernel, plain) in steps.items():
        step_err = max(_u32_err(k, p) for k, p in zip(kernel(), plain()))
        assert step_err == 0, f"{name} differs from its plain step: {step_err}"
        ms = prof[name]["ms_per_call"]
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        c = counts[name]
        rows[name] = {"launches": launches[name], "max_abs_err": step_err, "ms": ms,
                      "ms_source": "profiler", "plain_ms": plain_ms, "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"]}
        log(f"[separate] {name}: bit-exact against its plain step; {ms:.4f} ms of device "
            f"time per call ({prof[name]['launches_per_call']:g} launches; plain step "
            f"{plain_ms:.4f} ms); bound {c['bound_ms']:.4f} ms ({c['bound_by']}) [{card}]")
    return rows, ntt_launches


def _profile_with(fn, names, calls: int = 3, windows: int = 3) -> dict:
    """Per-kernel device time of ``fn`` under torch.profiler: the first of
    up to ``windows`` windows that recorded every kernel in ``names`` (late
    in a long process a window was seen to miss a kernel's events), else
    the last one."""
    from pplp_tpu_torch.measure_multiply import profile_phases

    for _ in range(windows):
        phases = profile_phases(fn, calls)["phases"]
        if all(name in phases for name in names):
            break
    return phases


def phase_seal_multiply(dev):
    """The seal (m62) multiply + relinearization on the u64 route, chain by
    chain (``SEAL_MUL``): each chain's calls are counted alone, then held
    against the plain version, then each kernel step against its plain step.
    Returns the rows of the n = 4096 chain (its kernels' times and bounds)
    with the launches of every chain, and the u64 NTT launches."""
    import numpy as np
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import behz
    from pplp_tpu_torch.bfv.evaluator import mod_switch_to_next, restrict_secret_key
    from pplp_tpu_torch.measure_multiply import kernel_counts64
    from pplp_tpu_torch.ops import behz64_cuda, ntt, ntt_cuda

    t0 = time.perf_counter()
    card = torch.cuda.get_device_name(dev)
    launches = dict.fromkeys(behz64_cuda.launches_by_kernel, 0)
    ntt_launches = dict.fromkeys(ntt_cuda.launches_by_kernel, 0)
    rows = {}
    for n, t_bits, batch, widths in SEAL_MUL:
        t = 1 << t_bits
        parms = bfv.EncryptionParameters.bfv(n, t, profile="seal")
        ctx = bfv.BFVContext.build(parms, dev)
        assert ctx.tables.profile == "m62"
        mul = behz.multiplier(ctx)
        gen = torch.Generator(device=dev).manual_seed(n + t_bits)
        sk, rlk_default = behz.make_keys(ctx, gen)
        assert behz.default_relin_width(ctx) == widths[0], "the default gadget width moved"
        rlk = {widths[0]: rlk_default}
        rlk.update({w: behz.create_relin_keys(ctx, sk, gen, width=w) for w in widths[1:]})
        ct1 = bfv.Ciphertext(tuple(_synthetic(ctx, batch, gen) for _ in range(2)))
        ct2 = bfv.Ciphertext(tuple(_synthetic(ctx, batch, gen) for _ in range(2)))
        ct1.polys[0][0, :, :2] = ctx.q2 - 1  # the largest canonical residues
        kg = bfv.KeyGenerator(ctx, gen)
        ksk, kpk = kg.secret_key(), kg.create_public_key()
        rng = np.random.default_rng(n)
        ma, mb = (rng.integers(0, 1 << 16, size=n) for _ in range(2))
        enc = bfv.Encryptor(ctx, kpk)
        ca, cb = enc.encrypt(bfv.Plaintext(ma.tolist()), gen), enc.encrypt(
            bfv.Plaintext(mb.tolist()), gen)
        rlk_real = behz.create_relin_keys(ctx, ksk, gen)
        tag = f"n={n} L={ctx.L} |B_sk|={mul.K} t=2^{t_bits} batch {batch}"

        # The counted run: every call through the Evaluator, as a user's would.
        torch.cuda.synchronize()
        behz64_cuda.reset_launches()
        ntt_cuda.reset_launches()
        ev = bfv.Evaluator(ctx)
        outs = {w: ev.multiply_relinearize(ct1, ct2, rlk[w]) for w in widths}
        out3 = ev.multiply(ct1, ct2)
        rel = ev.relinearize(out3, rlk_default)
        real = ev.multiply_relinearize(ca, cb, rlk_real) if n <= SEAL_REAL_MAX_N else None
        torch.cuda.synchronize()
        run = dict(behz64_cuda.launches_by_kernel)
        run_ntt = dict(ntt_cuda.launches_by_kernel)
        assert all(v > 0 for v in run.values()), f"{tag}: behz64 launches {run}"
        assert run_ntt["ntt_forward_u64"] > 0 and run_ntt["ntt_inverse_u64"] > 0, run_ntt
        for k, v in run.items():
            launches[k] += v
        for k, v in run_ntt.items():
            ntt_launches[k] += v

        # Against the plain version with the plain NTTs (not counted).
        plain3 = mul.multiply(ct1, ct2)
        errs = {"multiply": _max_err(out3, plain3),
                f"relinearize w{widths[0]}": _max_err(rel, behz.relinearize(ctx, plain3,
                                                                           rlk_default))}
        for w in widths:
            errs[f"multiply_relinearize w{w}"] = _max_err(
                outs[w], behz.relinearize(ctx, plain3, rlk[w]))
        assert all(e == 0 for e in errs.values()), f"{tag}: kernel differs from plain: {errs}"
        log(f"[seal_multiply] {tag}: launches {run}, u64 NTT {run_ntt}; max |kernel - plain| "
            f"{errs}")
        if real is not None:
            got = bfv.Decryptor(ctx, ksk).decrypt(real).coeffs[:n]
            assert got == _negacyclic_mod(ma, mb, t), f"{tag}: decrypted product differs"
            log(f"[seal_multiply] {tag}: real product decrypt(multiply_relinearize(enc a, enc "
                f"b)) == a * b mod (x^{n} + 1, t) at width {len(rlk_real.groups[0])}; first "
                f"coefficients {got[:4]}")

        # mod_switch_to_next on the card, against the same call on a CPU copy.
        small, sw = mod_switch_to_next(ctx, ca)
        cpu_ctx = bfv.BFVContext.build(parms, "cpu")
        _, sw_cpu = mod_switch_to_next(cpu_ctx, bfv.Ciphertext(tuple(p.cpu() for p in ca.polys)))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(sw.polys, sw_cpu.polys)), (
            f"{tag}: mod_switch_to_next differs from the CPU's")
        dec = bfv.Decryptor(small, restrict_secret_key(small, ksk)).decrypt(sw).coeffs[:n]
        assert dec == ma.tolist(), f"{tag}: the switched ciphertext does not decrypt"
        log(f"[seal_multiply] {tag}: mod_switch_to_next to L={small.L} on the card == the "
            f"CPU's, decrypts to the plaintext")

        # The u64 transforms on the 60-bit B_sk tables, and each kernel step
        # against its plain step on the same inputs (both widths).
        c0, c1 = ct1.polys
        d0, d1 = ct2.polys
        x = torch.stack([c0, c1, d0, d1])
        tq, tb = ctx.tables, mul.bsk_tables
        xb_p = mul._to_bsk(x)
        sq, sb = ntt.forward_plain(x, tq), ntt.forward_plain(xb_p, tb)
        eq_p = ntt.inverse_plain(mul.tensor_spectra(sq, tq), tq)
        eb_p = ntt.inverse_plain(mul.tensor_spectra(sb, tb), tb)
        ntt_err = max(int((ntt_cuda.forward(xb_p, tb) - sb).abs().max()),
                      int((ntt_cuda.inverse(sb, tb) - xb_p).abs().max()))
        assert ntt_err == 0, f"{tag}: the u64 NTT differs on the B_sk tables"
        c2 = plain3.polys[2]
        steps = {
            "behz64_to_bsk": (lambda: [behz64_cuda.to_bsk(c0, c1, d0, d1, mul)],
                              lambda: [mul._to_bsk(x)]),
            "behz64_tensor": (lambda: list(behz64_cuda.tensor_spectra(sq, sb, mul)),
                              lambda: [mul.tensor_spectra(sq, tq), mul.tensor_spectra(sb, tb)]),
            "behz64_floor_sk": (lambda: [behz64_cuda.floor_sk(eq_p, eb_p, mul)],
                                lambda: [mul._sk_to_q(mul._fast_floor(eq_p, eb_p))]),
        }
        for w in widths:
            key, groups = rlk[w], rlk[w].digit_groups(ctx.L)
            lifted = torch.stack([behz.lift_digit_grouped(ctx, c2, g) for g in groups])
            dn = ntt.forward_plain(lifted, tq)
            d = ntt.inverse_plain(behz.key_products(ctx, dn, key), tq)
            sfx = "" if w == widths[0] else f" w{w}"
            steps.update({
                "behz64_lift" + sfx: (
                    lambda key=key: [behz64_cuda.lift_digits(c2, ctx, key)],
                    lambda key=key: [torch.stack([behz.lift_digit_grouped(ctx, c2, g)
                                                  for g in key.digit_groups(ctx.L)])]),
                "behz64_keyprod" + sfx: (lambda key=key, dn=dn: [
                    behz64_cuda.key_products(dn, ctx, key)],
                    lambda key=key, dn=dn: [behz.key_products(ctx, dn, key)]),
                "behz64_add" + sfx: (lambda d=d: [behz64_cuda.add_switched(c0, c1, d, ctx)],
                                     lambda d=d: [torch.stack([ctx.prof.add(c, dj, ctx.q2)
                                                               for c, dj in zip((c0, c1), d)])]),
            })
        prof = _profile_with(lambda: ev.multiply_relinearize(ct1, ct2, rlk_default),
                             tuple(launches))
        counts = kernel_counts64(n, ctx.L, mul.K, len(rlk_default.digit_groups(ctx.L)), batch)
        for name, (kernel, plain) in steps.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = max(int((k - p.reshape(k.shape)).abs().max()) for k, p in zip(got, want))
            assert err == 0, f"{tag}: {name} differs from its plain step: {err}"
            if name not in counts:  # the other width: held exact, not timed
                log(f"[seal_multiply] {tag}: {name}: bit-exact against its plain step")
                continue
            how, source = "of device time per call", "profiler"
            if name in prof:
                ms = prof[name]["ms_per_call"]
            else:
                ms, source = cuda_ms(kernel), "events"
                how = "per step (CUDA events: the profiler missed it)"
            plain_ms = cuda_ms(plain, iters=1, warmup=1)
            c = counts[name]
            if n == SEAL_MUL[0][0]:
                rows[name] = {"max_abs_err": err, "ms": ms, "ms_source": source,
                              "plain_ms": plain_ms, "bound_ms": c["bound_ms"],
                              "bound_by": c["bound_by"]}
            log(f"[seal_multiply] {tag}: {name}: bit-exact against its plain step; {ms:.4f} ms "
                f"{how} (plain step {plain_ms:.4f} ms); {c['bytes'] / 1e6:.1f}"
                f" MB, {c['mulmods'] / 1e6:.1f}M u64 Shoup products, bound {c['bound_ms']:.4f} "
                f"ms ({c['bound_by']}), {100 * c['bound_ms'] / ms:.1f}% of bound [{card}]")
        busy = sum(v["ms_per_call"] for v in prof.values())
        rest = "; ".join(f"{k} {v['ms_per_call']:.4f} ms ({v['launches_per_call']:g})"
                         for k, v in prof.items() if not k.startswith("behz64"))
        log(f"[seal_multiply] {tag}: width-{widths[0]} call {busy:.4f} ms of device time; "
            f"besides the behz64 kernels: {rest}")
        if batch >= 64:
            t_w = {w: cuda_ms(lambda w=w: ev.multiply_relinearize(ct1, ct2, rlk[w]))
                   for w in widths}
            log(f"[seal_multiply] {tag}: multiply_relinearize " + ", ".join(
                f"w{w} {ms:.4f} ms ({batch / (ms / 1e3):.1f} mult+relin/s)"
                for w, ms in t_w.items()) + f" (CUDA events) [{card}]")
        del ctx, mul, rlk, ct1, ct2, plain3, ev, prof
    for name, v in rows.items():
        v["launches"] = launches[name]
    log(f"[seal_multiply] phase done in {time.perf_counter() - t0:.1f} s")
    return rows, ntt_launches


def phase_probe(dev):
    """The mulmod-chain probe against its plain version."""
    import torch

    from pplp_tpu_torch.ops import mulmod_chain

    card = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randint(0, mulmod_chain.Q, PROBE_SHAPE, generator=gen, device=dev,
                      dtype=torch.int64)
    torch.cuda.synchronize()
    mulmod_chain.reset_launches()
    y = mulmod_chain.chain(x)
    torch.cuda.synchronize()
    launches = mulmod_chain.launches
    assert launches > 0, "the mulmod chain kernel was not launched"
    err = int((y - mulmod_chain.chain_plain(x)).abs().max())
    assert err == 0, f"mulmod chain differs from plain: {err}"
    from pplp_tpu_torch.measure_multiply import (CEILING_STEPS, MULMODS_PER_S, bound,
                                                 profile_phases)

    def chain_ms(steps):  # the chain kernel alone, by its name in the profile
        return profile_phases(lambda: mulmod_chain.chain(x, steps=steps), 20)["phases"][
            "mulmod_chain"]["ms_per_call"]

    window = cuda_ms(lambda: mulmod_chain.chain(x))
    ms, ceiling_ms = chain_ms(mulmod_chain.STEPS), chain_ms(CEILING_STEPS)
    plain_ms = cuda_ms(lambda: mulmod_chain.chain_plain(x), iters=5)
    mulmods = x.numel() * mulmod_chain.STEPS
    ceiling = x.numel() * CEILING_STEPS / (ceiling_ms / 1e3)
    c = bound({"bytes": x.numel() * 16, "mulmods": mulmods})
    log(f"[probe] mulmod chain x{mulmod_chain.STEPS} on {PROBE_SHAPE}: bit-exact, "
        f"{ms:.4f} ms of device time ({mulmods / (ms / 1e3):.4e} mulmods/s; CUDA-event "
        f"window {window:.4f} ms), plain {plain_ms:.4f} ms; x{CEILING_STEPS}: "
        f"{ceiling_ms:.4f} ms, {ceiling:.4e} mulmods/s = {100 * ceiling / MULMODS_PER_S:.1f}% "
        f"of the integer-multiply peak {MULMODS_PER_S:.4e}/s [{card}]")
    return {"launches": launches, "max_abs_err": err, "ms": ms, "ms_source": "profiler",
            "plain_ms": plain_ms, "bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}


def _median_ms(fn, windows: int = 7, iters: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of ``iters`` calls each."""
    import statistics

    from pplp_tpu_torch.device import window_ms

    fn()
    return statistics.median(window_ms(fn, iters) for _ in range(windows))


def phase_pipeline(dev):
    """BASELINE config[3]: 102,400 packed checks through the whole step."""
    import numpy as np
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv.rns_decrypt import get_decoder
    from pplp_tpu_torch.measure_multiply import profile_phases
    from pplp_tpu_torch.ops import ntt_cuda
    from pplp_tpu_torch.parallel import pipeline

    card = torch.cuda.get_device_name(dev)
    t = 1 << PIPE_T_BITS
    w_len = PIPE_W.bit_length()
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(PIPE_N, t, profile="tpu"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    bf = pipeline.build_pipeline_filter(t, PIPE_S, PIPE_R, PIPE_W, dev)
    bits, salts = bf.bits_device, bf._salts_device()

    # Half the points near (inside r of (xb, yb)), half anywhere, as in
    # tests/test_parallel.py's 100k-check test.
    total = PIPE_ROWS * PIPE_N
    rng = np.random.default_rng(7)
    near = rng.random(total) < 0.5
    dx = rng.integers(-PIPE_R + 1, PIPE_R, total)
    dy_cap = np.sqrt(np.maximum(PIPE_R**2 - 1 - dx**2, 0)).astype(np.int64)
    dy = (rng.integers(0, 2**31, total) % (2 * dy_cap + 1)) - dy_cap
    xa = np.where(near, PIPE_XB + dx, rng.integers(0, 4000, total)).astype(np.uint64)
    ya = np.where(near, PIPE_YB + dy, rng.integers(0, 4000, total)).astype(np.uint64)
    cts = pipeline.make_packed_inputs(ctx, bfv.Encryptor(ctx, pk), xa, ya, gen)
    fn = pipeline.build_packed_pipeline_bf(ctx, sk, PIPE_XB, PIPE_YB, PIPE_S, PIPE_R,
                                           PIPE_W, w_len)
    log(f"[pipeline] n={ctx.n} L={ctx.L} t=2^{PIPE_T_BITS} rows={PIPE_ROWS} "
        f"checks={total}; BF {bf.table_size} bits, {bf.salt_count} hashes")

    # The counted run.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ntt_cuda.reset_launches()
    got = fn(*cts, bits, salts, bf.table_size)
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(launches[k] > 0 for k in PROFILE_NTT["tpu"]), f"NTT launches {launches}"

    # Host oracle, all in numpy and Python ints: clear blind distance -> key
    # -> the filter's host scalar probe (the byte-wise AP hash).
    d2 = (xa.astype(np.int64) - PIPE_XB) ** 2 + (ya.astype(np.int64) - PIPE_YB) ** 2
    bd_clear = (PIPE_S * (d2 + PIPE_R)) % t
    keys = (bd_clear.astype(np.uint64) << np.uint64(w_len)) | np.uint64(PIPE_W)
    want = np.array([bf.contains_u64(int(k)) for k in keys])
    flat = got.reshape(-1).cpu().numpy()
    assert flat.shape[0] == total
    mismatches = int((flat != want).sum())
    assert mismatches == 0, f"{mismatches} of {total} checks differ from the oracle"
    truly_near = d2 < PIPE_R**2
    assert bool(flat[truly_near].all()), "a near check came out far"

    hom = pipeline.build_batched_pipeline(ctx, sk, PIPE_XB, PIPE_YB, PIPE_S, PIPE_R,
                                          packed=True)
    decode = get_decoder(ctx).decode_mod_t
    x = hom(*cts)
    bd = decode(x)
    assert torch.equal(bd.reshape(-1), torch.as_tensor(bd_clear, device=dev))
    for r in (0, PIPE_ROWS - 1):
        assert ctx.decode_plain_from_ct_value(x[r].cpu().numpy()) == bd[r].tolist(), (
            f"device decode differs from the host CRT decode on row {r}")
    n_near = int(flat.sum())
    log(f"[pipeline] all {total} checks equal the host oracle ({n_near} near, "
        f"{int(truly_near.sum())} truly near, no false negatives); device decode == "
        f"host CRT decode on rows 0 and {PIPE_ROWS - 1}; launches {launches}")

    t_step = _median_ms(lambda: fn(*cts, bits, salts, bf.table_size))
    t_hom = _median_ms(lambda: hom(*cts))
    t_dec = _median_ms(lambda: decode(x))
    t_probe = _median_ms(lambda: pipeline.bf_probe(bd, PIPE_W, w_len, bits, salts,
                                                   bf.table_size))
    log(f"[pipeline] step {t_step:.4f} ms ({total / (t_step / 1e3):.1f} checks/s): "
        f"homomorphic evaluation {t_hom:.4f} ms, decode {t_dec:.4f} ms, probe "
        f"{t_probe:.4f} ms (medians of 7 windows of 5); peak device memory {peak} "
        f"bytes [{card}]")
    prof = profile_phases(lambda: fn(*cts, bits, salts, bf.table_size), PIPE_PROFILE_STEPS)
    kernels = prof["phases"]
    per_step = sum(v["launches_per_call"] for v in kernels.values())
    top = "; ".join(f"{name.removeprefix('other: ')[:48]} {v['ms_per_call']:.4f} ms"
                    for name, v in list(kernels.items())[:3])
    log(f"[pipeline] torch.profiler over {PIPE_PROFILE_STEPS} steps: device busy "
        f"{prof['busy_ms'] / PIPE_PROFILE_STEPS:.4f} ms per step, "
        f"{100 * prof['busy_share']:.1f}% of the window; {per_step:.0f} kernels per "
        f"step; largest: {top}")
    return launches


def _free_port() -> int:
    """A TCP port on 127.0.0.1 that the kernel gave to a socket bound to
    port 0 (closed again, so that a listener can take it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port: int, wait_s: float = 60.0):
    """A channel to the listener on 127.0.0.1:port, retried while it starts."""
    from pplp_tpu_torch.protocol.transport import connect_to_server

    deadline = time.monotonic() + wait_s
    while True:
        try:
            return connect_to_server("127.0.0.1", port)
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)


def _network_pair(dev, cfg_client, cfg_server):
    """run_server_protocol on connect_to_client in a thread, run_client_protocol
    on connect_to_server here, over TCP on 127.0.0.1; (client, server,
    client channel, server channel, seconds)."""
    import threading

    from pplp_tpu_torch.protocol.netmain import run_client_protocol, run_server_protocol
    from pplp_tpu_torch.protocol.transport import connect_to_client

    port = _free_port()
    out, err = {}, []

    def serve():
        try:
            chan = connect_to_client("127.0.0.1", port)
            out["chan"] = chan
            try:
                out["server"] = run_server_protocol(chan, cfg_server, verbose=False, device=dev)
            finally:
                chan.close()
        except BaseException as e:  # re-raised below, in the main thread
            err.append(e)

    th = threading.Thread(target=serve, daemon=True)
    t0 = time.perf_counter()
    th.start()
    chan = _connect(port)
    try:
        client = run_client_protocol(chan, cfg_client, verbose=False, device=dev)
    finally:
        chan.close()
        th.join(timeout=600)
    seconds = time.perf_counter() - t0
    assert not th.is_alive(), "the server thread did not finish"
    if err:
        raise err[0]
    return client, out["server"], chan, out["chan"], seconds


def _key_leaves(k) -> dict:
    return {name: v for name, v in vars(k).items() if name != "groups"}


def _network_keys(dev, profile):
    """pk, sk and width-1/width-2 relinearization keys at n = 2^DEMO_N_BITS:
    saved from the card and from a CPU copy to the same bytes; loaded on the
    card to the same NTT-domain tensors and Shoup companions as on the CPU."""
    import copy

    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import behz, serialize

    parms = bfv.EncryptionParameters.bfv(1 << DEMO_N_BITS, 1 << DEMO_T_BITS, profile=profile)
    ctx, cpu = bfv.BFVContext.build(parms, dev), bfv.BFVContext.build(parms, "cpu")
    gen = torch.Generator(device=dev).manual_seed(8192)
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    cases = [("pk", pk, serialize.save_public_key, serialize.load_public_key),
             ("sk", sk, serialize.save_secret_key, serialize.load_secret_key)]
    for width in (1, 2):
        cases.append((f"kswitch w{width}", behz.create_relin_keys(ctx, sk, gen, width=width),
                      serialize.save_kswitch_keys, serialize.load_kswitch_keys))
    sizes = []
    for name, key, save, load in cases:
        host = copy.copy(key)
        for leaf, v in _key_leaves(key).items():
            setattr(host, leaf, v.cpu())
        blob = save(key, ctx)
        assert blob == save(host, cpu), f"{profile} {name}: card and CPU bytes differ"
        on_card, on_cpu = load(blob, ctx), load(blob, cpu)
        torch.cuda.synchronize()
        for leaf, v in _key_leaves(on_card).items():
            assert v.is_cuda, f"{profile} {name}: {leaf} is not on the card"
            assert torch.equal(v.cpu(), getattr(on_cpu, leaf)), (
                f"{profile} {name}: {leaf} loaded on the card differs from the CPU's")
            assert torch.equal(v, getattr(key, leaf)), f"{profile} {name}: {leaf} round trip"
        if name.startswith("kswitch"):
            assert on_card.groups == on_cpu.groups == key.groups, f"{profile} {name}: groups"
        sizes.append(f"{name} {len(blob)} B")
    return sizes


def _cli(args, log_path):
    """``python -m pplp_tpu_torch.cli`` with ``args``, its output to ``log_path``."""
    with open(log_path, "w") as f:
        return subprocess.Popen([sys.executable, "-u", "-m", "pplp_tpu_torch.cli", *args],
                                stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
                                env=dict(os.environ, PYTHONPATH=REPO))


def _serve_and_run(server_args, client_args, ready, tmp, name, timeout=600):
    """The server's CLI as one process; once its log shows ``ready``, the
    client's CLI as another. Both logs' lines, after both exit 0."""
    srv_log, cli_log = os.path.join(tmp, f"{name}_server.log"), os.path.join(tmp, f"{name}_client.log")
    procs = [_cli(server_args, srv_log)]
    try:
        deadline = time.monotonic() + timeout
        while ready not in open(srv_log).read():
            assert procs[0].poll() is None, f"{name} server exited: {open(srv_log).read()}"
            assert time.monotonic() < deadline, f"{name} server never became ready"
            time.sleep(0.1)
        procs.append(_cli(client_args, cli_log))
        rc, server_rc = (p.wait(timeout=timeout) for p in procs[::-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    client_out, server_out = open(cli_log).read(), open(srv_log).read()
    assert rc == 0, f"{name} client exit {rc}:\n{client_out}"
    assert server_rc == 0, f"{name} server exit {server_rc}:\n{server_out}"
    return client_out.splitlines(), server_out.splitlines()


def _read_csv(path):
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], map(int, r))) for r in rows[1:]]


def phase_network(dev):
    """The networked entry points on the card; returns the NTT launches of
    the in-process runs and the key formats."""
    import tempfile

    import torch

    from pplp_tpu_torch.benchmark import harness
    from pplp_tpu_torch.benchmark.sweep import RADIUS_SWEEP
    from pplp_tpu_torch.ops import ntt_cuda
    from pplp_tpu_torch.protocol import ProtocolConfig

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(dev)
    launches = {k: 0 for k in ntt_cuda.launches_by_kernel}

    def count():
        for k, v in ntt_cuda.launches_by_kernel.items():
            launches[k] += v

    # 1. In process, over TCP on 127.0.0.1: both roles, each case twice.
    for profile in ("seal", "tpu"):
        for radius, xa, ya, xb, yb in DEMO_CASES:
            kw = dict(radius=radius, plain_modulus_bits=DEMO_T_BITS,
                      poly_modulus_degree_bits=DEMO_N_BITS, profile=profile, seed=11,
                      false_positive_probability=1e-4)
            tag = f"{profile} r={radius}"
            d2 = (xa - xb) ** 2 + (ya - yb) ** 2
            seen = set()
            for run in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                ntt_cuda.reset_launches()
                client, server, ca, cb, seconds = _network_pair(
                    dev, ProtocolConfig(xa=xa, ya=ya, **kw), ProtocolConfig(xb=xb, yb=yb, **kw))
                torch.cuda.synchronize()
                run_launches = dict(ntt_cuda.launches_by_kernel)
                count()
                peak = torch.cuda.max_memory_allocated(dev)
                bl = server.blinding
                assert client.is_near == (d2 < radius * radius), f"{tag}: verdict"
                assert client.blind_distance == bl.s * (d2 + bl.r) % (1 << DEMO_T_BITS), (
                    f"{tag}: blind distance {client.blind_distance:#x} is not s(d^2+r) mod t")
                assert all(run_launches[k] > 0 for k in PROFILE_NTT[profile]), (
                    f"{tag}: NTT kernel launches {run_launches}")
                assert server.bf.bits_device.device.type == "cuda", f"{tag}: filter not on card"
                assert (ca.bytes_sent, ca.bytes_received) == (cb.bytes_received, cb.bytes_sent), (
                    f"{tag}: byte counts {ca.bytes_sent, ca.bytes_received} against "
                    f"{cb.bytes_received, cb.bytes_sent}")
                ct_bytes = (ca.bytes_sent - 4 * 128 - len(client.parms_message())) // 3
                bf_frame = ca.bytes_received - 2 * 128 - ct_bytes
                assert bf_frame == 8 + server.bf.compute_serialization_size(), (
                    f"{tag}: BF frame {bf_frame} bytes")
                seen.add((client.is_near, client.blind_distance))
                log(f"[network] {tag} run {run}: {'near' if client.is_near else 'far'} (oracle "
                    f"{'near' if d2 < radius * radius else 'far'}), blind distance "
                    f"{client.blind_distance:#x}; client sent {ca.bytes_sent} B, received "
                    f"{ca.bytes_received} B (BF frame {bf_frame} B); {seconds:.3f} s; launches "
                    f"{run_launches}; peak device memory {peak} B [{card}]")
                del client, server
            assert len(seen) == 1, f"{tag}: the two runs differ: {seen}"

    # 2. Key formats: card against CPU.
    for profile in ("seal", "tpu"):
        ntt_cuda.reset_launches()
        sizes = _network_keys(dev, profile)
        torch.cuda.synchronize()
        log(f"[network] {profile} keys at n = {1 << DEMO_N_BITS}: saved from the card == from "
            f"the CPU, loaded on the card == on the CPU ({', '.join(sizes)}); launches "
            f"{dict(ntt_cuda.launches_by_kernel)}")
        count()

    with tempfile.TemporaryDirectory() as tmp:
        # 3. The client and server entry points as processes (seal, the default).
        port = str(_free_port())
        t0 = time.perf_counter()
        c_lines, _ = _serve_and_run(
            ["server", "-x", "1000", "-y", "1000", "-r", "4096", "-p", port],
            ["client", "-x", "1234", "-y", "1212", "-r", "4096", "-p", port],
            "listening", tmp, "client_server")
        assert "Result of proximity test: near" in c_lines, "\n".join(c_lines)
        timed = [x for x in c_lines if x.startswith(("Recv the BF", "Time measured"))]
        log(f"[network] cli server + client (seal, r = 4096): near; "
            f"{'; '.join(timed)}; {time.perf_counter() - t0:.1f} s with start-up")

        # 4. The tc/ts pair as processes over the whole sweep, leg then opt.
        port = str(_free_port())
        csvs = {k: os.path.join(tmp, f"{k}.csv") for k in
                ("client_leg", "client_opt", "server_leg", "server_opt")}
        t0 = time.perf_counter()
        tc_lines, ts_lines = _serve_and_run(
            ["ts", "-p", port, "--out-leg", csvs["server_leg"], "--out-opt",
             csvs["server_opt"]],
            ["tc", "-p", port, "--out-leg", csvs["client_leg"], "--out-opt",
             csvs["client_opt"]],
            "ts prewarm done", tmp, "sweep")
        sweep_s = time.perf_counter() - t0
        cols = {"client_leg": harness._CLIENT_LEG_COLS + harness._TRAFFIC_COLS,
                "client_opt": harness._CLIENT_OPT_COLS + harness._TRAFFIC_COLS,
                "server_leg": harness._SERVER_LEG_COLS,
                "server_opt": harness._SERVER_OPT_COLS}
        table = {}
        for key, path in csvs.items():
            header, rows = _read_csv(path)
            assert header == ["radius", *cols[key]], f"{key}: header {header}"
            assert [r["radius"] for r in rows] == RADIUS_SWEEP, f"{key}: radii"
            for r in rows:
                if key.startswith("client"):
                    assert r["c_total"] == r["c_totalSend"] + r["c_totalRecv"], f"{key} {r}"
                    assert (r["c_sendPk"] > 0) == (key == "client_leg"), f"{key} c_sendPk"
                else:
                    assert r["d_setBF"] > 0 and r["d_homoCalc"] > 0, f"{key} {r}"
            table[key] = {r["radius"]: r for r in rows}
        memory = [re.search(r"peak (\d+) bytes, (\d+) bytes held", x) for x in ts_lines]
        peaks = [int(m.group(1)) for m in memory if m]
        held = [int(m.group(2)) for m in memory if m]
        assert len(held) == 2 * len(RADIUS_SWEEP), "\n".join(ts_lines)
        assert max(held) < 64 << 20, f"a radius's server stayed on the card: {held}"
        for radius in RADIUS_SWEEP:
            c_leg, c_opt = table["client_leg"][radius], table["client_opt"][radius]
            s_leg, s_opt = table["server_leg"][radius], table["server_opt"][radius]
            log(f"[network] sweep r={radius}: client d_total leg {c_leg['d_total'] / 1e6:.3f} "
                f"opt {c_opt['d_total'] / 1e6:.3f} ms; server leg d_setBF "
                f"{s_leg['d_setBF'] / 1e6:.3f} d_homoCalc {s_leg['d_homoCalc'] / 1e6:.3f} "
                f"d_sendBF {s_leg['d_sendBF'] / 1e6:.3f} ms, opt {s_opt['d_setBF'] / 1e6:.3f} "
                f"{s_opt['d_homoCalc'] / 1e6:.3f} {s_opt['d_sendBF'] / 1e6:.3f} ms; c_recvBF "
                f"{c_leg['c_recvBF']} B, c_sendPk {c_leg['c_sendPk']} B [{card}]")
        log(f"[network] sweep (seal, -d {DEMO_N_BITS} -b {DEMO_T_BITS}, r = "
            f"{RADIUS_SWEEP[0]}..{RADIUS_SWEEP[-1]}, leg then opt) in {sweep_s:.1f} s with "
            f"start-up; ts device memory per radius: peak up to {max(peaks)} B, at most "
            f"{max(held)} B held after a radius")
    log(f"[network] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches



def main() -> int:
    import torch

    from pplp_tpu_torch.device import smi_line

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = phase_device()
    phase_build()
    # The demo's transform shapes: one polynomial (decrypt), three
    # (encrypt, plaintext spectra) and six (the blind distance's stack).
    demo_shapes = [(), (3,), (6,)]
    err, times = phase_kernels(dev, demo_shapes)
    launches = phase_slice(dev)
    rows, mult_ntt = phase_multiply(dev)
    rows["mulmod_chain"] = phase_probe(dev)
    pipe_ntt = phase_pipeline(dev)
    sep_rows, sep_ntt = phase_separate(dev)
    rows.update(sep_rows)
    seal_rows, seal_ntt = phase_seal_multiply(dev)
    rows.update(seal_rows)
    net_ntt = phase_network(dev)
    n = 1 << DEMO_N_BITS
    main_shapes = {prof: (6, len(_chain(prof, n)), n) for prof in PROFILE_NTT}
    u32_shape = (ROWS_PER_LIMB, len(_chain("tpu", 32768)), 32768)
    for prof, names in (*PROFILE_NTT.items(), ("tpu", ("ntt_forward_u32", "ntt_inverse_u32"))):
        shape = u32_shape if names[0].endswith("u32") else main_shapes[prof]
        for name in names:
            ms, plain_ms = times[prof, shape][name]
            rows[name] = {"launches": sum(c[name] for c in (launches, mult_ntt, pipe_ntt,
                                                            sep_ntt, seal_ntt, net_ntt)),
                          "max_abs_err": err[name], "ms": ms, "ms_source": "profiler",
                          "plain_ms": plain_ms,
                          **_ntt_bound(name, shape)}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep, **rows[name],
                "library_ms": None}
               for name, (src, rep) in KERNELS.items()]
    for k in kernels:
        log(f"[kernels] {k['name']}: {k['launches']} launches on the main paths, "
            f"{k['ms']:.4f} ms ({k['ms_source']}) against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), "
            f"{100 * k['bound_ms'] / k['ms']:.1f}% of bound; plain {k['plain_ms']:.4f} ms")
    log(f"[kernels] NTT ms and plain_ms below are at the demo's blind-distance shape "
        f"(int64 u32: tpu {main_shapes['tpu']}, u64: seal {main_shapes['seal']}; u32 out: "
        f"{u32_shape}); the fused behz kernels at batch {MUL_BATCH} (width 2), the separate "
        f"ones per call at n = {MUL_SEP_N}, batch {MUL_SEP_BATCH}; the behz64 kernels per "
        f"call on the seal chain n = {SEAL_MUL[0][0]}, batch {SEAL_MUL[0][2]}, width "
        f"{SEAL_MUL[0][3][0]}; mulmod_chain at {PROBE_SHAPE}; library_ms null: no PyTorch "
        f"call computes these functions")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
