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
3b. modmath -- the m62 profile's elementwise kernels (``csrc/modmath64.cu``:
               one launch an op of ``ops.modmath.m62``) at the demo's shapes
               on the seal chain of n = 8192: residues of the encryption's
               batch [3, 5, 8192] against the key spectra [5, 8192] and
               the per-limb constants [5, 1], each kernel bit-exact against
               the plain chain (``m62_plain``) on the same card tensors;
               each kernel's device time (torch.profiler) against the bytes
               bound (each operand read and the result written once at
               ``pplp_bench/yardstick.py``'s 3.35 TB/s) and the plain
               chain's CUDA-event time; the kernels line's launches are the
               slice phase's demos' (each counted alone: the seal demo
               launches every kernel the BFV stages use, the tpu demo none);
4. bloom    -- every Bloom filter of the main paths built twice on the card,
               with the kernels (``csrc/bloom.cu``: a packed table of u32
               words) and with the plain version (the unpacked table,
               ``index_fill_``): the demo's filter at r = 4096 and 8192 (fpp
               1e-12, ``mixed`` as the CLI runs it and the reference's
               indexing; the partitioned insert), the client/server filter
               at r = 4096 (fpp 1e-4; the sub-slice insert, 614 sub-slices),
               BASELINE config[3]'s (r = 99, ``mixed``, probed from blind
               distances; the direct kernel) and a
               ``CompressibleBloomFilter`` compressed twice;
               ``serialize()`` equal byte for byte and the probe verdicts
               equal on 100,000 inserted and 100,000 outside keys; each
               partitioned kernel against its plain step on the demo's first
               chunk, each sub-slice kernel against its plain step on the
               client/server filter's first chunk into a table that already
               holds bits, and the direct kernel forced on the client/server
               filter's keys beside the route; each insert kernel's device
               time and the call's
               CUDA-event time beside the bound, the sector model and the
               design's floor (``measure_bloom``), and the plain versions'
               times; each filter's probe (``measure_bloom.probe_row``): its
               device time and the call's CUDA-event time beside its bound,
               sector model, the bits it tests and the launch floor (an
               empty kernel at the probe's geometry);
5. slice    -- the local proximity demo (``run_local_demo``) at -d 13 -b 56,
               on the seal profile (the CLI's default) and on the tpu profile:
               r = 4096 with a near pair and r = 128 with a far pair, then on
               seal at the reference's r = 8192 a near and a far pair. Each
               verdict must equal the clear oracle, the blind distance must
               equal s(d^2 + r) mod t, the profile's NTT kernel and the Bloom
               insert kernels (as ``bloom_cuda.insert_plan`` routes the
               filter) must have been launched and the filter
               must live on the card; stage times and peak device memory;
6. multiply -- the BFV ct x ct multiply at n = 4096 on the tpu chain
               (4 primes, |B_sk| = 6), t = 2^16, batch 256, through
               ``Evaluator``: multiply + relinearize with width-2 (default)
               and width-1 keys, multiply alone, relinearize alone, and one
               real product (encrypt, multiply + relinearize, decrypt) equal
               to the host negacyclic product; the fused kernels
               (behz_to_bsk, behz_tensor_ntt, behz_floor_sk, behz_relin_ntt)
               must have been launched. Each kernel's wrapper step is then
               held bit-exact against its plain version (the plain version
               runs the plain NTTs) and timed with CUDA events beside it;
7. probe    -- the mulmod chain (16 Shoup products) on [256, 4, 4096],
               bit-exact against its plain version, with times and mulmods/s,
               and its rate at 256 steps, where it is bound by integer work;
8. pipeline -- BASELINE config[3], ``build_packed_pipeline_bf``: 102,400
               coefficient-packed checks (25 rows at n = 4096, tpu chain,
               t = 2^20, s = 501, r = 99, w = 0xA5A5, a filter of r^2 keys at
               fpp 1e-4, half the points near). Every result must equal the
               host oracle (clear blind distance -> key -> probe) with no false
               negatives, every decoded blind distance and verdict of the
               fused route (``ops.pipeline_cuda``) must equal the plain torch
               chain's, the device decode must equal the host CRT decode on
               two rows, and the step must have made the fused route's
               launches (two forward, one inverse, combine, decode); the
               step's CUDA-event time (median of windows), its split
               (homomorphic evaluation / decode / probe), checks/s, peak
               memory, and the device's busy share and largest kernels
               under ``torch.profiler``;
9. separate -- the multiply + relinearization at n = 32768 (31 primes,
               |B_sk| = 33, batch 2, width 2) through ``Evaluator``, where the
               fused kernels' rows do not fit in shared memory: the u32
               transforms around behz_tensor, behz_lift, behz_keyprod and
               behz_add, which must have been launched; the call bit-exact
               against the plain version, then each of those kernels' steps
               bit-exact against its plain step on the same inputs, and its
               device time per call (torch.profiler) beside the plain step's.
               It runs after the pipeline, so that its context does not
               count in the pipeline's peak memory;
10. seal_multiply -- the seal (m62) multiply + relinearization through
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
11. seal_surface -- special-prime key switching, Galois rotations, the
               batch encoder and CKKS. On the seal chain of the CLI's -d 13
               (n = 8192, 5 primes, a 61-bit special prime P), batch 64, and
               on the multiply phase's tpu chain (n = 4096, 4 primes, a
               30-bit P), batch 256, each with t a 20-bit batching prime:
               batch-encoded slot vectors encrypted, rotated by +1, -1 and
               the column swap with SP and with gadget Galois keys, and
               multiplied (``Evaluator``) and relinearized with SP keys
               and width-1 and width-2 gadget keys; every result bit-exact
               against the same call on a CPU copy of the context, keys and
               inputs (2 batch rows), decrypted rows equal to the rotated
               slots and the slot-wise products; the profile's NTT kernels
               and behz_relin_ntt (tpu) or behz64_keyprod (seal) launched;
               ``save_sp_keys`` card == CPU byte for byte, loaded back; the
               NTT on the QP tables against plain; CUDA-event times of
               sp_relinearize, of each rotation by key kind and of the
               gadget relinearization, and the profiler's device-time split
               of one sp_relinearize (NTT kernels against elementwise
               torch). Then CKKS on the tpu profile: the aggregation demo
               at its defaults, the networked pair over 127.0.0.1 at
               n = 8192 summing 256 values (within 1e-2), and
               ``ckks_multiply`` with SP relinearization and
               ``ckks_rescale`` at n = 8192 on four 28-bit primes, scale
               2^26, batch 64, bit-exact against the CPU copy and decoding
               within 1e-2 of the clear product. Peak memory;
12. network -- the networked entry points at the CLI's -d 13 -b 56, with
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
               the server's setBF, homoCalc and sendBF stages;
13. dgk     -- the DGK back-end (BASELINE config[2]) at (k, t, l) =
               (2048, 320, 16), keys from seed 5 (bench.py): each kernel of
               ``csrc/dgk_mont.cu`` (mulmod in both forms, per-lane and
               shared-exponent powmod, the blind-distance chain) bit-exact
               against its plain version at 67 lanes with 0, 1, 2, n - 1,
               n - 2 among them and exponents 0 and 1, and so at random odd
               moduli of every other compiled width (and a 384-bit one, run
               at the next width up); then B = 10,000 comparisons through
               ``DGKBatch``: five ``encrypt_batch`` (800-bit randomness),
               ``blind_distance_batch`` (123321, 123654, s = 37, as bench.py),
               ``decrypt_batch_device``; every lane equals s(d^2 + r) mod u,
               every ciphertext decrypts to its message, 256 lanes of each
               equal Python's pow, and the BSGS decrypt agrees on 1,000 lanes;
               the kernels' device times (profiler) beside their bounds and
               the plain versions' times on the same inputs, the BSGS giant
               step's one-product form and the BSGS call's split (giant
               steps, c^vpq, table probe and select, host), the calls' times,
               comparisons/s eval-only and full, and peak memory; last
               ``dgk_sweep_main`` over r = 16, 128, 256 and 4096 (four of its
               nine default radii) with its Bloom filter on
               the card: the reference's CSV, and every verdict the mod-u
               oracle calls near read near;
14. twopc   -- the 2PC predicates (``secure2pc``; plain torch on the card,
               no kernel of its own). In process: circle (15-bit
               coordinates, r = 5000) and polygon (the reference's square of
               radius 1000, points in [-2000, 2000)) at B = 2^20 and 2^24,
               both ``yao_bug`` values: every correct verdict equals the host
               oracle, the bug variants at 2^20 equal the same calls on the
               CPU; on 4,096 lanes of numpy words both variants' verdicts and
               a Beaver product's shares equal the CPU's bit for bit; each
               call's CUDA-event time (median of windows), instances/s,
               kernels a call and device busy share (profiler), peak memory.
               Networked over 127.0.0.1 (two threads, each party on the
               card, the CLI's 2048-bit group): circle and polygon, open and
               yao, B = 256, verdicts equal to the oracle on both sides,
               each side's bytes sent equal to the other's received; wall
               time split into OT triples, gates and Yao. Last ``cli 2pc
               -r 0`` and ``-r 1`` as processes at the defaults (circle,
               yao, --otp-bits 2048, --device cuda): README's pair at r =
               300 CLOSE, at r = 100 FAR, a point inside and one outside the
               square (``--circuit poly``), on both sides;
15. multidevice -- the sharded paths (``parallel/``) in gloo ranks that
               share the one card (``parallel/multiproc_smoke.py``: one fresh
               process a rank, the kernels built before they start; a rank
               that fails or outlives its limit ends the run non-zero):
               ``DistMultiplier`` at n = 32768 (31 primes, |B_sk| = 33,
               batch 2, width 2) on coeff = 2 and coeff = 4, and at n = 4096
               (4 primes), t = 2^16, batch 256, widths 1 and 2 on dp 2 x
               coeff 2, each bit-exact against the single-process kernels
               (``Evaluator`` on the separate route, ``FusedMultiplier``);
               the distributed NTT on [2, 31, 32768] at coeff = 4 (rows,
               round trip, product); the sharded ``build_packed_pipeline_bf``
               on dp 2 x coeff 2, all 102,400 gathered verdicts equal to the
               pipeline phase's host oracle. Every separate-route kernel and
               transform must have been launched by the ranks (their counts
               go into the kernels line). Times per rank and their max
               (CUDA events around a call, median of 5), the same call's
               split into its exchanges (timed where they happen, the
               card synchronized around each) and the rest, bytes a rank
               sends a call, and the same code at S = 1 in one process:
               ranks sharing one card, never a scaling figure.

The last lines are a JSON object with one entry per kernel (launches on
the main paths, max error, ms and plain ms as measured here, ``ms_source``:
"profiler" where ms is the kernel's device time under torch.profiler,
"events" where it is the CUDA-event time of its wrapper step, the bound:
the larger of the bytes the kernel's interface moves over 3.35 TB/s and its
Shoup products over the card's integer-multiply peak,
``measure_multiply.MULMODS_PER_S`` (the Bloom kernels: each input read and
each output written once, and their indices' 32-bit multiplies at
``MULS_PER_S``, ``measure_bloom``; beside the direct insert's
``sector_ms``, one random 32-byte sector a bit, and beside the probe's its
``launch_floor_ms``, an empty kernel's device time at the probe's
geometry); ``library_ms`` null, since no PyTorch call computes
a negacyclic modular NTT, the BEHZ multiply, a Shoup chain or a Bloom
filter's hashed scatter and gather), the card's
name and power limit, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
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
# The reference's largest radius (seal): d^2 = 99,700 near, 85,311,700 > 8192^2 far.
DEMO_R8192_CASES = ((8192, 1234, 1212, 1000, 1000), (8192, 10234, 1212, 1000, 1000))
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
DGK_KEYS = (2048, 320, 16)  # (k, t, l) of bench.py:165, BASELINE config[2]
DGK_SEED = 5
DGK_B = 10_000  # lanes of the main path
DGK_CHECK_B = 64  # lanes of the kernel-against-plain checks (plus edge cases)
DGK_BSGS_B = 1_000
DGK_POW_LANES = 256  # lanes of each ciphertext recomputed with Python's pow
DGK_XB, DGK_YB, DGK_S = 123321, 123654, 37  # bench.py:171
DGK_TPU = "pplp_tpu/dgk/modexp.py:111"  # the XLA CIOS: no TPU kernel
# Four of dgk_sweep_main's nine default radii (main.cc:300): the smallest,
# the mod-u oracle's last far and first near, the largest.
DGK_SWEEP_RADII = [16, 128, 256, 4096]
# Random odd moduli of the other widths, at the small batch: 384 bits
# (W = 13, run at 17), then W = 17, 33, 97 and 129.
DGK_OTHER_BITS = (384, 520, 1035, 3081, 4105)
BLOOM_T_BITS = 56  # the demo's t: the blinding of the demo's filters
# The demo's filter (fpp 1e-12, the CLI default ``mixed`` and the reference's
# indexing), then the client/server filter (fpp 1e-4): (r, mode, fpp).
BLOOM_FILTERS = ((4096, "mixed", 1e-12), (4096, "reference", 1e-12), (8192, "mixed", 1e-12),
                 (8192, "reference", 1e-12), (4096, "mixed", 1e-4))
BLOOM_KEYS = 100_000  # inserted keys probed, and as many outside keys
BLOOM_COMPRESSED = (200_000, (30.0, 20.0))  # keys, the compressions between thirds
# The insert kernels: direct (one launch), sub-slice (count, scatter, apply
# a chunk of keys into a table of SUBSLICE_MIN_BITS to DIRECT_MAX_BITS bits)
# and partitioned (count, scatter, apply a chunk, a larger table).
BLOOM_INSERT = ("bf_insert", "bf_insert_sub_count", "bf_insert_sub_scatter",
                "bf_insert_sub_apply", "bf_insert_count", "bf_insert_scatter", "bf_insert_apply")
BLOOM_XLA = {**dict.fromkeys(BLOOM_INSERT, "pplp_tpu/primitives/bloom.py:200"),  # _insert_scan_fn
             "bf_probe": "pplp_tpu/primitives/bloom.py:224"}  # _contains_fn
# Launches of the Bloom kernels on the main paths (slice, pipeline, network,
# dgk and the ranks of multidevice), summed as the phases run.
BLOOM_MAIN = dict.fromkeys(BLOOM_XLA, 0)


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
    **{name: ("pplp_tpu_torch/csrc/dgk_mont.cu", DGK_TPU) for name in (
        "dgk_mulmod", "dgk_powmod_lanes", "dgk_powmod_shared", "dgk_blind_distance")},
    # No TPU kernel: the reference runs the m62 arithmetic as XLA on u32 pairs.
    **{name: ("pplp_tpu_torch/csrc/modmath64.cu", "pplp_tpu/ops/modmath.py:283") for name in (
        "m62_add", "m62_sub", "m62_neg", "m62_shoup", "m62_mulmod", "m62_reduce128",
        "m62_shoup_pre")},
    # No TPU kernel: the reference's Bloom filter runs as XLA (and native C++).
    **{name: ("pplp_tpu_torch/csrc/bloom.cu", xla) for name, xla in BLOOM_XLA.items()},
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
    from pplp_tpu_torch.ops import (behz64_cuda, behz_cuda, bloom_cuda, cuda_build, dgk_cuda,
                                    modmath_cuda, mulmod_chain, ntt_cuda, pipeline_cuda)

    t0 = time.perf_counter()
    paths = cuda_build.build(sorted(cuda_build.CSRC.glob("*.cu")))
    for mod in (ntt_cuda, behz_cuda, behz64_cuda, mulmod_chain, dgk_cuda, bloom_cuda,
                pipeline_cuda, modmath_cuda):
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


# The m62 ops' input bounds in multiples of q (1 where the op takes
# canonical residues): the Shoup product takes the butterflies' 4q.
M62_INPUT_BOUND = {"mulmod_shoup": 4}
# The kernels the demo's BFV stages launch (kGen, enc, homoCalc; the
# decrypt's too): every one but the general product.
M62_DEMO_KERNELS = ("m62_add", "m62_sub", "m62_neg", "m62_shoup", "m62_reduce128",
                    "m62_shoup_pre")
MODMATH_BATCH = 3  # the demo's encryption batch (u, 2xa, 2ya)
MODMATH_PROFILE_CALLS = 20


def _m62_demo_operands(op, tb, gen):
    """``op``'s operands at the demo's shapes on the card: x [3, L, n] below
    its input bound, the second residue operand [3, L, n], a key spectrum
    [L, n] with its Shoup companions for the products, q and 2q as [L, 1],
    the sampler's four word planes [3, 4, L, n] for reduce128."""
    import torch

    from pplp_tpu_torch.ops.modmath import m62_plain

    q2 = tb.q_b(1)

    def res(lead, bound=1):
        x = torch.randint(0, 1 << 62, lead + (tb.L, tb.n), generator=gen, device=tb.device,
                          dtype=torch.int64)
        return x % (bound * q2)

    batch = (MODMATH_BATCH,)
    x = res(batch, M62_INPUT_BOUND.get(op, 1))
    if op == "mulmod_shoup":
        w = res(())
        return (x, w, m62_plain(tb.mu_b(1)).shoup_precompute(w, q2), q2)
    if op in ("add", "sub", "mulmod"):
        return (x, res(batch), q2)
    if op == "reduce128":
        words = torch.randint(0, 1 << 32, batch + (4, tb.L, tb.n), generator=gen,
                              device=tb.device, dtype=torch.int64)
        return (tuple(words[:, i] for i in range(4)), q2)
    return (x, q2)  # neg, shoup_precompute


def _m62_device_ms(fn, kernel: str, calls: int):
    """Device ms a launch of ``kernel`` over ``calls`` calls of fn, from
    torch.profiler (None if it recorded none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and f"{kernel}(" in e.name]
    return sum(us) / len(us) / 1e3 if us else None


def phase_modmath(dev) -> dict:
    """Each m62 kernel at the demo's shapes against the plain chain on the
    same card tensors; its device time against the bytes bound. Returns the
    kernels' rows (their launches are the slice phase's)."""
    import torch

    from pplp_bench.yardstick import HBM_BYTES_PER_S
    from pplp_tpu_torch.ops import modmath_cuda, ntt
    from pplp_tpu_torch.ops.modmath import m62_plain
    from pplp_tpu_torch.ops.primes import Modulus

    card = torch.cuda.get_device_name(dev)
    n = 1 << DEMO_N_BITS
    tb = ntt.build_tables([Modulus(q) for q in _chain("seal", n)], n, dev)
    gen = torch.Generator(device=dev).manual_seed(2026)
    plain = m62_plain(tb.mu_b(1))
    rows = {}
    for op, (kernel, _) in modmath_cuda.OPS.items():
        args = _m62_demo_operands(op, tb, gen)
        fn, plain_fn = getattr(tb.prof, op), getattr(plain, op)
        before = modmath_cuda.launches_by_kernel[kernel]
        got = fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        assert modmath_cuda.launches_by_kernel[kernel] == before + 1, f"{op}: not one launch"
        differ = int((got != want).sum())
        assert differ == 0, f"{kernel}: {differ} of {got.numel()} residues differ from plain"
        flat = [a for arg in args for a in (arg if isinstance(arg, tuple) else (arg,))]
        nbytes = 8 * (got.numel() + sum(a.numel() for a in flat if torch.is_tensor(a)))
        ms, source = _m62_device_ms(lambda: fn(*args), kernel, MODMATH_PROFILE_CALLS), "profiler"
        if ms is None:  # the profiler missed the window: the call's CUDA events
            ms, source = cuda_ms(lambda: fn(*args)), "events"
        row = rows[kernel] = {"max_abs_err": differ, "ms": ms, "ms_source": source,
                              "plain_ms": cuda_ms(lambda: plain_fn(*args), iters=10),
                              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"[modmath] {kernel} {tuple(got.shape)}: == plain chain; {ms:.4f} ms ({source}), "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes), "
            f"{100 * row['bound_ms'] / ms:.1f}% of bound; plain {row['plain_ms']:.4f} ms "
            f"[{card}]")
    return rows


def _bloom_counted(counts: dict):
    for k, v in counts.items():
        BLOOM_MAIN[k] += v


def _bloom_launches(inserts, probes: int = 0) -> dict:
    """The Bloom launches by kernel of inserting ``count`` keys into a
    filter of ``count`` projected keys at fpp ``fpp`` (``inserts``: (count,
    fpp) pairs), and ``probes`` probe launches: ``bloom_cuda.insert_plan``'s
    route for each."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import BloomParameters

    out = dict.fromkeys(BLOOM_MAIN, 0)
    for count, fpp in inserts:
        p = BloomParameters(projected_element_count=count, false_positive_probability=fpp)
        assert p.compute_optimal_parameters()
        plan = bloom_cuda.insert_plan(p.table_size, p.number_of_hashes, count)
        for k, v in plan.launches().items():
            out[k] += v
    out["bf_probe"] = probes
    return out


def _partition_steps(tag, kbf, bl, plan, card) -> dict:
    """The partitioned kernels, one launch each on the first chunk of the
    filter's keys (blinded, from 0), each against its plain version: the
    blocks' histograms and the chunk's totals against ``index_put_``
    counts of idx >> slice_log2; the stash (u32) against the chunk's
    indices sorted by bucket (stable argsort), equal as sorted sets, its
    buckets in order; the table after the apply against ``index_fill_`` of
    the plain stash, byte for byte. Returns (max error, plain ms) by
    kernel."""
    import torch

    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import distance_keys

    dev = kbf.bits_device.device
    salts, sizes, mixed = kbf._salts_device(), kbf._sizes(), kbf.index_mode == "mixed"
    n, nb = plan.chunk_keys, plan.buckets
    blinded = (bl.s, bl.r, bl.w, bl.w_len, 0, n)
    words = torch.zeros_like(kbf.bits_device)
    stash, hist, counts = bloom_cuda.partition_buffers(plan, dev)
    bloom_cuda.count_cuda(words, salts, sizes, mixed, plan, hist, counts[0], blinded=blinded)
    bloom_cuda.scatter_cuda(words, salts, sizes, mixed, plan, hist, counts[0], stash,
                            blinded=blinded)
    bloom_cuda.apply_cuda(words, stash, n * plan.n_salts)
    klo, khi = distance_keys(torch.arange(n, device=dev), bl.s, bl.r, bl.w, bl.w_len)
    flat = bloom._indices(klo, khi, salts, sizes, mixed).t().reshape(-1)  # key-major, as a block
    bucket = flat >> plan.slice_log2
    tile = torch.arange(flat.numel(), device=dev) // (plan.n_salts * plan.tile_keys)
    bits = torch.zeros(kbf.table_size, dtype=torch.uint8, device=dev)

    def plain_count():
        h = torch.zeros(n // plan.tile_keys, nb, dtype=torch.int64, device=dev)
        return h.index_put_((tile, bucket), torch.ones_like(bucket), accumulate=True)

    def plain_scatter():
        return flat[torch.argsort(bucket, stable=True)]

    want_hist, want_stash = plain_count(), plain_scatter()

    def plain_apply():
        bits.index_fill_(0, want_stash, 1)

    plain_apply()
    got = stash.to(torch.int64) & 0xFFFFFFFF
    got_b = got >> plan.slice_log2
    err = {"bf_insert_count": max(int((hist.to(torch.int64) - want_hist).abs().max()),
                                  int((counts[0, :nb].to(torch.int64) - want_hist.sum(0))
                                      .abs().max())),
           "bf_insert_scatter": int((torch.sort(got).values - torch.sort(want_stash).values)
                                    .abs().max()),
           "bf_insert_apply": int((words.view(torch.uint8)[:kbf.table_size // 8].to(torch.int16)
                                   - bloom.pack_bits(bits).to(torch.int16)).abs().max())}
    torch.cuda.synchronize()
    assert not any(err.values()), f"{tag}: a partitioned kernel differs from plain: {err}"
    assert bool((got_b[1:] >= got_b[:-1]).all()), f"{tag}: the stash is not in bucket order"
    plain = {"bf_insert_count": cuda_ms(plain_count, 3, 1),
             "bf_insert_scatter": cuda_ms(plain_scatter, 3, 1),
             "bf_insert_apply": cuda_ms(plain_apply, 3, 1)}
    log(f"[bloom] {tag}: the partitioned kernels on the first chunk ({n} keys, {nb} buckets of "
        f"2^{plan.slice_log2} bits) equal their plain versions (histograms {tuple(hist.shape)} "
        f"and totals; the stash of {got.numel()} indices in bucket order; the table's bytes); "
        f"plain ms a chunk " + ", ".join(f"{k} {v:.4f}" for k, v in plain.items())
        + f" [{card}]")
    return {k: (err[k], plain[k]) for k in err}


def _subslice_steps(tag, kbf, bl, plan, card) -> dict:
    """The sub-slice kernels, one launch each on the first chunk of the
    filter's keys (blinded, from 0) into a table that already holds bits
    (a quarter of them, random), each against its plain version: the
    chunk's totals against a bincount of idx >> slice_log2; the stash (u32)
    against the chunk's indices, equal as sorted sets, in bucket order, and
    its offsets against the totals' exclusive scan; the table after the
    apply against ``index_fill_`` of the chunk's indices into the unpacked
    table, byte for byte, the last word's bits above the table as they
    were. Returns (max error, plain ms) by kernel."""
    import torch

    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import distance_keys

    dev = kbf.bits_device.device
    salts, sizes, mixed = kbf._salts_device(), kbf._sizes(), kbf.index_mode == "mixed"
    n, nb, ts = plan.chunk_keys, plan.buckets, kbf.table_size
    blinded = (bl.s, bl.r, bl.w, bl.w_len, 0, n)
    gen = torch.Generator(device=dev).manual_seed(18)

    def random_words():
        return torch.randint(-(1 << 31), 1 << 31, kbf.bits_device.shape, generator=gen,
                             dtype=torch.int32, device=dev)

    words = random_words() & random_words()
    before = words.clone()
    stash, counts = bloom_cuda.subslice_buffers(plan, dev)
    bloom_cuda.sub_count_cuda(words, salts, sizes, mixed, plan, counts[0], blinded=blinded)
    bloom_cuda.sub_scatter_cuda(words, salts, sizes, mixed, plan, counts[0], stash,
                                blinded=blinded)
    bloom_cuda.sub_apply_cuda(words, salts, sizes, plan, counts[0], stash)
    klo, khi = distance_keys(torch.arange(n, device=dev), bl.s, bl.r, bl.w, bl.w_len)
    flat = bloom._indices(klo, khi, salts, sizes, mixed).reshape(-1)
    bucket = flat >> plan.slice_log2
    bits = bloom.unpack_words(before, ts)

    def plain_count():
        return torch.bincount(bucket, minlength=nb)

    def plain_scatter():
        return flat[torch.argsort(bucket, stable=True)]

    want_totals, want_stash = plain_count(), plain_scatter()

    def plain_apply():
        bits.index_fill_(0, want_stash, 1)

    plain_apply()
    got_counts = counts[0].to(torch.int64) & 0xFFFFFFFF
    got = stash.to(torch.int64) & 0xFFFFFFFF
    got_b = got >> plan.slice_log2
    offsets = torch.cumsum(want_totals, 0) - want_totals
    top = ~((1 << (ts % 32)) - 1) if ts % 32 else 0
    err = {"bf_insert_sub_count": int((got_counts[:nb] - want_totals).abs().max()),
           "bf_insert_sub_scatter": max(
               int((torch.sort(got).values - torch.sort(want_stash).values).abs().max()),
               int((got_counts[2 * nb:] - offsets).abs().max())),
           "bf_insert_sub_apply": max(
               int((words.view(torch.uint8)[:ts // 8].to(torch.int16)
                    - bloom.pack_bits(bits).to(torch.int16)).abs().max()),
               int((words[-1] & top) != (before[-1] & top)))}
    torch.cuda.synchronize()
    assert not any(err.values()), f"{tag}: a sub-slice kernel differs from plain: {err}"
    assert bool((got_b[1:] >= got_b[:-1]).all()), f"{tag}: the stash is not in bucket order"
    plain = {"bf_insert_sub_count": cuda_ms(plain_count, 3, 1),
             "bf_insert_sub_scatter": cuda_ms(plain_scatter, 3, 1),
             "bf_insert_sub_apply": cuda_ms(plain_apply, 3, 1)}
    log(f"[bloom] {tag}: the sub-slice kernels on the first chunk ({n} keys, {nb} buckets of "
        f"2^{plan.slice_log2} bits) into a table a quarter full equal their plain versions "
        f"(totals; the stash of {got.numel()} indices in bucket order and its offsets; the "
        f"table's bytes); plain ms a chunk " + ", ".join(f"{k} {v:.4f}" for k, v in plain.items())
        + f" [{card}]")
    return {k: (err[k], plain[k]) for k in err}


def _bloom_check(tag, kbf, plain, inserted, outside, sizes, card):
    """``kbf`` (kernel filter) against the unpacked ``plain`` table on the
    card: serialize() bytes, then the probe verdicts of the inserted and the
    outside keys ((lo, hi) pairs), then the probe's row
    (``measure_bloom.probe_row``, one round). Returns (max |byte diff|, max
    |verdict diff|)."""
    import torch

    from pplp_tpu_torch.measure_bloom import probe_row
    from pplp_tpu_torch.primitives import bloom

    salts, mixed = kbf._salts_device(), kbf.index_mode == "mixed"
    packed = bloom.pack_bits(plain)
    kbytes = kbf._packed_device()
    byte_err = int((kbytes.to(torch.int16) - packed.to(torch.int16)).abs().max())
    assert byte_err == 0, f"{tag}: the table's bytes differ from the plain table's"
    wire = kbf.serialize()
    assert wire == kbf._header_bytes() + packed.cpu().numpy().tobytes() + kbf._tail(), (
        f"{tag}: serialize() differs from the plain table's bytes")
    klo = torch.cat([inserted[0], outside[0]])
    khi = torch.cat([inserted[1], outside[1]])
    got = kbf.contains_u64_batch(klo, khi)
    want = bloom.probe_plain(plain, klo, khi, salts, sizes, mixed)
    torch.cuda.synchronize()
    verdict_err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    n_in = inserted[0].numel()
    assert verdict_err == 0, f"{tag}: probe verdicts differ from the plain version"
    assert bool(got[:n_in].all()), f"{tag}: an inserted key probes absent"
    plain_ms = cuda_ms(lambda: bloom.probe_plain(plain, klo, khi, salts, sizes, mixed), 5, 1)
    log(f"[bloom] {tag}: serialize() == plain bytes ({len(wire)} B); verdicts equal on "
        f"{n_in} inserted (all present) and {outside[0].numel()} outside keys "
        f"({int(got[n_in:].sum())} false positives); plain probe {plain_ms:.4f} ms [{card}]")
    probe_row(f"[bloom] {tag}", lambda: kbf.contains_u64_batch(klo, khi), kbf.bits_device,
              (klo, khi), salts, sizes, mixed, card, rounds=1)
    return byte_err, verdict_err


def phase_bloom(dev):
    """Every filter of the main paths built twice on the card, with the
    kernels and with the plain version; returns the kernel rows."""
    import numpy as np
    import torch

    from pplp_tpu_torch.measure_bloom import (design_floor, insert_bound, insert_split,
                                              partition_bounds, probe_row, subslice_bounds)
    from pplp_tpu_torch.measure_ntt import device_ms
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.parallel import pipeline
    from pplp_tpu_torch.primitives import bloom
    from pplp_tpu_torch.primitives.blinding import (Blinding, blind_distance_keys,
                                                    blinded_keys, distance_keys)

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    err = dict.fromkeys(BLOOM_MAIN, 0)
    rows = {}

    def params(count, fpp, mode, cls=bloom.BloomFilter):
        p = bloom.BloomParameters(projected_element_count=count, false_positive_probability=fpp,
                                  random_seed=0xA5A5A5A5, index_mode=mode)
        assert p.compute_optimal_parameters()
        return cls(p, device=dev)

    def timed_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # 1. The demo's and the client/server filters: r^2 blinded keys made by
    # the insert kernel against blind_distance_keys + index_fill_.
    for radius, mode, fpp in BLOOM_FILTERS:
        sq = radius * radius
        bl = Blinding.for_protocol(BLOOM_T_BITS, sq, seed=7)
        kbf = params(sq, fpp, mode)
        sizes, salts, mixed = kbf._sizes(), kbf._salts_device(), mode == "mixed"
        t_k = timed_s(lambda: kbf.insert_blind_distances(bl, sq))
        plain = torch.zeros(kbf.table_size, dtype=torch.uint8, device=dev)

        def plain_insert():
            for klo, khi, _ in blind_distance_keys(bl, sq, dev):
                bloom.insert_plain(plain, klo, khi, salts, sizes, mixed)

        klo, khi, _ = next(blind_distance_keys(bl, sq, dev))  # warm the plain ops up
        bloom.insert_plain(plain, klo, khi, salts, sizes, mixed)
        t_p = timed_s(plain_insert)
        di_in = torch.randint(0, sq, (BLOOM_KEYS,), generator=gen, device=dev)
        di_out = sq + torch.randint(0, 1 << 30, (BLOOM_KEYS,), generator=gen, device=dev)
        keys = [distance_keys(d, bl.s, bl.r, bl.w, bl.w_len) for d in (di_in, di_out)]
        tag = f"r={radius} {mode} fpp {fpp:g} ({kbf.table_size} bits, {kbf.salt_count} salts)"
        b_err, v_err = _bloom_check(tag, kbf, plain, *keys, sizes, card)
        plan = bloom_cuda.insert_plan(kbf.table_size, kbf.salt_count, sq)
        for name in plan.launches():
            err[name] = max(err[name], b_err)
        err["bf_probe"] = max(err["bf_probe"], v_err)

        def insert():
            kbf.insert_blind_distances(bl, sq)

        bloom_cuda.reset_launches()
        insert()
        got = {k: v for k, v in bloom_cuda.launches_by_kernel.items() if v}
        assert got == plan.launches(), f"{tag}: launches {got}, planned {plan.launches()}"
        split = insert_split(insert)
        call_ms = cuda_ms(insert, 3, 1)
        ms = sum(split[k] for k in plan.launches())
        ib = insert_bound(sq, kbf.salt_count, kbf.table_size, mixed, key_bytes=0)
        floor = design_floor(plan)
        route = ("direct, one launch" if plan.route == "direct" else
                 f"{plan.route}: {plan.chunks} chunks of {plan.chunk_keys} keys, {plan.buckets} "
                 f"buckets of 2^{plan.slice_log2} bits")
        log(f"[bloom] {tag}: insert ({route}) {ms:.4f} ms of kernels (profiler: "
            + ", ".join(f"{k} {split[k]:.4f}" for k in plan.launches())
            + f"; all kernels of the call {split['total']:.4f}), the call {call_ms:.4f} ms "
            f"(CUDA events; first call {1e3 * t_k:.1f} ms), plain {1e3 * t_p:.1f} ms; "
            f"{sq * kbf.salt_count / ms / 1e6:.2f}G bit sets/s; bound "
            f"{ib['bound_ms']:.4f} ms ({ib['bound_by']}), {100 * ib['bound_ms'] / ms:.2f}%; "
            f"sector model {ib['sector_ms']:.4f} ms, {100 * ib['sector_ms'] / ms:.1f}%; the "
            f"design's floor {floor:.4f} ms, {100 * floor / ms:.1f}% [{card}]")
        if (radius, mode, fpp) == BLOOM_FILTERS[0]:  # the demo's setBF: the main path's shape
            steps = _partition_steps(tag, kbf, bl, plan, card)
            bounds = partition_bounds(plan, mixed)
            for name, (s_err, s_plain) in steps.items():
                err[name] = max(err[name], s_err)
                rows[name] = {"max_abs_err": 0, "ms": split[name] / plan.chunks,
                              "ms_source": "profiler", "plain_ms": s_plain, **bounds[name]}
        if (radius, mode, fpp) == BLOOM_FILTERS[-1]:  # the C/S filter: the sub-slice route
            assert plan.route == "subslice", f"{tag}: {plan}"
            steps = _subslice_steps(tag, kbf, bl, plan, card)
            bounds = subslice_bounds(plan, mixed)
            for name, (s_err, s_plain) in steps.items():
                err[name] = max(err[name], s_err)
                rows[name] = {"max_abs_err": 0, "ms": split[name] / plan.chunks,
                              "ms_source": "profiler", "plain_ms": s_plain, **bounds[name]}
            # ... beside the direct kernel, forced on the same keys.
            direct = torch.zeros_like(kbf.bits_device)

            def insert_direct():
                bloom_cuda.insert_direct(direct, salts, sizes, mixed,
                                         blinded=(bl.s, bl.r, bl.w, bl.w_len, 0, sq))

            split_d = insert_split(insert_direct)
            err["bf_insert"] = max(err["bf_insert"], int(not torch.equal(direct,
                                                                         kbf.bits_device)))
            rows["bf_insert"] = {"max_abs_err": 0, "ms": split_d["bf_insert"],
                                 "ms_source": "profiler", "plain_ms": 1e3 * t_p, **ib}
            log(f"[bloom] {tag}: the direct kernel forced on the same keys "
                f"{split_d['bf_insert']:.4f} ms (profiler), its words equal the route's; the "
                f"sub-slice route {ms:.4f} ms, {split_d['bf_insert'] / ms:.2f}x [{card}]")
            del direct
        del kbf, plain, keys
        torch.cuda.empty_cache()

    # 2. BASELINE config[3]'s filter (r = 99, mixed; staged in shared memory
    # by the probe): the pipeline's keys given as words, and its probe from
    # blind distances at the step's 102,400 checks.
    t = 1 << PIPE_T_BITS
    w_len = PIPE_W.bit_length()
    kbf = pipeline.build_pipeline_filter(t, PIPE_S, PIPE_R, PIPE_W, dev)
    sizes, salts = kbf._sizes(), kbf._salts_device()
    sq = PIPE_R * PIPE_R
    bd_all = PIPE_S * (torch.arange(sq, dtype=torch.int64, device=dev) + PIPE_R) % t
    plain = torch.zeros(kbf.table_size, dtype=torch.uint8, device=dev)
    bloom.insert_plain(plain, *blinded_keys(bd_all, PIPE_W, w_len), salts, sizes, True)
    bd_in = bd_all[torch.randint(0, sq, (BLOOM_KEYS,), generator=gen, device=dev)]
    bd_out = torch.randint(0, t, (BLOOM_KEYS,), generator=gen, device=dev)
    tag = f"config[3] r={PIPE_R} mixed ({kbf.table_size} bits, {kbf.salt_count} salts)"
    b_err, v_err = _bloom_check(
        tag, kbf, plain, blinded_keys(bd_in, PIPE_W, w_len), blinded_keys(bd_out, PIPE_W, w_len),
        sizes, card)
    err["bf_insert"] = max(err["bf_insert"], b_err)  # a table of 187,920 bits: direct
    err["bf_probe"] = max(err["bf_probe"], v_err)
    n = PIPE_ROWS * PIPE_N  # the step's shape, half of it inserted values
    pick = torch.randint(0, sq, (n,), generator=gen, device=dev)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    bd = torch.where(half, bd_all[pick], torch.randint(0, t, (n,), generator=gen, device=dev))
    bd = bd.reshape(PIPE_ROWS, PIPE_N)
    table = kbf.bits_device
    got = pipeline.bf_probe(bd, PIPE_W, w_len, table, salts, kbf.table_size)
    flat_keys = blinded_keys(bd.reshape(-1), PIPE_W, w_len)
    want = bloom.probe_plain(plain, *flat_keys, salts, sizes, True).reshape(bd.shape)
    torch.cuda.synchronize()
    v_err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    assert v_err == 0, "the pipeline's probe differs from the plain version"
    err["bf_probe"] = max(err["bf_probe"], v_err)

    def plain_probe():
        return bloom.probe_plain(plain, *blinded_keys(bd.reshape(-1), PIPE_W, w_len), salts,
                                 sizes, True)

    def call():
        return pipeline.bf_probe(bd, PIPE_W, w_len, table, salts, kbf.table_size)

    plain_ms = cuda_ms(plain_probe)
    row = probe_row(f"[bloom] config[3] r={PIPE_R}, pipeline.bf_probe of the step's {n} blind "
                    f"distances (one launch, the table staged in shared memory)", call, table,
                    flat_keys, salts, sizes, True, card, key_bytes=8)
    scratch = torch.zeros_like(table)
    all_keys = blinded_keys(bd_all, PIPE_W, w_len)
    k_ms = device_ms(lambda: bloom.insert(scratch, salts, sizes, True, keys=all_keys))
    log(f"[bloom] config[3]: plain probe {plain_ms:.4f} ms; the filter's insert of {sq} keys "
        f"{k_ms:.4f} ms [{card}]")
    rows["bf_probe"] = {"max_abs_err": 0, "ms": statistics.median(row["device_ms"]),
                        "ms_source": "profiler", "plain_ms": plain_ms,
                        **{k: row[k] for k in ("bound_ms", "bound_by", "sector_ms")},
                        "launch_floor_ms": statistics.median(row["launch_floor_ms"])}
    del kbf, plain

    # 3. A compressible filter, compressed twice between thirds of its keys
    # (a size chain of three): the kernels against the plain version, which
    # folds its unpacked table on the card.
    count, cuts = BLOOM_COMPRESSED
    rng = np.random.default_rng(15)
    words = rng.integers(0, 1 << 32, size=(2, count + BLOOM_KEYS), dtype=np.uint64)
    lo, hi = (torch.from_numpy(w.astype(np.int64)).to(dev) for w in words)
    kbf = params(count, 1e-4, "mixed", bloom.CompressibleBloomFilter)
    salts = kbf._salts_device()
    plain = torch.zeros(kbf.table_size, dtype=torch.uint8, device=dev)
    thirds = np.linspace(0, count, len(cuts) + 2).astype(int)
    for j, (a, b) in enumerate(zip(thirds[:-1], thirds[1:])):
        kbf.insert_u64_batch(lo[a:b], hi[a:b])
        bloom.insert_plain(plain, lo[a:b], hi[a:b], salts, kbf._sizes(), True)
        if j < len(cuts):
            assert kbf.compress(cuts[j])
            new = kbf.table_size
            folded = torch.zeros(new, dtype=torch.uint8, device=dev)
            folded.index_put_((torch.arange(plain.numel(), device=dev) % new,), plain,
                              accumulate=True)
            plain = (folded > 0).to(torch.uint8)
    tag = f"compressible, sizes {kbf.size_list}"
    b_err, v_err = _bloom_check(tag, kbf, plain, (lo[:BLOOM_KEYS], hi[:BLOOM_KEYS]),
                                         (lo[count:], hi[count:]), kbf._sizes(), card)
    err["bf_insert"] = max(err["bf_insert"], b_err)  # every size of the chain: direct
    err["bf_probe"] = max(err["bf_probe"], v_err)
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    log(f"[bloom] phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows


def phase_slice(dev):
    """The demo on each profile, and at the reference's r = 8192 on seal;
    returns the NTT launches and the m62 kernels' launches of these runs."""
    import torch

    from pplp_tpu_torch.ops import bloom_cuda, modmath_cuda, ntt_cuda
    from pplp_tpu_torch.primitives import Blinding
    from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo

    launches = {k: 0 for k in ntt_cuda.launches_by_kernel}
    m62_launches = {k: 0 for k in modmath_cuda.launches_by_kernel}
    cases = [(p, c) for p in ("seal", "tpu") for c in DEMO_CASES]
    cases += [("seal", c) for c in DEMO_R8192_CASES]
    for profile, (radius, xa, ya, xb, yb) in cases:
        cfg = ProtocolConfig(
            xa=xa, ya=ya, xb=xb, yb=yb, radius=radius,
            plain_modulus_bits=DEMO_T_BITS,
            poly_modulus_degree_bits=DEMO_N_BITS, profile=profile, seed=7,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ntt_cuda.reset_launches()
        bloom_cuda.reset_launches()
        modmath_cuda.reset_launches()
        res = run_local_demo(cfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        run_launches = dict(ntt_cuda.launches_by_kernel)
        bf_launches = dict(bloom_cuda.launches_by_kernel)
        m62_run = dict(modmath_cuda.launches_by_kernel)
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
        want = _bloom_launches([(cfg.sq_radius, cfg.false_positive_probability)])
        assert bf_launches == want, f"{tag}: Bloom kernel launches {bf_launches}, planned {want}"
        assert res.bf_device.type == "cuda", "Bloom filter is not on the card"
        if profile == "seal":
            assert all(m62_run[k] > 0 for k in M62_DEMO_KERNELS), (
                f"{tag}: m62 kernel launches {m62_run}")
        else:
            assert not any(m62_run.values()), f"{tag}: m62 kernels on the m31 chain {m62_run}"
        for k, v in run_launches.items():
            launches[k] += v
        for k, v in m62_run.items():
            m62_launches[k] += v
        _bloom_counted(bf_launches)
        stages = ", ".join(f"{k} {v / 1e6:.3f} ms" for k, v in res.stage_ns.items())
        log(f"[slice] {tag} d^2={d2}: {res.verdict} (oracle "
            f"{'near' if near else 'far'}), blind distance {res.blind_distance:#x}, "
            f"launches {run_launches}, {bf_launches}, "
            f"{ {k: v for k, v in m62_run.items() if v} }")
        log(f"[slice] {tag} stages: {stages}; total {res.elapsed_s:.3f} s")
        log(f"[slice] {tag} BF {res.bf_table_bits} bits held as "
            f"{4 * ((res.bf_table_bits + 31) // 32)} bytes of words on {res.bf_device}, "
            f"{res.bf_wire_bytes} wire bytes; peak device memory {peak} bytes "
            f"[{torch.cuda.get_device_name(dev)}]")
    return launches, m62_launches


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


SURFACE_CHAINS = (("seal", 8192, 64), ("tpu", 4096, 256))  # (profile, n, batch)
SURFACE_ROWS = 2  # batch rows held against a CPU copy of the same call
SURFACE_STEPS = ("+1", "-1", "columns")
CKKS_NET = (8192, 256)  # n and the values summed over 127.0.0.1
CKKS_MUL = (8192, 4, 26, 64)  # n, 28-bit primes, log2 of the scale, batch


def _cpu_keys(keys, cpu_ctx):
    """A CPU copy of special-prime or RNS-gadget keys, on ``cpu_ctx``'s chain."""
    from pplp_tpu_torch.bfv import behz, keyswitch

    leaves = [t.cpu() for t in (keys.k0, keys.k0_shoup, keys.k1, keys.k1_shoup)]
    if isinstance(keys, keyswitch.SPKeys):
        return keyswitch.SPKeys(keyswitch.build_ctx_qp(cpu_ctx)[0], keys.P, *leaves)
    return behz.KSwitchKeys(*leaves, groups=keys.groups)


def _head_rows(ct, device="cpu"):
    """The first SURFACE_ROWS batch rows of a ciphertext, on ``device``."""
    from pplp_tpu_torch import bfv

    return bfv.Ciphertext(tuple(p[:SURFACE_ROWS].to(device) for p in ct.polys), ct.domain)


def _launch_counts():
    from pplp_tpu_torch.ops import behz64_cuda, behz_cuda, ntt_cuda

    return {**ntt_cuda.launches_by_kernel, **behz_cuda.launches_by_kernel,
            **behz64_cuda.launches_by_kernel}


def _reset_launches():
    import torch

    from pplp_tpu_torch.ops import behz64_cuda, behz_cuda, ntt_cuda

    torch.cuda.synchronize()
    for mod in (ntt_cuda, behz_cuda, behz64_cuda):
        mod.reset_launches()


def _surface_bfv(dev, profile, n, batch):
    """Rotations (SP and gadget Galois keys, steps +1, -1 and the column
    swap) and a product relinearized with SP keys and width-1 and width-2
    gadget keys, on batch-encoded slots; each card result against a CPU
    copy; the decrypted rows against the slots. Returns the launches."""
    import numpy as np
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import behz, galois, keyswitch, serialize
    from pplp_tpu_torch.measure_multiply import profile_phases
    from pplp_tpu_torch.ops import ntt, ntt_cuda
    from pplp_tpu_torch.ops.primes import get_primes

    card = torch.cuda.get_device_name(dev)
    t = get_primes(20, 1, n)[0]  # a batching prime
    parms = bfv.EncryptionParameters.bfv(n, t, profile=profile)
    ctx, cpu_ctx = bfv.BFVContext.build(parms, dev), bfv.BFVContext.build(parms, "cpu")
    rng = np.random.default_rng(n)
    rows_a, rows_b = (rng.integers(0, t, size=(batch, n)) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    steps = {"+1": 1, "-1": -1, "columns": None}

    # The counted run, through the entry points a user calls.
    _reset_launches()
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    be = bfv.BatchEncoder(ctx)
    enc = bfv.Encryptor(ctx, pk)
    ca, cb = (enc.encrypt_pairs(c, np.zeros_like(c), gen)
              for c in (be.encode_rows(rows_a), be.encode_rows(rows_b)))
    elts = {s: (2 * n - 1 if k is None else galois.galois_elt_from_step(k, n))
            for s, k in steps.items()}
    gkeys = {("sp", s): keyswitch.create_sp_galois_keys(ctx, kg, g, gen) for s, g in elts.items()}
    gkeys.update({("gadget", s): galois.create_galois_keys(ctx, sk, g, gen)
                  for s, g in elts.items()})
    spk = keyswitch.create_sp_relin_keys(ctx, kg, gen)
    rlk = {w: behz.create_relin_keys(ctx, sk, gen, width=w) for w in (1, 2)}

    def rotate(kind, step):
        if step == "columns":
            return galois.rotate_columns(ctx, ca, gkeys[kind, step])
        return galois.rotate_rows(ctx, ca, steps[step], gkeys[kind, step])

    rot = {(kind, s): rotate(kind, s) for kind in ("sp", "gadget") for s in SURFACE_STEPS}
    ev = bfv.Evaluator(ctx)
    prod3 = ev.multiply(ca, cb)
    prods = {"sp": ev.relinearize(prod3, spk), "w1": ev.relinearize(prod3, rlk[1]),
             "w2": ev.relinearize(prod3, rlk[2])}
    dec = bfv.Decryptor(ctx, sk)
    slots = {k: [be.decode(dec.decrypt(bfv.Ciphertext(tuple(p[b] for p in ct.polys))))
                 for b in range(SURFACE_ROWS)] for k, ct in (*rot.items(), *prods.items())}
    torch.cuda.synchronize()
    launches = _launch_counts()
    ntt_names = ("ntt_forward_u64", "ntt_inverse_u64") if profile == "seal" else (
        "ntt_forward", "ntt_inverse")
    relin_name = "behz64_keyprod" if profile == "seal" else "behz_relin_ntt"
    assert all(launches[k] > 0 for k in (*ntt_names, relin_name)), launches
    tag = f"{profile} n={n} L={ctx.L} P={spk.P.bit_length()}-bit t={t} batch {batch}"
    log(f"[seal_surface] {tag}: launches {dict((k, v) for k, v in launches.items() if v)}")

    # Decrypted rows: rotated slots, slot-wise products.
    half = n // 2
    move = {"+1": lambda r: np.concatenate([r[1:half], r[:1], r[half + 1:], r[half:half + 1]]),
            "-1": lambda r: np.concatenate([r[half - 1:half], r[:half - 1], r[n - 1:],
                                            r[half:n - 1]]),
            "columns": lambda r: np.concatenate([r[half:], r[:half]])}
    for (kind, s), got in ((k, v) for k, v in slots.items() if k in rot):
        want = [move[s](rows_a[b]).tolist() for b in range(SURFACE_ROWS)]
        assert got == want, f"{tag}: rotation {s} with {kind} keys does not move the slots"
    for k in prods:
        want = [(rows_a[b] * rows_b[b] % t).tolist() for b in range(SURFACE_ROWS)]
        assert slots[k] == want, f"{tag}: the {k} product does not decrypt to the slots' product"

    # The same calls on a CPU copy of the context, keys and inputs.
    cpu_ca, cpu_cb = _head_rows(ca), _head_rows(cb)
    cpu_keys = {k: _cpu_keys(v, cpu_ctx) for k, v in gkeys.items()}
    errs = {}
    for (kind, s), got in rot.items():
        g = elts[s]
        want = galois.apply_galois(cpu_ctx, cpu_ca, g, cpu_keys[kind, s])
        errs[f"rotate {s} {kind}"] = _max_err(_head_rows(got), want)
    cpu_ev = bfv.Evaluator(cpu_ctx)
    cpu3 = cpu_ev.multiply(cpu_ca, cpu_cb)
    errs["multiply"] = _max_err(_head_rows(prod3), cpu3)
    for k, keys in (("sp", spk), ("w1", rlk[1]), ("w2", rlk[2])):
        errs[f"relinearize {k}"] = _max_err(_head_rows(prods[k]),
                                            cpu_ev.relinearize(cpu3, _cpu_keys(keys, cpu_ctx)))
    assert all(e == 0 for e in errs.values()), f"{tag}: card differs from the CPU: {errs}"
    log(f"[seal_surface] {tag}: {len(errs)} calls bit-exact against the CPU copy on "
        f"{SURFACE_ROWS} rows; rotations decode to the rotated slots, products to the "
        f"slot-wise products")

    # The special-prime key bytes, card against CPU, and loaded back on the card.
    blob = serialize.save_sp_keys(spk, ctx)
    assert blob == serialize.save_sp_keys(_cpu_keys(spk, cpu_ctx), cpu_ctx), "SP key bytes"
    back = serialize.load_sp_keys(blob, ctx)
    assert all(torch.equal(a, b) for a, b in zip(
        (back.k0, back.k0_shoup, back.k1, back.k1_shoup),
        (spk.k0, spk.k0_shoup, spk.k1, spk.k1_shoup))), "SP keys do not load back"
    log(f"[seal_surface] {tag}: save_sp_keys {len(blob)} bytes, card == CPU, loads back")

    # The profile's NTT on the QP tables against the plain transforms.
    tqp = spk.ctx_qp.tables
    x = _random_residues(tqp, (batch,), torch.Generator(device=dev).manual_seed(3))
    spec = ntt_cuda.forward(x, tqp)
    err = max(int((spec - ntt.forward_plain(x, tqp)).abs().max()),
              int((ntt_cuda.inverse(spec, tqp) - ntt.inverse_plain(spec, tqp)).abs().max()))
    assert err == 0, f"{tag}: the NTT differs from plain on the QP tables"
    log(f"[seal_surface] {tag}: NTT on the QP tables {tuple(x.shape)} bit-exact against "
        f"forward_plain/inverse_plain")

    # Times (CUDA events) and the device-time split of one sp_relinearize.
    times = {"sp_relinearize": cuda_ms(lambda: keyswitch.sp_relinearize(ctx, prod3, spk), 10),
             "relinearize w1": cuda_ms(lambda: ev.relinearize(prod3, rlk[1]), 10),
             "relinearize w2": cuda_ms(lambda: ev.relinearize(prod3, rlk[2]), 10)}
    for kind in ("sp", "gadget"):
        for s in SURFACE_STEPS:
            times[f"rotate {s} {kind}"] = cuda_ms(lambda kind=kind, s=s: rotate(kind, s), 10)
    log(f"[seal_surface] {tag}: ms per batch call (CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f" [{card}]")
    prof = profile_phases(lambda: keyswitch.sp_relinearize(ctx, prod3, spk), 3)
    ntt_ms = sum(v["ms_per_call"] for k, v in prof["phases"].items() if k.startswith("ntt_"))
    busy = prof["busy_ms"] / 3
    top = sorted(((v["ms_per_call"], k) for k, v in prof["phases"].items()
                  if not k.startswith("ntt_")), reverse=True)[:3]
    log(f"[seal_surface] {tag}: sp_relinearize device time {busy:.4f} ms per call: NTT "
        f"kernels {ntt_ms:.4f} ms ({100 * ntt_ms / busy:.1f}%), elementwise torch "
        f"{busy - ntt_ms:.4f} ms; busy share {100 * prof['busy_share']:.1f}%; largest "
        f"others: " + "; ".join(f"{k[:60]} {ms:.4f} ms" for ms, k in top) + f" [{card}]")
    return launches


def _surface_ckks(dev):
    """The aggregation demo, the networked pair over 127.0.0.1 and a
    batched multiply + rescale with SP keys; returns the launches."""
    import threading

    import numpy as np
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv import keyswitch
    from pplp_tpu_torch.ckks import ckks, netmain
    from pplp_tpu_torch.ckks.demo import run_aggregation_demo
    from pplp_tpu_torch.ops.primes import get_primes
    from pplp_tpu_torch.protocol.transport import connect_to_client

    card = torch.cuda.get_device_name(dev)
    n_mul, primes, scale_bits, batch = CKKS_MUL
    chain = get_primes(28, primes, n_mul)
    ctx = ckks.CKKSContext.build(n=n_mul, scale=float(1 << scale_bits), coeff_modulus=chain,
                                 device=dev)
    cpu_ctx = ckks.CKKSContext.build(n=n_mul, scale=float(1 << scale_bits),
                                     coeff_modulus=chain, device="cpu")
    rng = np.random.default_rng(26)
    a, b = (rng.uniform(-8, 8, size=(batch, 4)) for _ in range(2))
    n_net, count = CKKS_NET
    values = rng.uniform(0, 100, size=count).tolist()

    _reset_launches()
    t0 = time.perf_counter()
    demo = run_aggregation_demo(verbose=False, device=dev)
    demo_s = time.perf_counter() - t0
    assert demo.abs_error < 1e-2, f"aggregation demo off by {demo.abs_error}"
    port, err = _free_port(), []

    def serve():
        try:
            netmain.run_aggregation_server(connect_to_client("127.0.0.1", port), count,
                                           device=dev)
        except BaseException as e:  # re-raised below, in the main thread
            err.append(e)

    th = threading.Thread(target=serve, daemon=True)
    t0 = time.perf_counter()
    th.start()
    total = netmain.run_aggregation_keyholder(_connect(port), values, n=n_net, device=dev)
    th.join(timeout=300)
    net_s = time.perf_counter() - t0
    assert not th.is_alive() and not err, f"the aggregation server failed: {err}"
    assert abs(total - sum(values)) < 1e-2, f"networked sum {total} != {sum(values)}"

    enc = ckks.CKKSEncoder(ctx)
    gen = torch.Generator(device=dev).manual_seed(64)
    kg = bfv.KeyGenerator(ctx.base, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    spk = keyswitch.create_sp_relin_keys(ctx.base, kg, gen)
    ca, cb = (ckks.ckks_encrypt(ctx, pk, enc.coeffs_to_rns(np.stack([enc.encode(r) for r in v])),
                                gen) for v in (a, b))
    prod = ckks.ckks_multiply(ctx, ca, cb, rlk=spk)
    ctx2, prod2 = ckks.ckks_rescale(ctx, prod)
    coeffs = ckks.ckks_decrypt(ctx2, ckks.restrict_secret_key(ctx2, sk), _head_rows(prod2, dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    assert launches["ntt_forward"] > 0 and launches["ntt_inverse"] > 0, launches
    got = np.stack([np.real(ckks.CKKSEncoder(ctx2).decode(c.astype(np.float64))[:4])
                    for c in coeffs])
    mul_err = float(np.max(np.abs(got - a[:SURFACE_ROWS] * b[:SURFACE_ROWS])))
    assert mul_err < 1e-2, f"CKKS product off by {mul_err}"

    cpu_prod = ckks.ckks_multiply(cpu_ctx, _head_rows(ca), _head_rows(cb),
                                  rlk=_cpu_keys(spk, cpu_ctx.base))
    _, cpu_prod2 = ckks.ckks_rescale(cpu_ctx, cpu_prod)
    errs = {"ckks_multiply sp": _max_err(_head_rows(prod), cpu_prod),
            "ckks_rescale": _max_err(_head_rows(prod2), cpu_prod2)}
    assert all(e == 0 for e in errs.values()), f"CKKS card differs from the CPU: {errs}"
    mul_ms = cuda_ms(lambda: ckks.ckks_multiply(ctx, ca, cb, rlk=spk), 10)
    log(f"[seal_surface] ckks: aggregation demo (n=2048, 4 values) off by {demo.abs_error:.2e} "
        f"in {demo_s:.3f} s wall; networked pair over 127.0.0.1 (n={n_net}, {count} values) off "
        f"by {abs(total - sum(values)):.2e} in {net_s:.3f} s wall; multiply + SP relinearize "
        f"+ rescale (n={n_mul}, {primes} primes, scale 2^{scale_bits}, batch {batch}) "
        f"bit-exact against the CPU on {SURFACE_ROWS} rows, decoded product off by "
        f"{mul_err:.2e}, ckks_multiply {mul_ms:.4f} ms per batch call (CUDA events) [{card}]")
    return launches


def phase_seal_surface(dev):
    """Special-prime key switching, Galois rotations, the batch encoder and
    CKKS on the card; returns the launches of all their counted runs."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    total = {}
    for profile, n, batch in SURFACE_CHAINS:
        for k, v in _surface_bfv(dev, profile, n, batch).items():
            total[k] = total.get(k, 0) + v
    for k, v in _surface_ckks(dev).items():
        total[k] = total.get(k, 0) + v
    log(f"[seal_surface] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB; phase done in {time.perf_counter() - t0:.1f} s")
    return total


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
    from pplp_tpu_torch.ops import bloom_cuda, ntt_cuda, pipeline_cuda
    from pplp_tpu_torch.parallel import pipeline

    card = torch.cuda.get_device_name(dev)
    t = 1 << PIPE_T_BITS
    w_len = PIPE_W.bit_length()
    ctx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(PIPE_N, t, profile="tpu"), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kg = bfv.KeyGenerator(ctx, gen)
    sk, pk = kg.secret_key(), kg.create_public_key()
    torch.cuda.synchronize()
    bloom_cuda.reset_launches()  # the server's filter, then the counted step
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

    # The counted run, on the fused route: the six polynomials in two
    # forward launches (c0 and c1 of the three messages lie back to back),
    # one combine, one inverse, one decode.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ntt_cuda.reset_launches()
    pipeline_cuda.reset_launches()
    got = fn(*cts, bits, salts, bf.table_size)
    torch.cuda.synchronize()
    launches = dict(ntt_cuda.launches_by_kernel)
    fused = {k: v for k, v in {**launches, **pipeline_cuda.launches_by_kernel}.items() if v}
    bf_launches = dict(bloom_cuda.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated(dev)
    assert fused == {"ntt_forward_u32": 2, "ntt_inverse_u32": 1, "pipe_combine": 1,
                     "pipe_decode": 1}, f"fused route launches {fused}"
    want = _bloom_launches([(PIPE_R * PIPE_R, 1e-4)], probes=1)
    assert bf_launches == want, f"Bloom launches {bf_launches}, planned {want}"
    _bloom_counted(bf_launches)

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

    # Every decoded blind distance of the fused route against the plain
    # torch chain's (the verdicts alone would hide a decode fault in a far
    # check), and the verdicts of both.
    packed = pipeline.build_packed_pipeline(ctx, sk, PIPE_XB, PIPE_YB, PIPE_S, PIPE_R)
    bd_fused, bd_plain = packed(*cts), packed.plain(*cts)
    bd_differ = int((bd_fused != bd_plain).sum())
    assert bd_differ == 0, f"{bd_differ} of {total} blind distances differ from the plain chain"
    assert torch.equal(got, fn.plain(*cts, bits, salts, bf.table_size))
    hom = pipeline.build_batched_pipeline(ctx, sk, PIPE_XB, PIPE_YB, PIPE_S, PIPE_R,
                                          packed=True)
    decode = get_decoder(ctx).decode_mod_t
    x = hom(*cts)
    assert torch.equal(x, hom.plain(*cts)), "the fused x differs from the plain chain's"
    bd = decode(x)
    assert torch.equal(bd, bd_plain)
    assert torch.equal(bd.reshape(-1), torch.as_tensor(bd_clear, device=dev))
    for r in (0, PIPE_ROWS - 1):
        assert ctx.decode_plain_from_ct_value(x[r].cpu().numpy()) == bd[r].tolist(), (
            f"device decode differs from the host CRT decode on row {r}")
    n_near = int(flat.sum())
    log(f"[pipeline] all {total} checks equal the host oracle ({n_near} near, "
        f"{int(truly_near.sum())} truly near, no false negatives); all {total} fused "
        f"blind distances == the plain chain's; device decode == host CRT decode on rows 0 "
        f"and {PIPE_ROWS - 1}; launches {fused}, {bf_launches}")

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
    # The inputs and the host oracle's verdicts, for the sharded step.
    return launches, {"ctx": ctx, "sk": sk, "cts": cts, "want": want}


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
    from pplp_tpu_torch.ops import bloom_cuda, ntt_cuda
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
                bloom_cuda.reset_launches()
                client, server, ca, cb, seconds = _network_pair(
                    dev, ProtocolConfig(xa=xa, ya=ya, **kw), ProtocolConfig(xb=xb, yb=yb, **kw))
                torch.cuda.synchronize()
                run_launches = dict(ntt_cuda.launches_by_kernel)
                bf_launches = dict(bloom_cuda.launches_by_kernel)
                count()
                _bloom_counted(bf_launches)
                want = _bloom_launches([(radius * radius, 1e-4)])
                assert bf_launches == want, f"{tag}: Bloom launches {bf_launches}, planned {want}"
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
                    f"{run_launches}, {bf_launches}; peak device memory {peak} B [{card}]")
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



def _dgk_sweep(dev, tmp):
    """``dgk_sweep_main`` over ``DGK_SWEEP_RADII`` with its defaults (keys of
    ``DGK_KEYS`` from seed 0, made anew per radius; the reference's
    coordinates: d^2 = 78,408) into ``tmp``. The mod-u oracle: the filter holds s(r + di) for di < r^2,
    so the verdict is near iff (d^2 mod u) < r^2; a far case read near is a
    Bloom false positive (fpp 1e-4), reported; a near case read far fails."""
    import contextlib
    import csv
    import io

    from pplp_tpu_torch.dgk import dgk_gen_keys
    from pplp_tpu_torch.dgk.protocol import DGK_CSV_COLUMNS, dgk_sweep_main

    path = os.path.join(tmp, "dgk_measure.csv")
    out = io.StringIO()
    t0 = time.perf_counter()
    k, t, l = DGK_KEYS
    with contextlib.redirect_stdout(out):
        assert dgk_sweep_main(path, radii=DGK_SWEEP_RADII, seed=0, device=dev, k=k, t=t,
                              l=l) == 0
    seconds = time.perf_counter() - t0
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == DGK_CSV_COLUMNS, f"dgk_measure.csv header {rows[0]}"
    radii = DGK_SWEEP_RADII
    assert [int(r[0]) for r in rows[1:]] == radii, "dgk_measure.csv radii"
    cols = DGK_CSV_COLUMNS
    for r in rows[1:]:
        v = dict(zip(cols, map(float, r)))
        assert v["d_BsetBF"] > 0 and v["d_BhomoCalc"] > 0 and v["d_AkGen"] > 0, r
        assert abs(v["d_Atotal"] - v["d_A1"] - v["d_A2"] - v["d_A3"]) < 1e-6 * v["d_Atotal"], r
    verdicts = dict(re.findall(r"dgk radius=(\d+) (near|far)", out.getvalue()))
    assert sorted(map(int, verdicts)) == radii, out.getvalue()
    u = dgk_gen_keys(*DGK_KEYS, seed=0, init_table=False)[1].u
    d2 = (123123 - 123321) ** 2 + (123456 - 123654) ** 2
    false_pos = []
    for r in radii:
        want = (d2 % u) < r * r
        got = verdicts[str(r)] == "near"
        assert got or not want, f"dgk sweep r={r}: far, the mod-u oracle says near"
        if got and not want:
            false_pos.append(r)
    for r in rows:
        log("[dgk] dgk_measure.csv: " + ",".join(r))
    log(f"[dgk] sweep r = {radii[0]}..{radii[-1]} in {seconds:.1f} s: "
        + ", ".join(f"r={r} {verdicts[str(r)]}" for r in radii)
        + f"; mod-u oracle (d^2 mod u = {d2 % u}, u = {u}): near from r = "
        f"{min(r for r in radii if (d2 % u) < r * r)}; Bloom false positives: "
        f"{false_pos or 'none'}")


def _dgk_pairs(mc, dev, rng, count, exps3, shared, lane_bits, const):
    """Each DGK kernel and its plain version on ``count`` numbers below n
    (0, 1, 2, n - 1, n - 2 among them): {kernel: [(kernel's, plain's)]}."""
    from pplp_tpu_torch.dgk.modexp import to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    n = mc.n_int

    def numbers():
        vals = [0, 1, 2, n - 1, n - 2] + [rng.randrange(n) for _ in range(count - 5)]
        rng.shuffle(vals)
        return vals, to_digits(vals, mc.D, dev)

    (a, A), (b, Bd) = numbers(), numbers()
    cs = [numbers()[1] for _ in range(5)]
    short = [0, 1] + [rng.getrandbits(lane_bits) for _ in range(count - 2)]
    return a, b, A, {
        "dgk_mulmod": [(dgk_cuda.mulmod(mc, A, Bd), mc.mulmod(A, Bd)),
                       (dgk_cuda.mulmod(mc, A, Bd[3:4]), mc.mulmod(A, Bd[3:4])),
                       (dgk_cuda.mulmod_const(mc, A, const),
                        dgk_cuda.mulmod_const_plain(mc, A, const))],
        "dgk_powmod_lanes": [(dgk_cuda.powmod(mc, A[:1], short),
                              dgk_cuda.powmod_plain(mc, A[:1], short)),
                             (dgk_cuda.powmod(mc, A, short), dgk_cuda.powmod_plain(mc, A, short))],
        "dgk_powmod_shared": [(dgk_cuda.powmod_shared_exp(mc, A, e), mc.powmod_shared_exp(A, e))
                              for e in shared],
        "dgk_blind_distance": [
            (dgk_cuda.blind_distance(mc, *cs[:3], *ex, *cs[3:]),
             dgk_cuda.blind_distance_plain(mc, *cs[:3], *ex, *cs[3:])) for ex in exps3],
    }


def _max_errs(pairs) -> dict:
    return {name: max(int((x - y).abs().max()) for x, y in p) for name, p in pairs.items()}


def phase_dgk(dev):
    """The DGK back-end (BASELINE config[2]) on the card; returns the rows
    of its four kernels."""
    import random
    import tempfile

    import torch

    from pplp_tpu_torch.dgk import dgk_encrypt, dgk_gen_keys
    from pplp_tpu_torch.dgk.batched import DGKBatch
    from pplp_tpu_torch.dgk.modexp import MontgomeryCtx, from_digits, to_digits
    from pplp_tpu_torch.ops import dgk_cuda

    import pplp_tpu_torch.measure_dgk as md

    assert (DGK_KEYS, DGK_SEED, DGK_XB, DGK_YB, DGK_S) == (
        md.DGK_KEYS, md.DGK_SEED, md.DGK_XB, md.DGK_YB, md.DGK_S), "measure_dgk's inputs differ"
    t_phase = time.perf_counter()

    def say(*args):  # each line with the phase's elapsed seconds
        print(f"[dgk] {time.perf_counter() - t_phase:7.1f} s", *args, flush=True)

    card = torch.cuda.get_device_name(dev)
    k, t, l = DGK_KEYS
    t0 = time.perf_counter()
    priv, pub = dgk_gen_keys(k, t, l, seed=DGK_SEED)
    keygen_s = time.perf_counter() - t0
    db = DGKBatch.build(pub, device=dev)
    mc, n, u = db.mc, pub.n, pub.u
    W = dgk_cuda.limbs(mc)
    t0 = time.perf_counter()
    dtab = db.build_device_table(priv)
    btab = db.build_bsgs_table(priv)
    table_s = time.perf_counter() - t0
    say(f"keys (k, t, l) = {DGK_KEYS}, seed {DGK_SEED}: n of {n.bit_length()} bits "
        f"(D = {mc.D} digits, W = {W} limbs), u = {u}; keygen + table {keygen_s:.2f} s, "
        f"device tables {table_s:.2f} s ({dtab.size} slots, {dtab.probes} probes; BSGS "
        f"{btab.size} slots)")

    # 1. Each kernel against its plain version, bit for bit, at a small batch
    # with the edge cases (not counted): at k = 2048, then at random odd
    # moduli of the other widths.
    rng = random.Random(2048)
    cb = DGK_CHECK_B + 3  # not a multiple of the 64-thread block
    m_steps = math.isqrt(u) + 1
    giant = pow(pow(priv.g, priv.vpq, n), -m_steps, n)  # the BSGS giant step's G^-m
    exps3 = ((DGK_XB, DGK_YB, DGK_S), (0, 1, 0))
    a, b, A, pairs = _dgk_pairs(mc, dev, rng, cb, exps3, (0, 1, DGK_S, priv.vpq), l, giant)
    torch.cuda.synchronize()
    err = _max_errs(pairs)
    assert all(e == 0 for e in err.values()), f"a DGK kernel differs from plain: {err}"
    assert from_digits(pairs["dgk_mulmod"][0][0]) == [x * y % n for x, y in zip(a, b)]
    assert from_digits(pairs["dgk_mulmod"][2][0]) == [x * giant % n for x in a]
    say(f"kernels against their plain versions at {cb} lanes (0, 1, 2, n - 1, n - 2 "
        f"among them; products per lane, by one row and by the giant step's G^-m in its "
        f"one-product form; per-lane exponents 0, 1 and {l}-bit ones; shared exponents 0, "
        f"1, {DGK_S} and vpq; blind distance at ({DGK_XB}, {DGK_YB}, {DGK_S}) and "
        f"(0, 1, 0)): bit-exact {err}")
    for bits in DGK_OTHER_BITS:
        n_w = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        mc_w = MontgomeryCtx.build(n_w, device=dev)
        c_w = rng.randrange(n_w)
        a_w, _, A_w, pairs_w = _dgk_pairs(mc_w, dev, rng, cb, exps3, (0, 1, DGK_S,
                                                                      (1 << 64) - 1), l, c_w)
        torch.cuda.synchronize()
        err_w = _max_errs(pairs_w)
        assert all(e == 0 for e in err_w.values()), f"{bits}-bit modulus: {err_w}"
        assert from_digits(pairs_w["dgk_powmod_shared"][2][0]) == [pow(x, DGK_S, n_w)
                                                                   for x in a_w]
        say(f"a random odd {bits}-bit modulus (W = {dgk_cuda.limbs(mc_w)}, run at "
            f"{dgk_cuda.width(mc_w)}, geometry (G, L, window) "
            f"{dgk_cuda.group(dgk_cuda.width(mc_w))}): every kernel bit-exact against its "
            f"plain version at {cb} lanes {err_w}")

    # 2. BASELINE config[2] at full width: real protocol ciphertexts from
    # random coordinates, randomness of 2.5 t bits (the inputs measure_dgk
    # times).
    B, rbits = DGK_B, int(2.5 * t)
    inp = md.comparison_inputs(pub, t, l, B)
    msgs, rands, want = inp["msgs"], inp["rands"], inp["want"]

    def comparisons():
        cts = [db.encrypt_batch(m, r) for m, r in zip(msgs, rands)]
        out = db.blind_distance_batch(*cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:])
        return cts, out, db.decrypt_batch_device(priv, dtab, out)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dgk_cuda.reset_launches()
    cts, out, dec = comparisons()
    bsgs = db.decrypt_batch_device_bsgs(priv, btab, out[:DGK_BSGS_B])
    torch.cuda.synchronize()
    launches = dict(dgk_cuda.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(v > 0 for v in launches.values()), f"DGK kernel launches {launches}"
    assert dec.tolist() == want, "a blind distance decrypts to another value than s(d^2 + r)"
    assert bsgs.tolist() == want[:DGK_BSGS_B], "BSGS decrypt differs"
    for c, m, r in zip(cts, msgs, rands):
        assert db.decrypt_batch_device(priv, dtab, c).tolist() == m, "decrypt(encrypt(m)) != m"
        got = from_digits(c[:DGK_POW_LANES])
        assert got == [dgk_encrypt(pub, mm, rr)
                       for mm, rr in zip(m[:DGK_POW_LANES], r[:DGK_POW_LANES])]
    got = from_digits(out[:DGK_POW_LANES])
    c_int = [from_digits(c[:DGK_POW_LANES]) for c in cts]
    assert got == [pow(c1 * pow(c2, DGK_XB, n) * pow(c3, DGK_YB, n) % n, DGK_S, n) * cz * cr % n
                   for c1, c2, c3, cz, cr in zip(*c_int)], "blind distance differs from pow"
    say(f"B = {B}: 5 x encrypt_batch ({rbits}-bit randomness), blind_distance_batch "
        f"({DGK_XB}, {DGK_YB}, s = {DGK_S}), decrypt_batch_device: every lane = s(d^2 + r) mod u; "
        f"decrypt(encrypt(m)) = m on every lane of the five batches; {DGK_POW_LANES} lanes of "
        f"each ciphertext and of the blind distance equal Python's pow; BSGS decrypt at "
        f"{DGK_BSGS_B} lanes agrees; launches {launches}; peak device memory {peak} B")

    # 3. Times: calls (CUDA events, median of windows) and kernels (profiler).
    g, h = to_digits([pub.g], mc.D, dev), to_digits([pub.h], mc.D, dev)
    gm, hr = dgk_cuda.powmod(mc, g, msgs[0]), dgk_cuda.powmod(mc, h, rands[0])
    calls = {
        "encrypt_batch": _median_ms(lambda: db.encrypt_batch(msgs[0], rands[0]), 3, 1),
        "blind_distance_batch": _median_ms(lambda: db.blind_distance_batch(
            *cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:]), 5, 3),
        "decrypt_batch_device": _median_ms(lambda: db.decrypt_batch_device(priv, dtab, out), 3, 1),
        f"decrypt_batch_device_bsgs (B = {DGK_BSGS_B})": _median_ms(
            lambda: db.decrypt_batch_device_bsgs(priv, btab, out[:DGK_BSGS_B]), 3, 1),
        "full (5 encrypt + eval + decrypt)": _median_ms(comparisons, 3, 1),
    }
    kernel_fns = {
        "dgk_mulmod": (lambda: dgk_cuda.mulmod(mc, gm, hr), lambda: mc.mulmod(gm, hr)),
        "dgk_powmod_lanes": (lambda: dgk_cuda.powmod(mc, h, rands[0]),
                             lambda: dgk_cuda.powmod_plain(mc, h, rands[0])),
        "dgk_powmod_shared": (lambda: dgk_cuda.powmod_shared_exp(mc, out, priv.vpq),
                              lambda: mc.powmod_shared_exp(out, priv.vpq)),
        "dgk_blind_distance": (
            lambda: dgk_cuda.blind_distance(mc, *cts[:3], DGK_XB, DGK_YB, DGK_S, *cts[3:]),
            lambda: dgk_cuda.blind_distance_plain(mc, *cts[:3], DGK_XB, DGK_YB, DGK_S,
                                                  *cts[3:])),
    }
    bounds = md.kernel_bounds(W, mc.D, B, priv.vpq)
    bounds["dgk_powmod_lanes"] = md.lanes_bound(W, rands[0])
    rows = {}
    for name, (fn, plain) in kernel_fns.items():
        prof = _profile_with(fn, [name], calls=2)
        source = "profiler"
        if name in prof:
            ms = prof[name]["ms_per_call"] / prof[name]["launches_per_call"]
        else:  # the profiler missed it: the wrapper call by CUDA events
            ms, source = cuda_ms(fn, iters=2, warmup=1), "events"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = fn()  # the kernel on the main path's inputs, held against the plain result
        full_err = int((got - want).abs().max())
        assert torch.equal(got, want), f"{name} differs from plain at B = {B}: {full_err}"
        c = bounds[name]
        rows[name] = {"launches": launches[name], "max_abs_err": full_err,
                      "max_abs_err_edge_cases": err[name], "ms": ms,
                      "ms_source": source, "plain_ms": plain_ms,
                      "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                      "reference_bound_ms": c["reference_bound_ms"]}
        say(f"{name} at B = {B}: bit-exact against plain on these inputs (max abs err "
            f"{full_err}); {ms:.4f} ms per launch ({source}), "
            f"{c['products']} Montgomery products needed ({c['products'] / B:.1f} a lane), "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}), {100 * c['bound_ms'] / ms:.1f}% "
            f"of bound ({100 * c['reference_bound_ms'] / ms:.1f}% of the older count's "
            f"{c['reference_products'] / B:.1f} a lane); plain {plain_ms:.1f} ms (one call) "
            f"[{card}]")
    # The BSGS giant step's one-product form on the BSGS lanes' own inputs,
    # and the BSGS call's split.
    zb = out[:DGK_BSGS_B]

    def giant_step():
        return dgk_cuda.mulmod_const(mc, zb, giant)

    prof = _profile_with(giant_step, ["dgk_mulmod"], calls=5)
    if "dgk_mulmod" in prof:
        giant_ms = prof["dgk_mulmod"]["ms_per_call"] / prof["dgk_mulmod"]["launches_per_call"]
        giant_source = "profiler"
    else:  # the profiler missed it: the wrapper call by CUDA events
        giant_ms, giant_source = cuda_ms(giant_step, iters=5, warmup=1), "events"
    giant_bound = md.kernel_bounds(W, mc.D, DGK_BSGS_B, priv.vpq)["giant step"]
    got = dgk_cuda.mulmod_const(mc, zb, giant)
    want = dgk_cuda.mulmod_const_plain(mc, zb, giant)
    assert torch.equal(got, want), "the giant step differs from plain"
    rows["dgk_mulmod"].update({
        "giant_step_ms": giant_ms, "giant_step_bound_ms": giant_bound["bound_ms"],
        "giant_step_max_abs_err": int((got - want).abs().max())})
    say(f"dgk_mulmod, the BSGS giant step at B = {DGK_BSGS_B} (one product a lane by G^-m R' "
        f"mod n): bit-exact against plain; {giant_ms:.4f} ms per launch ({giant_source}), bound "
        f"{giant_bound['bound_ms']:.4f} ms ({giant_bound['bound_by']}), "
        f"{100 * giant_bound['bound_ms'] / giant_ms:.1f}% of bound [{card}]")
    say(f"decrypt_batch_device_bsgs at B = {DGK_BSGS_B}: "
        f"{md.bsgs_text(md.bsgs_split(db, priv, btab, zb))} [{card}]")
    for name, ms in calls.items():
        say(f"{name}: {ms:.4f} ms per call (CUDA events, median) [{card}]")
    eval_rate = B / (calls["blind_distance_batch"] / 1e3)
    full_rate = B / (calls["full (5 encrypt + eval + decrypt)"] / 1e3)
    eval_bound, eval_ref = (B / (bounds["dgk_blind_distance"][key] / 1e3)
                            for key in ("bound_ms", "reference_bound_ms"))
    say(f"comparisons/s at B = {B}, k = {k}: eval-only {eval_rate:.1f} (as bench.py "
        f"counts them; bound {eval_bound:.1f}, {eval_ref:.1f} by the older count), full "
        f"{full_rate:.1f} (encrypt c1..c3, cz, cr + "
        f"eval + device decrypt) [{card}]")

    # 4. The sweep, with its Bloom filter on the card.
    from pplp_tpu_torch.ops import bloom_cuda

    torch.cuda.synchronize()
    bloom_cuda.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        _dgk_sweep(dev, tmp)
    bf_launches = dict(bloom_cuda.launches_by_kernel)
    want = _bloom_launches([(r * r, 1e-4) for r in DGK_SWEEP_RADII])
    assert bf_launches == want, f"Bloom launches {bf_launches}, planned {want}"
    _bloom_counted(bf_launches)
    log(f"[dgk] the sweep's Bloom launches {bf_launches}")
    log(f"[dgk] phase done in {time.perf_counter() - t_phase:.1f} s")
    return rows


TWOPC_B = (1 << 20, 1 << 24)  # in-process batch sizes
TWOPC_THR = 5000  # the circle's radius; coordinates are 15-bit (circ_y/pplp.cpp:40-41)
TWOPC_SQUARE = ([1000, -1000, -1000, 1000], [1000, 1000, -1000, -1000])  # poly_y/pplp.cpp:26-27
TWOPC_CHECK_B = 4096  # lanes held card against CPU from injected words
TWOPC_NET_B = 256  # instances of each networked call


def _np_words(seed, device):
    """A ``secure2pc`` words source: numpy words from one seed on ``device``;
    two sources of one seed hand out the same words."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return lambda shape: torch.from_numpy(rng.integers(0, 1 << 32, tuple(shape))).to(device)


def _twopc_inputs(B, seed):
    """Circle pairs (15-bit) and polygon points in [-2000, 2000), host int64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    circle = [rng.integers(0, 1 << 15, B) for _ in range(4)]
    return circle, (rng.integers(-2000, 2000, B), rng.integers(-2000, 2000, B))


def _twopc_in_process(dev, say):
    """The batched predicates on the card at B = 2^20 and 2^24."""
    import numpy as np
    import torch

    from pplp_tpu_torch.measure_multiply import profile_phases
    from pplp_tpu_torch.secure2pc import circuits, sharing

    a, b = TWOPC_SQUARE
    thr_sq = TWOPC_THR * TWOPC_THR
    for B in TWOPC_B:
        (x0, y0, x1, y1), (xp, yp) = _twopc_inputs(B, B.bit_length())
        t0 = time.perf_counter()
        oracles = {"circle": circuits.circle_predicate_clear(x0, y0, x1, y1, thr_sq),
                   "polygon": circuits.polygon_predicate_clear(a, b, xp, yp)}
        say(f"B = {B}: host oracles in {time.perf_counter() - t0:.2f} s; CLOSE "
            f"{int(oracles['circle'].sum())} circle, {int(oracles['polygon'].sum())} polygon")
        on_card = [torch.from_numpy(v).to(dev) for v in (x0, y0, x1, y1, xp, yp)]
        gen = torch.Generator(device=dev).manual_seed(B)
        calls = {
            "circle": lambda bug: circuits.circle_predicate_2pc(*on_card[:4], thr_sq, gen=gen,
                                                                yao_bug=bug, device=dev),
            "polygon": lambda bug: circuits.polygon_predicate_2pc(a, b, *on_card[4:], gen=gen,
                                                                  yao_bug=bug, device=dev),
        }
        for name, call in calls.items():
            for bug in (False, True):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                got = call(bug).cpu().numpy()
                peak = torch.cuda.max_memory_allocated(dev) - base
                assert got.shape == (B,) and got.dtype == bool, (name, bug, got.shape)
                if not bug:
                    assert np.array_equal(got, oracles[name]), f"{name} B = {B}: not the oracle"
                elif B == TWOPC_B[0]:  # no oracle for the bug: the same call on the CPU
                    cpu_gen = torch.Generator().manual_seed(B)
                    want = (circuits.circle_predicate_2pc(x0, y0, x1, y1, thr_sq, gen=cpu_gen,
                                                          yao_bug=True, device="cpu")
                            if name == "circle" else
                            circuits.polygon_predicate_2pc(a, b, xp, yp, gen=cpu_gen,
                                                           yao_bug=True, device="cpu"))
                    assert np.array_equal(got, want.numpy()), f"{name} bug B = {B}: not the CPU's"
                    assert not np.array_equal(got, oracles[name]), f"{name} bug reads the oracle"
                windows, iters = (7, 5) if B == TWOPC_B[0] else (5, 2)
                ms = _median_ms(lambda: call(bug), windows, iters)
                prof = profile_phases(lambda: call(bug), 2)
                kernels = sum(p["launches_per_call"] for p in prof["phases"].values())
                say(f"{name} yao_bug={bug} B = {B}: {ms:.4f} ms a call (CUDA events, median of "
                    f"{windows} windows of {iters}) = {B / ms * 1e3:,.1f} instances/s; "
                    f"{kernels:.0f} kernels a call, device busy {prof['busy_ms'] / 2:.4f} ms "
                    f"a call, {100 * prof['busy_share']:.1f}% of the window; peak "
                    f"{peak:,} B above the inputs")
        del on_card
    # Card against CPU from one numpy seed's words: verdicts and Beaver shares.
    (x0, y0, x1, y1), (xp, yp) = _twopc_inputs(TWOPC_CHECK_B, 7)
    for bug in (False, True):
        got = [circuits.circle_predicate_2pc(x0, y0, x1, y1, thr_sq, words=_np_words(1, d),
                                             yao_bug=bug, device=d).cpu() for d in (dev, "cpu")]
        pgot = [circuits.polygon_predicate_2pc(a, b, xp, yp, words=_np_words(2, d),
                                               yao_bug=bug, device=d).cpu() for d in (dev, "cpu")]
        assert torch.equal(*got) and torch.equal(*pgot), f"yao_bug={bug}: card != CPU"
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 32, TWOPC_CHECK_B))
    x[:5] = torch.tensor([0, 1, (1 << 16) + 1, 1 << 31, (1 << 32) - 1])
    shares = []
    for d in (dev, "cpu"):
        words = _np_words(3, d)
        sx, sy = sharing.share(x.to(d), words), sharing.share(x.flip(0).to(d), words)
        prod = sharing.BeaverDealer(words).mul(sx, sy)
        shares.append([v.cpu() for v in (sx.s0, sx.s1, prod.s0, prod.s1)])
    assert all(torch.equal(g, w) for g, w in zip(*shares)), "Beaver shares: card != CPU"
    assert sharing.reconstruct(sharing.ArithShare(*shares[0][2:])).tolist() == [
        u * v % (1 << 32) for u, v in zip(x.tolist(), x.flip(0).tolist())]
    say(f"{TWOPC_CHECK_B} lanes from injected words: circle and polygon verdicts (both "
        f"yao_bug) and the shares of a Beaver product equal the CPU's bit for bit")


@contextlib.contextmanager
def _twopc_stage_clock(seconds):
    """Add each networked party's seconds in triple generation (``ot``) and
    in the garbled comparison (``yao``) to ``seconds[stage, role]``."""
    from pplp_tpu_torch.secure2pc import networked, yao

    def timed(fn, stage, role_of):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                key = (stage, role_of(args))
                seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
        return run

    saved = [(networked.PartyArith, "setup", networked.PartyArith.__dict__["setup"])]
    networked.PartyArith.setup = staticmethod(
        timed(networked.PartyArith.setup, "ot", lambda args: args[1]))
    for name, role in (("yao_lt_garbler", 1), ("yao_lt_evaluator", 0),
                       ("yao_any_negative_garbler", 1), ("yao_any_negative_evaluator", 0)):
        saved.append((yao, name, getattr(yao, name)))
        setattr(yao, name, timed(getattr(yao, name), "yao", lambda args, r=role: r))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _twopc_networked(dev, say):
    """Both parties in process over TCP on 127.0.0.1, each on the card."""
    import threading

    import numpy as np

    from pplp_tpu_torch.protocol.transport import connect_to_client
    from pplp_tpu_torch.secure2pc import circuits, networked, ot

    t0 = time.perf_counter()
    group = ot.SchnorrGroup.generate(pbits=2048, qbits=160, seed=1)  # the CLI's
    say(f"the CLI's group (2048-bit p, 160-bit q, seed 1) in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(256)
    x0, y0 = rng.integers(-2000, 2000, TWOPC_NET_B), rng.integers(-2000, 2000, TWOPC_NET_B)
    x1, y1 = (v + rng.integers(-900, 900, TWOPC_NET_B) for v in (x0, y0))
    xp, yp = rng.integers(-2000, 2000, TWOPC_NET_B), rng.integers(-2000, 2000, TWOPC_NET_B)
    edges = circuits.polygon_edge_coeffs(*TWOPC_SQUARE)
    oracles = {"circle": circuits.circle_predicate_clear(x0, y0, x1, y1, 700 ** 2),
               "polygon": circuits.polygon_predicate_clear(*TWOPC_SQUARE, xp, yp)}

    def party(circuit, role, ch, compare):
        kw = dict(seed=None, compare=compare, device=dev)
        if circuit == "circle":
            mine = (x0, y0) if role == 0 else (x1, y1)
            return networked.circle_predicate_2pc_networked(ch, role, *mine, 700 ** 2, group,
                                                            **kw)
        arg = {"point": (xp, yp)} if role == 0 else {"edges": edges}
        return networked.polygon_predicate_2pc_networked(ch, role, group=group, **arg, **kw)

    for circuit in ("circle", "polygon"):
        for compare in ("open", "yao"):
            port, out, err, seconds = _free_port(), {}, [], {}

            def serve():
                try:
                    chan = connect_to_client("127.0.0.1", port)
                    try:
                        out["server"] = (party(circuit, 1, chan, compare), chan)
                    finally:
                        chan.close()
                except BaseException as e:  # re-raised below, in the main thread
                    err.append(e)

            with _twopc_stage_clock(seconds):
                th = threading.Thread(target=serve, daemon=True)
                t0 = time.perf_counter()
                th.start()
                chan = _connect(port)
                try:
                    client = party(circuit, 0, chan, compare)
                finally:
                    chan.close()
                    th.join(timeout=600)
                wall = time.perf_counter() - t0
            assert not th.is_alive(), "the server party did not finish"
            if err:
                raise err[0]
            server, schan = out["server"]
            for side, got in (("client", client), ("server", server)):
                assert isinstance(got, np.ndarray) and np.array_equal(got, oracles[circuit]), (
                    f"{circuit} {compare}: the {side}'s verdicts are not the oracle's")
            assert chan.bytes_sent == schan.bytes_received and schan.bytes_sent == chan.bytes_received
            split = ", ".join(
                f"{side} OT triples {seconds[('ot', r)]:.3f} s, gates "
                f"{wall - seconds[('ot', r)] - seconds.get(('yao', r), 0.0):.3f} s, Yao "
                f"{seconds.get(('yao', r), 0.0):.3f} s"
                for side, r in (("client", 0), ("server", 1)))
            say(f"{circuit} compare={compare} B = {TWOPC_NET_B}: {wall:.3f} s wall (host clock); "
                f"{split}; client sent {chan.bytes_sent:,} B, server sent "
                f"{schan.bytes_sent:,} B; CLOSE {int(client.sum())} of {TWOPC_NET_B}, "
                f"the oracle's on both sides")


def _listening(port: int) -> bool:
    """Whether a socket listens on ``port`` (read from /proc, no connection)."""
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            local, state = row.split()[1], row.split()[3]
            if state == "0A" and int(local.rsplit(":", 1)[1], 16) == port:
                return True
    return False


def _twopc_cli(say, tmp):
    """``cli 2pc -r 0`` and ``-r 1`` as processes at the CLI's defaults
    (circle, yao, --otp-bits 2048, --device cuda), all pairs at once."""
    square = ["--ax", ",".join(map(str, TWOPC_SQUARE[0])), "--ay", ",".join(map(str, TWOPC_SQUARE[1]))]
    cases = [  # name, server args, client args, the oracle's verdict
        ("close", ["-x", "1000", "-y", "1000", "--radius", "300"],
         ["-x", "1100", "-y", "1150", "--radius", "300"], "CLOSE"),  # README.md:374-375
        ("far", ["-x", "1000", "-y", "1000", "--radius", "100"],
         ["-x", "1100", "-y", "1150", "--radius", "100"], "FAR"),
        ("poly_in", ["--circuit", "poly", *square], ["--circuit", "poly", "-x", "10", "-y", "-20"],
         "CLOSE"),
        ("poly_out", ["--circuit", "poly", *square], ["--circuit", "poly", "-x", "1500", "-y", "0"],
         "FAR"),
    ]
    t0 = time.perf_counter()
    servers, clients = [], []
    try:
        for name, server_args, _, _ in cases:  # every server first, then each client
            port = _free_port()
            path = os.path.join(tmp, f"{name}_r0.log")
            servers.append((port, path, _cli(["2pc", "-r", "0", "-p", str(port), *server_args],
                                             path)))
        deadline = time.monotonic() + 120
        for (name, _, client_args, _), (port, path, server) in zip(cases, servers):
            while not _listening(port):
                assert server.poll() is None, f"{name} server exited: {open(path).read()}"
                assert time.monotonic() < deadline, f"{name}: the server never listened"
                time.sleep(0.1)
            cpath = os.path.join(tmp, f"{name}_r1.log")
            clients.append((cpath, _cli(["2pc", "-r", "1", "-p", str(port), *client_args],
                                        cpath)))
        done = [(path, proc.wait(timeout=600)) for _, path, proc in servers]
        done += [(path, proc.wait(timeout=600)) for path, proc in clients]
    finally:
        for proc in [s[2] for s in servers] + [c[1] for c in clients]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for (name, *_, want), pair in zip(cases * 2, done):
        path, rc = pair
        text = open(path).read()
        assert rc == 0, f"{name} {path}: exit {rc}\n{text}"
        assert text.strip().splitlines()[-1] == f"Circuit Result: {want}", f"{name}: {text}"
    say(f"cli 2pc: {len(cases)} pairs of processes at the defaults, all at once, in "
        f"{time.perf_counter() - t0:.1f} s (host clock): " +
        ", ".join(f"{name} {want}" for name, *_, want in cases) + " on both sides")


def phase_twopc(dev):
    """The 2PC predicates (``secure2pc``) and ``cli 2pc`` on the card."""
    import tempfile

    t_phase = time.perf_counter()

    def say(*args):
        print(f"[twopc] {time.perf_counter() - t_phase:7.1f} s", *args, flush=True)

    _twopc_in_process(dev, say)
    _twopc_networked(dev, say)
    with tempfile.TemporaryDirectory() as tmp:
        _twopc_cli(say, tmp)
    log(f"[twopc] phase done in {time.perf_counter() - t_phase:.1f} s")

# The multidevice phase: ranks share the one card over gloo.
MD_SEP = (32768, 2, 2)  # n, batch, gadget width: BASELINE.md:31's n, the separate phase's shape
MD_BENCH = (4096, 256, (1, 2))  # n, batch, widths (bench.py:103), dp 2 x coeff 2
MD_NTT_ROWS = 2  # rows of the distributed NTT at n = 32768, 31 limbs, coeff 4
MD_ITERS = 5  # timed calls a rank (median)
MD_TIMEOUT_S = 300  # a launch's limit; every rank is killed past it
MD_KERNELS = ("ntt_forward_u32", "ntt_inverse_u32", "behz_to_bsk", "behz_tensor",
              "behz_floor_sk", "behz_lift", "behz_keyprod", "behz_add")
MD_NTT = ("ntt_forward", "ntt_inverse")  # the distributed NTT's and the pipeline's
MD_BLOOM = ("bf_probe",)  # the sharded pipeline's probe (its filter is built outside the count)


def _md_assemble(outs, shape):
    """The whole [2, B, L, n] product from the ranks' blocks."""
    import torch

    got = torch.full(shape, -1, dtype=torch.int64)
    for out in outs:
        got[:, slice(*out["batch"]), :, slice(*out["coeffs"])] = out["out"]
    return got


def phase_multidevice(dev, pipe):
    """The sharded paths in gloo ranks on the one card: DistMultiplier at
    n = 32768 on 2 and 4 ranks and at the bench shape on dp 2 x coeff 2, the
    distributed NTT, the sharded packed pipeline; every rank's block against
    the single-process kernels (or the host oracle), the ranks' launches."""
    import torch

    from pplp_tpu_torch import bfv
    from pplp_tpu_torch.bfv.behz_fused import FusedMultiplier
    from pplp_tpu_torch.device import smi_line
    from pplp_tpu_torch.ops import ntt
    from pplp_tpu_torch.parallel import mesh as pmesh
    from pplp_tpu_torch.parallel.behz_dist import DistMultiplier
    from pplp_tpu_torch.parallel.multiproc_smoke import launch, median_s, seeded_case

    t_phase = time.perf_counter()
    label = f"ranks sharing one card over gloo, not scaling [{smi_line()}]"

    def tpu(n, t_bits):
        return bfv.BFVContext.build(bfv.EncryptionParameters.bfv(n, 1 << t_bits, profile="tpu"),
                                    dev)

    # The single-process results on the card, and the same code at S = 1.
    n, B, width = MD_SEP
    ctx = tpu(n, 16)
    rlk, ct1, ct2 = seeded_case(ctx, 1, B, width)
    want_sep = torch.stack(bfv.Evaluator(ctx).multiply_relinearize(ct1, ct2, rlk).polys).cpu()
    one = DistMultiplier(ctx, rlk, pmesh.make_mesh(1))
    assert torch.equal(torch.stack(one.multiply_relinearize(ct1, ct2).polys).cpu(), want_sep)
    s1_sep = 1e3 * median_s(dev, None, lambda: one.multiply_relinearize(ct1, ct2), MD_ITERS)
    del one, rlk, ct1, ct2
    nb, Bb, widths = MD_BENCH
    ctx_b = tpu(nb, 16)
    want_b, s1_b = {}, None
    for w in widths:
        rlk, c1, c2 = seeded_case(ctx_b, 2 + w, Bb, w)
        want_b[w] = torch.stack(FusedMultiplier(ctx_b, rlk).multiply_relinearize(c1, c2).polys
                                ).cpu()
        if w == widths[-1]:
            one = DistMultiplier(ctx_b, rlk, pmesh.make_mesh(1))
            s1_b = 1e3 * median_s(dev, None, lambda: one.multiply_relinearize(c1, c2), MD_ITERS)
        del rlk, c1, c2
    g = torch.Generator(device=dev).manual_seed(7)
    x, y = (torch.randint(0, 1 << 62, (MD_NTT_ROWS, ctx.L, n), generator=g, device=dev,
                          dtype=torch.int64) % ctx.q2 for _ in range(2))
    spec_ref = ntt.forward(x, ctx.tables).cpu()
    prod_ref = ntt.negacyclic_polymul(x, y, ctx.tables).cpu()
    log(f"[multidevice] single-process references on the card: separate route n={n} "
        f"L={ctx.L} batch {B} width {width}, S = 1 DistMultiplier bit-exact; fused n={nb} "
        f"batch {Bb} widths {widths}; NTT [{MD_NTT_ROWS}, {ctx.L}, {n}]")

    moduli = [m.value for m in ctx.moduli]
    sep = dict(kind="behz", n=n, t=1 << 16, moduli=moduli, seed=1, batch=B, width=width,
               time_iters=MD_ITERS)
    bench = [dict(kind="behz", mesh=(2, 1, 2), n=nb, t=1 << 16,
                  moduli=[m.value for m in ctx_b.moduli], seed=2 + w, batch=Bb, width=w,
                  batch_axis="dp", time_iters=MD_ITERS if w == widths[-1] else 0)
             for w in widths]
    pctx, psk = pipe["ctx"], pipe["sk"]
    jobs4 = [dict(sep, mesh=(1, 1, 4)), *bench,
             dict(kind="ntt", mesh=(1, 1, 4), n=n, moduli=moduli, x=x.cpu(), y=y.cpu(),
                  time_iters=MD_ITERS),
             dict(kind="pipeline", mesh=(2, 1, 2), n=pctx.n, t=pctx.t,
                  moduli=[m.value for m in pctx.moduli], s_ntt=psk.s_ntt.cpu(),
                  s_shoup=psk.s_shoup.cpu(), point=[PIPE_XB, PIPE_YB, PIPE_S, PIPE_R],
                  cts=[[p.cpu() for p in pair] for pair in pipe["cts"]], bf=True, w=PIPE_W)]
    t0 = time.perf_counter()
    res2 = launch({"device": "cuda", "jobs": [dict(sep, mesh=(1, 1, 2))]}, 2, MD_TIMEOUT_S)
    t2 = time.perf_counter() - t0
    res4 = launch({"device": "cuda", "jobs": jobs4}, 4, MD_TIMEOUT_S)
    t4 = time.perf_counter() - t0 - t2
    log(f"[multidevice] launches: 2 ranks {t2:.1f} s, 4 ranks {t4:.1f} s (start, contexts, "
        f"keys, jobs)")

    def runs(res, j):
        return [r["results"][j] for r in res]

    # (a) n = 32768 on coeff = 2 and coeff = 4, (b) the bench shape.
    for name, outs in (("coeff=2", runs(res2, 0)), ("coeff=4", runs(res4, 0))):
        got = _md_assemble(outs, want_sep.shape)
        assert torch.equal(got, want_sep), f"DistMultiplier n={n} {name} differs"
    for j, w in enumerate(widths, start=1):
        got = _md_assemble(runs(res4, j), want_b[w].shape)
        assert torch.equal(got, want_b[w]), f"DistMultiplier n={nb} width {w} differs"
    log(f"[multidevice] DistMultiplier n={n} (L={ctx.L}, batch {B}, width {width}) on "
        f"coeff = 2 and coeff = 4, and n={nb} batch {Bb} widths {widths} on dp 2 x coeff 2: "
        f"bit-exact against the single-process kernels")
    # (c) the distributed NTT.
    for out in runs(res4, 1 + len(widths)):
        b, limbs, cs = (slice(*out[k]) for k in ("batch", "limbs", "coeffs"))
        assert torch.equal(out["spec"], spec_ref[b, limbs]), "distributed NTT rows differ"
        assert torch.equal(out["back"], x.cpu()[b, :, cs]), "round trip differs"
        assert torch.equal(out["prod"], prod_ref[b, :, cs]), "distributed product differs"
    log(f"[multidevice] distributed NTT [{MD_NTT_ROWS}, {ctx.L}, {n}] on coeff = 4: rows "
        f"equal the single-process transform, round trip and product bit-exact")
    # (d) BASELINE config[3] sharded.
    want = pipe["want"].reshape(PIPE_ROWS, PIPE_N)
    for out in runs(res4, 2 + len(widths)):
        assert (out["near"].numpy() == want).all(), "sharded verdicts differ from the oracle"
    log(f"[multidevice] sharded build_packed_pipeline_bf on dp 2 x coeff 2: all "
        f"{want.size} gathered verdicts equal the host oracle on every rank")

    counts = {}
    for res in (res2, res4):
        for r in res:
            for out in r["results"]:
                for k, v in out["launches"].items():
                    counts[k] = counts.get(k, 0) + v
    missing = [k for k in MD_KERNELS + MD_NTT + MD_BLOOM if not counts.get(k)]
    assert not missing, f"kernels the ranks never launched: {missing}"
    log(f"[multidevice] the ranks' launches: {counts}")

    # (e) Times: CUDA events around a call (median of MD_ITERS), the ranks
    # of a group starting together; then as many calls with each exchange
    # timed where it happens (ntt_dist.exchanges, the card synchronized
    # around it), split into the exchanges and the rest of the same call.
    def report(what, outs, s1=None):
        def each(key):
            vals = [o[key] for o in outs]
            return f"{', '.join(f'{v:.4f}' for v in vals)} ms (max {max(vals):.4f})"

        log(f"[multidevice] {what}: a call {each('ms')} per rank; with its exchanges timed "
            f"{each('timed_ms')}, of it the exchanges {each('exchange_ms')} and the rest "
            f"(kernels, packing) {each('rest_ms')}; bytes sent a rank a call "
            f"{[o['call_bytes'] for o in outs]}"
            + ("" if s1 is None else f"; S = 1 in one process {s1:.4f} ms") + f" ({label})")

    report(f"DistMultiplier n={n} batch {B} coeff = 2", runs(res2, 0), s1_sep)
    report(f"DistMultiplier n={n} batch {B} coeff = 4", runs(res4, 0), s1_sep)
    report(f"DistMultiplier n={nb} batch {Bb} width {widths[-1]} dp 2 x coeff 2",
           runs(res4, len(widths)), s1_b)
    report(f"distributed NTT forward + inverse [{MD_NTT_ROWS}, {ctx.L}, {n}] coeff = 4",
           runs(res4, 1 + len(widths)))
    log(f"[multidevice] phase done in {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    import torch

    from pplp_tpu_torch.device import smi_line

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    t_main = time.perf_counter()

    def done(phase):
        log(f"[main] {phase} done at {time.perf_counter() - t_main:.1f} s")

    dev = phase_device()
    phase_build()
    done("build")
    # The demo's transform shapes: one polynomial (decrypt), three
    # (encrypt, plaintext spectra) and six (the blind distance's stack).
    demo_shapes = [(), (3,), (6,)]
    err, times = phase_kernels(dev, demo_shapes)
    done("kernels")
    modmath_rows = phase_modmath(dev)
    done("modmath")
    bloom_rows = phase_bloom(dev)
    done("bloom")
    launches, m62_launches = phase_slice(dev)
    done("slice")
    rows, mult_ntt = phase_multiply(dev)
    done("multiply")
    rows["mulmod_chain"] = phase_probe(dev)
    pipe_ntt, pipe_case = phase_pipeline(dev)
    done("probe, pipeline")
    sep_rows, sep_ntt = phase_separate(dev)
    rows.update(sep_rows)
    done("separate")
    seal_rows, seal_ntt = phase_seal_multiply(dev)
    rows.update(seal_rows)
    done("seal_multiply")
    surface = phase_seal_surface(dev)
    for name, count in surface.items():
        if name in rows:  # the BEHZ rows; the NTT rows are summed below
            rows[name]["launches"] += count
    done("seal_surface")
    net_ntt = phase_network(dev)
    done("network")
    rows.update(phase_dgk(dev))
    done("dgk")
    phase_twopc(dev)
    done("twopc")
    md_counts = phase_multidevice(dev, pipe_case)
    for name in MD_KERNELS:
        if name in rows:  # the BEHZ rows; the NTT rows are summed below
            rows[name]["launches"] += md_counts[name]
    _bloom_counted({k: md_counts.get(k, 0) for k in BLOOM_MAIN})
    done("multidevice")
    assert all(BLOOM_MAIN.values()), f"Bloom kernels never launched on the main paths: {BLOOM_MAIN}"
    for name, row in bloom_rows.items():
        rows[name] = {"launches": BLOOM_MAIN[name], **row}
    for name, row in modmath_rows.items():
        rows[name] = {"launches": m62_launches[name], **row}
    n = 1 << DEMO_N_BITS
    main_shapes = {prof: (6, len(_chain(prof, n)), n) for prof in PROFILE_NTT}
    u32_shape = (ROWS_PER_LIMB, len(_chain("tpu", 32768)), 32768)
    for prof, names in (*PROFILE_NTT.items(), ("tpu", ("ntt_forward_u32", "ntt_inverse_u32"))):
        shape = u32_shape if names[0].endswith("u32") else main_shapes[prof]
        for name in names:
            ms, plain_ms = times[prof, shape][name]
            rows[name] = {"launches": sum(c[name] for c in (launches, mult_ntt, pipe_ntt,
                                                            sep_ntt, seal_ntt, surface,
                                                            net_ntt, md_counts)),
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
        f"{SEAL_MUL[0][3][0]}; mulmod_chain at {PROBE_SHAPE}; the dgk kernels per launch at "
        f"B = {DGK_B}, k = {DGK_KEYS[0]} (encrypt's g^m h^r product and h^r, the decrypt's "
        f"c^vpq, the blind distance), their plain_ms one call on the same inputs; the "
        f"partitioned insert kernels (bf_insert_count, _scatter, _apply) a launch at the "
        f"demo's setBF (r = {BLOOM_FILTERS[0][0]}, {BLOOM_FILTERS[0][1]}, fpp "
        f"{BLOOM_FILTERS[0][2]:g}: the mean of a chunk's launch over the insert, r^2 keys made "
        f"in the kernels), their plain_ms the plain step on the first chunk (index_put_ "
        f"counts, a stable argsort by bucket, index_fill_); the sub-slice insert kernels "
        f"(bf_insert_sub_count, _scatter, _apply) a launch at the client/server filter "
        f"(r = {BLOOM_FILTERS[-1][0]}, fpp {BLOOM_FILTERS[-1][2]:g}), their plain_ms the plain "
        f"step on the first chunk (bincount, a stable argsort by bucket, index_fill_ into a "
        f"table a quarter full); bf_insert, the direct kernel, forced on the same filter's "
        f"keys (one launch), its plain_ms blind_distance_keys + index_fill_; bf_probe at "
        f"config[3]'s "
        f"step ({PIPE_ROWS * PIPE_N} blind distances, the table staged in shared memory; "
        f"its launch_floor_ms an empty kernel's device time at the probe's geometry); "
        f"the m62 kernels a launch at the demo's shapes ({MODMATH_BATCH} x the seal chain "
        f"of n = {n}; the products by a key spectrum), their plain_ms the plain chain "
        f"(m62_plain) on the same card tensors, their bound the bytes each operand and the "
        f"result move once, their launches the slice phase's demos' (seal; the tpu demos "
        f"none); "
        f"library_ms null: no PyTorch "
        f"call computes these functions")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
