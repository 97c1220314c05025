"""The Bloom filter's device paths on the card: the demo's stages and the
kernels' bounds.

    python3 -m pplp_tpu_torch.measure_bloom [--radii 4096,8192] [--repeats 3] [--json PATH]
    python3 -m pplp_tpu_torch.measure_bloom --sweep [--json PATH]
    python3 -m pplp_tpu_torch.measure_bloom --inserts [--json PATH]
    python3 -m pplp_tpu_torch.measure_bloom --probe [--json PATH]
    python3 -m pplp_tpu_torch.measure_bloom --split [--json PATH]

Runs the local demo (``run_local_demo``: seal, -d 13 -b 56, the near pair
(1234, 1212) / (1000, 1000), seed 7, the CLI's defaults otherwise) once at
r = 128 to build the kernels, then ``repeats`` times at each radius, and
prints each run's stages (host clock, each ending in a synchronize;
``setBF`` builds the server's filter, ``dec`` serializes it, deserializes
it on the client and probes), its wall time, the verdict and its peak
device memory, with the card's name and power limit. It uses only ``run_local_demo`` and ``device``, so a copy of this
file runs unchanged in a tree from before the Bloom kernels: run parent,
change, change, parent in one call to compare them.

``--sweep`` instead times the direct insert kernel (``bloom_cuda.insert_direct``,
one thread a key, a RED a bit) against the table's size, at 40 and 13 salts:
bit sets/s into tables of 8 to 120 MB (and of 2^27, 2^28 and 2^29 bits),
each filled to its optimum (keys = bits ln 2 / salts, half the bits set);
then the sub-slice route (``insert_subslice``) beside the direct kernel on
tables of 32 KB to 44 MB at sub-slices of 2^19 and 2^20 bits, the
client/server table at stashes of 1, 2 and 4 times the table, and at a
sixty-fourth and a sixteenth of its keys (``SUB_SWEEP_*``); last, the
partitioned insert of the demo's tables at ``SWEEP_SLICES``. Every route's
words are held equal to the direct kernel's. ``bloom.cu``'s slice and
sub-slice sizes, stash cap and thresholds come from it.

``--inserts`` times the device insert of each filter of the main paths
(the demo's at r = 4096 and 8192, the client/server one, config[3]'s and a
compressible filter's chain of three sizes): the kernels it launched (its
route), the device time of all the call's kernels (torch.profiler), the
call's CUDA-event time and the device memory the call adds at its peak
beside the peak itself. It uses only the filters' own methods and
``bloom_cuda``'s launch counts, so a copy of this file runs in a parent
tree too.

``--split`` times the sub-slice route's kernels one by one (torch.profiler,
``insert_split``) on the client/server table (its optimal keys, blinded,
at 13 salts) at each sub-slice of ``SUB_SWEEP_LOG2`` and a stash of
``STASH_FACTOR`` times the table, beside the direct kernel's device time,
the words held equal; run on copies of the package with a constant of
``csrc/bloom.cu`` patched, it gives the design experiments' figures.

``--probe`` times the probe of each filter of the main paths: config[3]'s
(``pipeline.bf_probe`` of the step's 102,400 blind distances, half of them
inserted values) and the client/server filter (r = 4096, fpp 1e-4) and the
demo's at r = 4096 and 8192 (fpp 1e-12), each through
``BloomFilter.contains_u64_batch`` on 100,000 inserted and 100,000 outside
keys (``probe_row``): the device time (torch.profiler,
``measure_ntt.device_ms``) and the call's CUDA-event time, three rounds
each, beside ``probe_bound``, its sector model on the (key, salt) bits the
probe tests (``probe_reads``: a word read, one 32-byte sector, a tested
bit) and an empty kernel's device time at the probe's geometry, the launch
floor (where the tree has one). It uses only those two calls and
``bloom_cuda``'s optional ``probe_floor_cuda``, so a copy of this file runs
in a parent tree too.

``insert_bound`` and ``probe_bound`` are the bounds ``chip_smoke.py`` puts
beside the kernels' times: the larger of the bytes the function must move
(each input read once, each output written once) over ``BYTES_PER_S`` and
the 32-bit multiplies of its indices (one in the AP hash, two in fmix32,
two a reduction by a size) over ``MULS_PER_S``. ``sector_ms`` is the model
for a table larger than the 50 MB L2, where each bit set reads and writes
one random 32-byte sector and each probed bit reads one.
``partition_bounds`` bounds each kernel of the partitioned insert a launch
and ``subslice_bounds`` each of the sub-slice route's, and
``design_floor`` is the floor of an insert's own design: the bytes it
moves (the table in and out once; for a partitioned or sub-slice insert
once a chunk, and the stash written and read, 8 B an index) over
``BYTES_PER_S``, plus its hashing (``HASH_OPS`` integer operations an
index, once, or twice when the indices go through a stash) over
``MULS_PER_S``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

from .measure_multiply import BYTES_PER_S, MULS_PER_S

__all__ = ["insert_bound", "probe_bound", "partition_bounds", "subslice_bounds", "design_floor",
           "insert_split",
           "probe_misses", "probe_reads", "probe_row", "demo_runs", "sweep", "inserts", "split",
           "probes", "main"]

SECTOR = 32  # bytes
HASH_OPS = 25  # integer operations an index: AP round, fmix32, reduction (an estimate)
SWEEP_MB = (8, 16, 24, 32, 40, 44, 48, 64, 120)  # table sizes, 10^6 bytes
SWEEP_POW2 = (27, 28, 29)  # and tables of 2^k bits
SWEEP_SALTS = (40, 13)  # the demo's filter (fpp 1e-12), the client/server one (1e-4)
SWEEP_KEYS = (0x3FFFFFFB, 0x12345, 0xBEEF, 16)  # a blinded range's s, r, w, w_len
SWEEP_SLICES = (26, 27, 28)  # slices of 2^k bits tried on the demo's tables
# The sub-slice route beside the direct kernel: table sizes (10^6 bytes; 40.2
# is the client/server filter's 321,668,808 bits), sub-slices of 2^k bits,
# the stash caps tried on the client/server table, and the fractions of its
# optimal keys tried there.
SUB_SWEEP_MB = (0.032, 0.125, 0.25, 0.5, 1, 2, 4, 8, 16, 24, 32, 40.2, 44)
SUB_SWEEP_LOG2 = (19, 20)
SUB_SWEEP_STASH = (1, 2, 4)
SUB_SWEEP_SPARSE = (64, 16)
SUB_SWEEP_ROUNDS = 3
CS_BITS = 321_668_808  # the client/server filter: r = 4096, fpp 1e-4, 13 salts
INSERT_KERNELS = ("bf_insert", "bf_insert_sub_count", "bf_insert_sub_scatter",
                  "bf_insert_sub_apply", "bf_insert_count", "bf_insert_scatter",
                  "bf_insert_apply")


def _bound(nbytes: int, indices: int, mixed: bool, n_sizes: int, sector_bytes: int) -> dict:
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = indices * (1 + 2 * int(mixed) + 2 * n_sizes) / MULS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations", "sector_ms": sector_bytes / BYTES_PER_S * 1e3}


def insert_bound(keys: int, salts: int, table_bits: int, mixed: bool, n_sizes: int = 1,
                 key_bytes: int = 16) -> dict:
    """An insert of ``keys`` keys (``key_bytes`` read a key: 16 for int64
    (lo, hi) words, 0 for keys the kernel makes) into a table of
    ``table_bits`` bits, read and written once."""
    table = 4 * ((table_bits + 31) // 32)
    return _bound(2 * table + keys * key_bytes + 8 * salts, keys * salts, mixed, n_sizes,
                  2 * SECTOR * keys * salts)


def probe_bound(keys: int, tested: int, salts: int, table_bits: int, mixed: bool,
                n_sizes: int = 1, key_bytes: int = 16) -> dict:
    """A probe of ``keys`` keys that tests ``tested`` (key, salt) bits in all
    (it stops at a key's first clear bit): the keys and the salts read once,
    a bool written a key, and of the table what these keys need: the whole
    table, or one 32-byte sector a tested bit where that is less (a table
    far larger than the keys' sectors is not read whole)."""
    table = 4 * ((table_bits + 31) // 32)
    return _bound(keys * (key_bytes + 1) + min(table, SECTOR * tested) + 8 * salts, tested,
                  mixed, n_sizes, SECTOR * tested)


def probe_misses(words, klo, khi, salts, sizes, mixed: bool):
    """[S, K] bool: salt j's bit of key k is clear in the packed table
    ``words`` (int32 u32 words), from the plain version's indices."""
    import torch

    from .primitives import bloom

    idx = bloom._indices(klo, khi, salts, tuple(sizes), mixed)
    return ((words[idx >> 5].to(torch.int64) >> (idx & 31)) & 1) == 0


def probe_reads(miss) -> int:
    """Words a probe reads (one 32-byte sector each): the (key, salt) bits
    it tests, every salt of a present key and an absent key's salts up to
    its first clear bit. ``miss``: [S, K] bool (``probe_misses``)."""
    import torch

    n_salts = miss.shape[0]
    first = torch.where(miss.any(0), miss.to(torch.int8).argmax(0),
                        torch.full_like(miss[0], n_salts - 1, dtype=torch.int64))
    return int((first + 1).sum())


def partition_bounds(plan, mixed: bool, n_sizes: int = 1, key_bytes: int = 0) -> dict:
    """The bound of each partitioned kernel's launch on a mean chunk of
    ``plan`` (``plan.count / plan.chunks`` keys): count reads the keys and
    writes a histogram; scatter reads the keys and the histograms, writes
    the stash; apply reads the stash and the table and writes the table;
    count and scatter hash every index."""
    keys = plan.count / plan.chunks
    idx = keys * plan.n_salts
    hist = 4 * plan.buckets * -(-keys // plan.tile_keys)
    table = 4 * ((plan.table_size + 31) // 32)
    out = {"bf_insert_count": _bound(keys * key_bytes + hist, idx, mixed, n_sizes, 0),
           "bf_insert_scatter": _bound(keys * key_bytes + hist + 4 * idx, idx, mixed, n_sizes, 0),
           "bf_insert_apply": _bound(4 * idx + 2 * table, 0, mixed, n_sizes, 0)}
    for b in out.values():
        del b["sector_ms"]
    return out


def subslice_bounds(plan, mixed: bool, n_sizes: int = 1, key_bytes: int = 0) -> dict:
    """The bound of each sub-slice kernel's launch on a mean chunk of
    ``plan`` (``plan.count / plan.chunks`` keys): count reads the keys and
    writes the totals; scatter reads the keys and the totals, writes the
    stash and the offsets; apply reads the stash, the counts and the table
    and writes the table; count and scatter hash every index."""
    keys = plan.count / plan.chunks
    idx = keys * plan.n_salts
    counts = 4 * plan.buckets
    table = 4 * ((plan.table_size + 31) // 32)
    out = {"bf_insert_sub_count": _bound(keys * key_bytes + counts, idx, mixed, n_sizes, 0),
           "bf_insert_sub_scatter": _bound(keys * key_bytes + 2 * counts + 4 * idx, idx, mixed,
                                           n_sizes, 0),
           "bf_insert_sub_apply": _bound(4 * idx + 2 * counts + 2 * table, 0, mixed, n_sizes, 0)}
    for b in out.values():
        del b["sector_ms"]
    return out


def design_floor(plan) -> float:
    """Milliseconds of the insert's own floor (see the module's note)."""
    idx = plan.count * plan.n_salts
    table = 4 * ((plan.table_size + 31) // 32)
    staged = plan.route != "direct"
    passes = plan.chunks if staged else 1
    nbytes = 2 * table * passes + (8 * idx if staged else 0)
    hashes = 2 if staged else 1
    return (nbytes / BYTES_PER_S + hashes * HASH_OPS * idx / MULS_PER_S) * 1e3


def demo_runs(radius: int, repeats: int, dev) -> list[dict]:
    """The seal demo at ``radius``, ``repeats`` times: stages (ms), wall
    time, verdict and peak device memory of each run."""
    import torch

    from .protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(xa=1234, ya=1212, xb=1000, yb=1000, radius=radius,
                         plain_modulus_bits=56, poly_modulus_degree_bits=13, seed=7)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = run_local_demo(cfg, verbose=False, device=dev)
        runs.append({"radius": radius, "near": res.is_near,
                     "stages_ms": {k: v / 1e6 for k, v in res.stage_ns.items()},
                     "wall_s": res.elapsed_s,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)})
        del res
    return runs


def insert_split(fn, calls: int = 3) -> dict:
    """Device milliseconds a call of ``fn`` under torch.profiler, by insert
    kernel (``INSERT_KERNELS``), and ``total`` over every kernel of the
    call (the buffers' zero fill included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(INSERT_KERNELS, 0.0)
    out["total"] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / calls
        out["total"] += ms
        m = re.search(r"(bf_insert\w*)_kernel", e.name)
        if m and m.group(1) in out:
            out[m.group(1)] += ms
    return out


def sweep(dev, card: str) -> list[dict]:
    """The direct insert kernel's bit sets/s against the table's size (CUDA
    events over back-to-back launches, after one warm-up launch)."""
    import math

    import torch

    from .device import window_ms
    from .ops import bloom_cuda
    from .primitives.bloom import _PREDEF_SALT

    sizes = [mb * 8_000_000 for mb in SWEEP_MB] + [1 << k for k in SWEEP_POW2]
    rows = []
    for n_salts in SWEEP_SALTS:
        salts = torch.tensor(_PREDEF_SALT[:n_salts], dtype=torch.int64, device=dev)
        for bits in sorted(sizes):
            words = torch.zeros(bloom_cuda.words_for(bits), dtype=torch.int32, device=dev)
            keys = round(bits * math.log(2) / n_salts)
            blinded = (*SWEEP_KEYS, 0, keys)

            def insert():
                bloom_cuda.insert_direct(words, salts, (bits,), True, blinded=blinded)

            insert()
            sets = keys * n_salts
            ms = window_ms(insert, max(5, min(100, 2_000_000_000 // sets)))
            row = {"table_bits": bits, "table_mb": bits / 8e6, "salts": n_salts, "keys": keys,
                   "ms": ms, "bit_sets_per_s": sets / ms * 1e3}
            rows.append(row)
            print(f"sweep direct: {row['table_mb']:.2f} MB ({bits} bits), {n_salts} salts, "
                  f"{keys} keys: {ms:.4f} ms, {row['bit_sets_per_s'] / 1e9:.2f}G bit sets/s "
                  f"[{card}]", flush=True)
            del words
    rows += _sweep_subslice(dev, card)
    rows += _sweep_slices(dev, card)
    return rows


def _sweep_subslice(dev, card: str) -> list[dict]:
    """The sub-slice route beside the direct kernel (CUDA events over
    back-to-back calls of the same blinded range, after one untimed call of
    each; ``SUB_SWEEP_ROUNDS`` rounds, the two in turn, medians), each
    table's words after it held equal to the direct kernel's: tables of
    ``SUB_SWEEP_MB`` at 13 and 40 salts and their optimal keys, at each
    sub-slice of ``SUB_SWEEP_LOG2`` that the table holds whole; then the
    client/server table (13 salts) at each stash cap of ``SUB_SWEEP_STASH``
    and at 1/k of its keys for k in ``SUB_SWEEP_SPARSE``."""
    import math
    import statistics

    import torch

    from .device import window_ms
    from .ops import bloom_cuda
    from .primitives.bloom import _PREDEF_SALT

    def timed(bits, n_salts, keys, **kw) -> tuple:
        salts = torch.tensor(_PREDEF_SALT[:n_salts], dtype=torch.int64, device=dev)
        blinded = (*SWEEP_KEYS, 0, keys)
        direct = torch.zeros(bloom_cuda.words_for(bits), dtype=torch.int32, device=dev)
        words = torch.zeros_like(direct)

        def run_direct():
            bloom_cuda.insert_direct(direct, salts, (bits,), True, blinded=blinded)

        def run_sub():
            bloom_cuda.insert_subslice(words, salts, (bits,), True, blinded=blinded, **kw)

        run_direct()
        run_sub()
        torch.cuda.synchronize()
        assert torch.equal(words, direct), f"{bits} bits, {kw}: differs from direct"
        reps = max(5, min(100, 500_000_000 // max(1, keys * n_salts)))
        d, s = [], []
        for _ in range(SUB_SWEEP_ROUNDS):
            d.append(window_ms(run_direct, reps))
            s.append(window_ms(run_sub, reps))
        return statistics.median(d), statistics.median(s)

    rows = []
    for n_salts in (13, 40):
        for mb in SUB_SWEEP_MB:
            bits = CS_BITS if mb == 40.2 else round(mb * 8e6)
            keys = round(bits * math.log(2) / n_salts)
            for log2 in SUB_SWEEP_LOG2:
                if bits < 1 << log2:
                    continue
                d_ms, s_ms = timed(bits, n_salts, keys, slice_log2=log2)
                rows.append({"table_bits": bits, "salts": n_salts, "keys": keys,
                             "slice_log2": log2, "stash_factor": bloom_cuda.STASH_FACTOR,
                             "direct_ms": d_ms, "subslice_ms": s_ms})
                print(f"sweep subslice: {bits / 8e6:.3f} MB ({bits} bits), {n_salts} salts, "
                      f"{keys} keys, sub-slice 2^{log2}: direct {d_ms:.4f} ms, sub-slice "
                      f"{s_ms:.4f} ms ({d_ms / s_ms:.2f}x; medians of {SUB_SWEEP_ROUNDS}), "
                      f"equal [{card}]", flush=True)
    keys = round(CS_BITS * math.log(2) / 13)
    cases = [(f"stash {f}x", keys, dict(stash_factor=f)) for f in SUB_SWEEP_STASH]
    cases += [(f"1/{k} of the keys", keys // k, {}) for k in SUB_SWEEP_SPARSE]
    for log2 in SUB_SWEEP_LOG2:
        for tag, n, kw in cases:
            d_ms, s_ms = timed(CS_BITS, 13, n, slice_log2=log2, **kw)
            plan = bloom_cuda.insert_plan(CS_BITS, 13, n, route="subslice", slice_log2=log2,
                                          **kw)
            rows.append({"table_bits": CS_BITS, "salts": 13, "keys": n, "slice_log2": log2,
                         "stash_factor": kw.get("stash_factor", bloom_cuda.STASH_FACTOR),
                         "chunks": plan.chunks, "direct_ms": d_ms, "subslice_ms": s_ms})
            print(f"sweep subslice: client/server table, {tag} ({n} keys, {plan.chunks} "
                  f"chunks), sub-slice 2^{log2}: direct {d_ms:.4f} ms, sub-slice {s_ms:.4f} ms "
                  f"({d_ms / s_ms:.2f}x), equal [{card}]", flush=True)
    return rows


def _sweep_slices(dev, card: str) -> list[dict]:
    """The partitioned insert of the demo's filters (fpp 1e-12, mixed, r^2
    keys made in the kernels) at each slice of ``SWEEP_SLICES``, its table
    held against the direct kernel's: the call's CUDA-event time and its
    kernels' device times."""
    import torch

    from .device import window_ms
    from .ops import bloom_cuda
    from .primitives.bloom import BloomFilter, BloomParameters

    rows = []
    for radius in (4096, 8192):
        p = BloomParameters(projected_element_count=radius * radius,
                            false_positive_probability=1e-12, random_seed=0xA5A5A5A5,
                            index_mode="mixed")
        assert p.compute_optimal_parameters()
        bf = BloomFilter(p, device=dev)
        salts, sizes = bf._salts_device(), bf._sizes()
        blinded = (*SWEEP_KEYS, 0, radius * radius)
        direct = torch.zeros_like(bf.bits_device)
        bloom_cuda.insert_direct(direct, salts, sizes, True, blinded=blinded)
        for log2 in SWEEP_SLICES:
            try:
                plan = bloom_cuda.insert_plan(bf.table_size, bf.salt_count, radius * radius,
                                              slice_log2=log2, route="partitioned")
            except ValueError as e:
                print(f"sweep partitioned r={radius}, slice 2^{log2}: {e}", flush=True)
                continue
            words = torch.zeros_like(direct)

            def insert():
                bloom_cuda.insert_partitioned(words, salts, sizes, True, blinded=blinded,
                                              slice_log2=log2)

            insert()
            torch.cuda.synchronize()
            assert torch.equal(words, direct), f"r={radius} slice 2^{log2}: differs from direct"
            ms = window_ms(insert, 3)
            split = insert_split(insert)
            sets = radius * radius * bf.salt_count
            rows.append({"radius": radius, "table_bits": bf.table_size, "slice_log2": log2,
                         "buckets": plan.buckets, "chunks": plan.chunks, "ms": ms,
                         "bit_sets_per_s": sets / ms * 1e3, "device_ms": split})
            print(f"sweep partitioned r={radius} ({bf.table_size} bits), slice 2^{log2}: "
                  f"{plan.buckets} buckets, {plan.chunks} chunks; equal to direct; {ms:.4f} ms "
                  f"(events), {sets / ms / 1e6:.2f}G bit sets/s; device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" ms [{card}]",
                  flush=True)
            del words
        del bf, direct
        torch.cuda.empty_cache()
    return rows


def inserts(dev, card: str) -> list[dict]:
    """Each main-path filter's device insert, timed as the module's note
    says (after one untimed insert; the bits are set again each time, the
    same work)."""
    import numpy as np
    import torch

    from .device import window_ms
    from .ops import bloom_cuda
    from .primitives import Blinding, BloomFilter, BloomParameters, CompressibleBloomFilter
    from .primitives.blinding import blinded_keys

    def make(count, fpp, cls=BloomFilter):
        p = BloomParameters(projected_element_count=count, false_positive_probability=fpp,
                            random_seed=0xA5A5A5A5, index_mode="mixed")
        assert p.compute_optimal_parameters()
        return cls(p, device=dev)

    def blinded_case(radius, fpp):
        bf, bl = make(radius * radius, fpp), Blinding.for_protocol(56, radius * radius, seed=7)
        return (f"r={radius} fpp {fpp:g} ({bf.table_size} bits, {bf.salt_count} salts; "
                f"{radius * radius} keys made in the kernels)",
                lambda: bf.insert_blind_distances(bl, radius * radius))

    def config3():
        t, s, r, w = 1 << 20, 501, 99, 0xA5A5  # config[3]: keys of blind distances, as words
        bf = make(r * r, 1e-4)
        keys = blinded_keys(s * (torch.arange(r * r, device=dev) + r) % t, w, w.bit_length())
        return (f"config[3] r={r} ({bf.table_size} bits, {bf.salt_count} salts; {r * r} keys)",
                lambda: bf.insert_u64_batch(*keys))

    def compressed():
        bf = make(200_000, 1e-4, CompressibleBloomFilter)
        assert bf.compress(30.0) and bf.compress(20.0)
        rng = np.random.default_rng(15)
        lo, hi = (torch.from_numpy(rng.integers(0, 1 << 32, 66_666, dtype=np.uint64)
                                   .astype(np.int64)).to(dev) for _ in range(2))
        return (f"compressible, sizes {bf.size_list} (66666 keys)",
                lambda: bf.insert_u64_batch(lo, hi))

    cases = [lambda: blinded_case(4096, 1e-4), lambda: blinded_case(4096, 1e-12),
             lambda: blinded_case(8192, 1e-12), config3, compressed]
    rows = []
    for make_case in cases:
        tag, fn = make_case()
        fn()
        torch.cuda.synchronize()
        bloom_cuda.reset_launches()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        route = {k: v for k, v in bloom_cuda.launches_by_kernel.items() if v}
        split = insert_split(fn, calls=5)
        ms = window_ms(fn, 5)
        rows.append({"filter": tag, "launches": route, "device_ms": split["total"],
                     "call_ms": ms, "peak_bytes": peak, "added_bytes": peak - base})
        print(f"inserts: {tag}: launches {route}; {split['total']:.4f} ms of kernels "
              f"(profiler), the call {ms:.4f} ms (CUDA events); peak device memory {peak} B, "
              f"{peak - base} B above the filter's [{card}]", flush=True)
        del fn
        torch.cuda.empty_cache()
    return rows


def split(dev, card: str) -> list[dict]:
    """The sub-slice route's device time by kernel on the client/server
    table beside the direct kernel's, as the module's note says."""
    import math

    import torch

    from .ops import bloom_cuda
    from .primitives.bloom import _PREDEF_SALT

    keys = round(CS_BITS * math.log(2) / 13)
    salts = torch.tensor(_PREDEF_SALT[:13], dtype=torch.int64, device=dev)
    blinded = (*SWEEP_KEYS, 0, keys)
    direct = torch.zeros(bloom_cuda.words_for(CS_BITS), dtype=torch.int32, device=dev)
    words = torch.zeros_like(direct)
    d = insert_split(lambda: bloom_cuda.insert_direct(direct, salts, (CS_BITS,), True,
                                                      blinded=blinded))
    rows = [{"route": "direct", "device_ms": d}]
    print(f"split: client/server table ({CS_BITS} bits, 13 salts, {keys} keys): direct "
          f"{d['bf_insert']:.4f} ms [{card}]", flush=True)
    for log2 in SUB_SWEEP_LOG2:
        def run():
            bloom_cuda.insert_subslice(words, salts, (CS_BITS,), True, blinded=blinded,
                                       slice_log2=log2)

        words.zero_()
        run()
        torch.cuda.synchronize()
        assert torch.equal(words, direct), f"sub-slice 2^{log2}: differs from direct"
        sp = insert_split(run)
        rows.append({"route": "subslice", "slice_log2": log2, "device_ms": sp})
        print(f"split: client/server table, sub-slice 2^{log2}, stash "
              f"{bloom_cuda.STASH_FACTOR}x: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in sp.items() if k.startswith("bf_insert_sub"))
              + f", all kernels {sp['total']:.4f} ms (profiler) [{card}]", flush=True)
    return rows


PROBE_ROUNDS = 3  # device-time and CUDA-event rounds of each probe


def probe_row(tag: str, call, words, keys, salts, sizes, mixed: bool, card: str,
              key_bytes: int = 16, rounds: int = PROBE_ROUNDS) -> dict:
    """One probe's row: ``call()`` probes the keys ``keys`` = (lo, hi) of
    the packed table ``words``. Its device time (``device_ms``) and call
    time (CUDA events over 20 calls), ``rounds`` rounds each after a
    warm-up; the (key, salt) bits tested up to each key's first clear bit
    (``probe_reads``); ``probe_bound`` and its sector model on those; the
    launch floor (``bloom_cuda.probe_floor_cuda``'s device time) where the
    tree has it."""
    import statistics

    from .device import window_ms
    from .measure_ntt import device_ms
    from .ops import bloom_cuda

    miss = probe_misses(words, *keys, salts, sizes, mixed)
    n_salts, count = miss.shape
    tested = probe_reads(miss)
    bound = probe_bound(count, tested, n_salts, sizes[-1], mixed, len(sizes), key_bytes)
    for _ in range(3):
        call()
    dev = [device_ms(call) for _ in range(rounds)]
    ev = [window_ms(call, 20) for _ in range(rounds)]
    floor_fn = getattr(bloom_cuda, "probe_floor_cuda", None)
    floor = ([device_ms(lambda: floor_fn(words, count)) for _ in range(rounds)]
             if floor_fn else None)
    row = {"filter": tag, "keys": count, "salts": n_salts, "table_bits": sizes[-1],
           "device_ms": dev, "call_ms": ev, "tested": tested, **bound,
           "launch_floor_ms": floor}
    med = statistics.median(dev)
    print(f"probe: {tag}: {count} keys, {n_salts} salts; device "
          + ", ".join(f"{v:.5f}" for v in dev) + " ms (profiler); the call "
          + ", ".join(f"{v:.5f}" for v in ev) + f" ms (CUDA events); {tested} (key, salt) bits "
          f"tested, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}), "
          f"{100 * bound['bound_ms'] / med:.2f}% of the median; sector model "
          f"{bound['sector_ms']:.5f} ms; launch floor "
          + (", ".join(f"{v:.5f}" for v in floor) + " ms" if floor else "not in this tree")
          + f" [{card}]", flush=True)
    return row


def probes(dev, card: str) -> list[dict]:
    """Each main-path filter's probe, as the module's note says."""
    import torch

    from .parallel import pipeline
    from .primitives import Blinding, BloomFilter, BloomParameters
    from .primitives.blinding import blinded_keys, distance_keys

    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    t, s, r, w = 1 << 20, 501, 99, 0xA5A5  # config[3] (bench.py:195-234)
    w_len = w.bit_length()
    bf = pipeline.build_pipeline_filter(t, s, r, w, dev)
    table, salts = bf.bits_device, bf._salts_device()
    bd_all = s * (torch.arange(r * r, device=dev) + r) % t
    n = 25 * 4096  # the step's checks, half of them inserted values
    bd = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                     bd_all[torch.randint(0, r * r, (n,), generator=gen, device=dev)],
                     torch.randint(0, t, (n,), generator=gen, device=dev)).reshape(25, 4096)
    rows.append(probe_row(
        f"config[3] r={r} ({bf.table_size} bits), pipeline.bf_probe",
        lambda: pipeline.bf_probe(bd, w, w_len, table, salts, bf.table_size), table,
        blinded_keys(bd.reshape(-1), w, w_len), salts, bf._sizes(), True, card, key_bytes=8))
    del bf, table
    for radius, fpp in ((4096, 1e-4), (4096, 1e-12), (8192, 1e-12)):
        sq = radius * radius
        p = BloomParameters(projected_element_count=sq, false_positive_probability=fpp,
                            random_seed=0xA5A5A5A5, index_mode="mixed")
        assert p.compute_optimal_parameters()
        bf = BloomFilter(p, device=dev)
        bl = Blinding.for_protocol(56, sq, seed=7)
        bf.insert_blind_distances(bl, sq)
        di = torch.cat([torch.randint(0, sq, (100_000,), generator=gen, device=dev),
                        sq + torch.randint(0, 1 << 30, (100_000,), generator=gen, device=dev)])
        klo, khi = distance_keys(di, bl.s, bl.r, bl.w, bl.w_len)
        rows.append(probe_row(
            f"r={radius} fpp {fpp:g} ({bf.table_size} bits), contains_u64_batch",
            lambda bf=bf, klo=klo, khi=khi: bf.contains_u64_batch(klo, khi), bf.bits_device,
            (klo, khi), bf._salts_device(), bf._sizes(), True, card))
        del bf
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--radii", default="4096,8192")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="time the direct insert kernel against the table's size instead")
    ap.add_argument("--inserts", action="store_true",
                    help="time the main paths' filters' device inserts instead")
    ap.add_argument("--probe", action="store_true",
                    help="time the main paths' filters' probes instead")
    ap.add_argument("--split", action="store_true",
                    help="time the sub-slice route's kernels on the client/server table instead")
    args = ap.parse_args(argv)

    import torch

    from .device import cuda_device, smi_line

    dev = cuda_device(0)
    card = smi_line()
    print(f"measure_bloom: {card}", flush=True)
    if args.sweep or args.inserts or args.probe or args.split:
        out = {"card": card, **({"sweep": sweep(dev, card)} if args.sweep else {}),
               **({"inserts": inserts(dev, card)} if args.inserts else {}),
               **({"split": split(dev, card)} if args.split else {}),
               **({"probe": probes(dev, card)} if args.probe else {})}
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    out = {"card": card, "runs": []}
    t0 = time.perf_counter()
    demo_runs(128, 1, dev)  # builds and loads the kernels the demo runs
    print(f"warm-up (r = 128): {time.perf_counter() - t0:.1f} s", flush=True)
    for radius in (int(r) for r in args.radii.split(",")):
        t0 = time.perf_counter()
        for run in demo_runs(radius, args.repeats, dev):
            out["runs"].append(run)
            st = run["stages_ms"]
            print(f"demo seal r={radius}: {'near' if run['near'] else 'far'}; setBF "
                  f"{st['setBF']:.1f} ms, dec {st['dec']:.1f} ms; stages "
                  + ", ".join(f"{k} {v:.1f}" for k, v in st.items())
                  + f"; wall {run['wall_s']:.3f} s; peak device memory {run['peak_bytes']} B "
                  f"[{card}]", flush=True)
        print(f"r={radius}: {time.perf_counter() - t0:.1f} s with set-up", flush=True)
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
