"""Load and launch the Bloom filter kernels (``csrc/bloom.cu``).

They replace no Pallas kernel: the reference runs its Bloom filter as XLA
(``pplp_tpu/primitives/bloom.py``: ``_insert_scan_fn``, ``_contains_fn``,
the size chain's ``_chain_insert_fn`` / ``_chain_contains_fn``) and in its
native library (``pplp_bf_indices_u64``, ``pplp_bf_insert_u64``). They work
on a packed table of u32 words (an int32 tensor holding the bits,
``ceil(table_size / 32)`` words):

* ``insert_cuda`` sets the bits of every key against every salt, by one of
  three routes (``route_of``). A small table, or one that gets few indices
  a word, takes the direct kernel ``bf_insert``: one launch,
  one thread a key, a RED a bit. A table of ``SUBSLICE_MIN_BITS`` to
  ``DIRECT_MAX_BITS`` bits, which stays in L2, takes the sub-slice route:
  buckets of ``2^SUB_LOG2`` bits, the size of a block's shared memory, and
  chunks of keys whose stash of u32 indices is at most ``STASH_FACTOR``
  times the table; each chunk is three launches: ``bf_insert_sub_count``
  (the chunk's totals by bucket), ``bf_insert_sub_scatter`` (the indices
  sorted by bucket into the stash) and ``bf_insert_sub_apply`` (one block
  a bucket ORs its run into a shared-memory copy of its words and writes
  each word back once). A larger table is partitioned: buckets of
  ``2^SLICE_LOG2`` bits and chunks whose stash is no larger than the table,
  three launches a chunk: ``bf_insert_count``, ``bf_insert_scatter`` and
  ``bf_insert_apply`` (the stash's REDs, one slice live in L2 at a time).
  ``insert_plan`` gives the route, the buckets, the chunks and the
  launches;
* ``probe_cuda`` returns, per key, whether every salt's bit is set (bool),
  in one launch of ``bf_probe``: a table of at most ``STAGE_WORDS`` words
  is staged in shared memory, a larger one read from device memory; a
  key's salts are tested one at a time, up to its first clear bit.
  ``probe_floor_cuda`` launches an empty kernel at the same geometry (the
  launch floor the probe's device time is read against).

Keys come as int64 (lo, hi) 32-bit word tensors (``keys=(lo, hi)``), or are
made by the kernel: ``blinded=(s, r, w, w_len, start, count)`` inserts the
server's keys ((s (di + r) mod 2^64) << w_len) | w for di in [start, start +
count); ``blind_distances=(bd, w, w_len)`` probes ((bd << w_len) | w) for an
int64 tensor bd of values below 2^32. ``sizes`` is the size chain (one size
for a plain filter), ending at the table size. The plain versions are
``primitives.bloom``'s (the unpacked table, ``index_fill_``, a gather); the
filter dispatches on its table's device. ``launches_by_kernel`` counts the
launches by kernel. No insert or probe waits for the card: the stash's
offsets are scanned on the device, and the verdicts stay there. The size
chain is checked once a size list (``chain_array``, cached); the C side
makes each size's fastmod multiplier from it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

__all__ = ["insert_cuda", "insert_direct", "insert_subslice", "insert_partitioned",
           "insert_plan", "route_of", "InsertPlan", "ROUTE_KERNELS",
           "subslice_buffers", "sub_count_cuda", "sub_scatter_cuda", "sub_apply_cuda",
           "partition_buffers", "count_cuda", "scatter_cuda", "apply_cuda", "probe_cuda",
           "probe_floor_cuda", "chain_array", "words_for", "launches_by_kernel",
           "reset_launches", "MAX_SALTS", "MAX_SIZES", "SLICE_LOG2", "DIRECT_MAX_BITS",
           "SUB_LOG2", "SUBSLICE_MIN_BITS", "SUBSLICE_MIN_FILL", "STASH_FACTOR",
           "STAGE_WORDS"]

SOURCE = cuda_build.CSRC / "bloom.cu"
MAX_SALTS = 128  # the reference's salt table (bloomfilter.h:468-490)
MAX_SIZES = 32  # a compressed filter's size chain
_WORDS, _BLINDED, _BLIND_DISTANCES = 0, 1, 2
# The insert's routes, from the kernels' rates against the table's size on
# the card (``measure_bloom --sweep``; the figures are in ``csrc/bloom.cu``'s
# header). A table of more than DIRECT_MAX_BITS bits is partitioned into
# buckets, slices of 2^SLICE_LOG2 bits; a smaller one of at least
# SUBSLICE_MIN_BITS bits that gets at least SUBSLICE_MIN_FILL indices a word
# takes the sub-slice route, buckets of 2^SUB_LOG2 bits and a stash of at
# most STASH_FACTOR times the table's words a chunk (``route_of``); the rest
# the direct kernel.
SLICE_LOG2 = 27
DIRECT_MAX_BITS = 352_000_000
SUB_LOG2 = 19
SUBSLICE_MIN_BITS = 1 << 27
SUBSLICE_MIN_FILL = 2  # indices a word at least
# A chunk's stash: at most 3.75 tables, the fewest chunks (6) that the
# client/server filter gets within 4, with room for PyTorch's caching
# allocator, which may round the stash's block up by up to 2 MiB, and the
# counts, so that the insert adds at most four tables to the peak.
STASH_FACTOR = 3.75
MAX_BUCKETS = 32  # csrc/bloom.cu: kMaxBuckets
TILE_ELEMS = 10240  # indices a block sorts in shared memory (kTileElems)
THREADS = 256  # keys a block at most (kThreads)
MAX_SUB_BUCKETS = 1024  # kMaxSubBuckets
SUB_LOG2_RANGE = (7, 20)  # kMinSubLog, kMaxSubLog: 16 B to 128 KB of words a sub-slice
# The probe stages a table of at most STAGE_WORDS words in shared memory
# (csrc/bloom.cu: kStageWords).
STAGE_WORDS = 11264

launches_by_kernel = {"bf_insert": 0, "bf_insert_sub_count": 0, "bf_insert_sub_scatter": 0,
                      "bf_insert_sub_apply": 0, "bf_insert_count": 0, "bf_insert_scatter": 0,
                      "bf_insert_apply": 0, "bf_probe": 0}


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _declare(lib):
    vp, i, ll, u, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
                         ctypes.c_ulonglong)
    lib.pplp_bf_insert.argtypes = [vp, vp, i, vp, i, i, i, vp, vp, ull, ull, ull, u, i, ll, vp]
    lib.pplp_bf_insert.restype = ctypes.c_int
    part = [vp, i, vp, i, i, i, vp, vp, ull, ull, ull, u, i, ll, i, i, i]
    lib.pplp_bf_insert_count.argtypes = [*part, vp, vp, vp]
    lib.pplp_bf_insert_count.restype = ctypes.c_int
    lib.pplp_bf_insert_scatter.argtypes = [*part, vp, vp, vp, vp]
    lib.pplp_bf_insert_scatter.restype = ctypes.c_int
    lib.pplp_bf_insert_apply.argtypes = [vp, vp, ll, vp]
    lib.pplp_bf_insert_apply.restype = ctypes.c_int
    sub = [vp, i, vp, i, i, i, vp, vp, ull, ull, ull, u, i, ll, i, i]
    lib.pplp_bf_insert_sub_count.argtypes = [*sub, vp, vp]
    lib.pplp_bf_insert_sub_count.restype = ctypes.c_int
    lib.pplp_bf_insert_sub_scatter.argtypes = [*sub, vp, vp, vp]
    lib.pplp_bf_insert_sub_scatter.restype = ctypes.c_int
    lib.pplp_bf_insert_sub_apply.argtypes = [vp, ll, vp, vp, i, i, vp]
    lib.pplp_bf_insert_sub_apply.restype = ctypes.c_int
    lib.pplp_bf_probe.argtypes = [vp, ll, vp, i, vp, i, i, i, vp, vp, u, i, ll, vp, vp]
    lib.pplp_bf_probe.restype = ctypes.c_int
    lib.pplp_bf_probe_floor.argtypes = [ll, ll, vp]
    lib.pplp_bf_probe_floor.restype = ctypes.c_int


def load():
    """The kernel library (built if needed), with its argtypes declared."""
    return cuda_build.load(SOURCE, _declare)


def words_for(table_size: int) -> int:
    """u32 words of a packed table of ``table_size`` bits."""
    return (table_size + 31) // 32


@functools.lru_cache(maxsize=256)
def _chain(sizes: tuple) -> tuple:
    if not 1 <= len(sizes) <= MAX_SIZES:
        raise ValueError(f"a size chain of 1 to {MAX_SIZES} sizes, got {len(sizes)}")
    if not all(0 < s < (1 << 32) for s in sizes):
        raise ValueError(f"sizes must be in (0, 2^32): {sizes}")
    chain = np.asarray(sizes, dtype=np.uint32)
    chain.flags.writeable = False
    return chain, chain.ctypes.data


def chain_array(sizes: tuple) -> np.ndarray:
    """The size chain ``sizes`` (a tuple ending at the table size) as the
    kernels take it, a read-only u32 host array; raises unless it is 1 to
    ``MAX_SIZES`` sizes in (0, 2^32). Checked and made once a size list (the
    array and its address are cached): a compressed filter's new list is a
    new key."""
    return _chain(sizes)[0]


def _check_table(words: torch.Tensor, salts: torch.Tensor, sizes) -> tuple:
    """Raise unless the table, salts and size chain are what the kernels
    take; returns the chain as a u32 host array (``chain_array``) and its
    address."""
    if not words.is_cuda:
        raise ValueError(f"the Bloom kernels take CUDA tensors, got {words.device}")
    if words.dtype != torch.int32 or salts.dtype != torch.int64:
        raise TypeError(f"need int32 words and int64 salts, got {words.dtype}, {salts.dtype}")
    if salts.device != words.device:
        raise ValueError(f"salts on {salts.device}, table on {words.device}")
    if not (words.is_contiguous() and salts.is_contiguous()):
        raise ValueError("table and salts must be contiguous")
    if not 1 <= salts.numel() <= MAX_SALTS:
        raise ValueError(f"1 to {MAX_SALTS} salts, got {salts.numel()}")
    chain = _chain(sizes if type(sizes) is tuple else tuple(int(s) for s in sizes))
    if words.numel() != words_for(int(chain[0][-1])):
        raise ValueError(f"{words.numel()} words for a table of {int(chain[0][-1])} bits")
    return chain


def _check_keys(words: torch.Tensor, *keys: torch.Tensor) -> int:
    count = keys[0].numel()
    for k in keys:
        if k.device != words.device or k.dtype != torch.int64 or not k.is_contiguous():
            raise ValueError(f"keys must be contiguous int64 on {words.device}, got "
                             f"{k.dtype} on {k.device}")
        if k.numel() != count:
            raise ValueError("lo and hi differ in length")
    return count


def _check_w(w: int, w_len: int, limit: int):
    if not (0 <= w_len < limit and 0 <= w < (1 << 32) and w >> max(w_len, 0) == 0):
        raise ValueError(f"need w < 2^w_len, 0 <= w_len < {limit}; got w={w}, w_len={w_len}")


@dataclass(frozen=True)
class InsertPlan:
    """How ``insert_cuda`` sets ``count`` keys' bits in a table of
    ``table_size`` bits at ``n_salts`` salts: ``route`` "direct" (one
    launch), or "subslice" / "partitioned": ``chunks`` chunks of
    ``chunk_keys`` keys (the last one ragged), each sorted into ``buckets``
    buckets of 2^``slice_log2`` bits (sub-slices or slices), the
    partitioned route's blocks taking ``tile_keys`` keys each."""

    table_size: int
    n_salts: int
    count: int
    route: str
    slice_log2: int
    buckets: int
    tile_keys: int
    chunk_keys: int
    chunks: int

    def launches(self) -> dict:
        """Launches by kernel of the insert."""
        if self.route == "direct":
            return {"bf_insert": int(self.count > 0)}
        return dict.fromkeys(ROUTE_KERNELS[self.route], self.chunks)


ROUTE_KERNELS = {"direct": ("bf_insert",),
                 "subslice": ("bf_insert_sub_count", "bf_insert_sub_scatter",
                              "bf_insert_sub_apply"),
                 "partitioned": ("bf_insert_count", "bf_insert_scatter", "bf_insert_apply")}


def route_of(table_size: int, n_salts: int, count: int) -> str:
    """The route ``insert_cuda`` takes: partitioned above
    ``DIRECT_MAX_BITS``; else the sub-slice route for a table of at least
    ``SUBSLICE_MIN_BITS`` bits that gets at least ``SUBSLICE_MIN_FILL``
    indices a word (its apply moves every word with an index through
    shared memory, 8 B there and back), and the direct kernel for the
    rest."""
    if table_size > DIRECT_MAX_BITS:
        return "partitioned"
    if (table_size >= SUBSLICE_MIN_BITS
            and count * n_salts >= SUBSLICE_MIN_FILL * words_for(table_size)):
        return "subslice"
    return "direct"


def insert_plan(table_size: int, n_salts: int, count: int, *, route: str | None = None,
                slice_log2: int | None = None, stash_factor: float | None = None) -> InsertPlan:
    """The plan of an insert on ``route`` (default ``route_of``'s). The
    sub-slice route: buckets of 2^``slice_log2`` bits (default
    ``SUB_LOG2``; at least one whole sub-slice in the table, at most
    ``MAX_SUB_BUCKETS``) and chunks of keys whose stash (chunk keys x salts
    u32 indices) is at most ``stash_factor`` (default ``STASH_FACTOR``)
    times the table's words. The partitioned route: buckets of
    2^``slice_log2`` bits (default ``SLICE_LOG2``, at most ``MAX_BUCKETS``)
    and chunks whose stash and per-block histograms (a u32 a bucket, fewer
    than one a key) are together no larger than the table's words; a chunk
    is a whole number of blocks' tiles. Raises on what the kernels do not
    take."""
    if not 1 <= n_salts <= MAX_SALTS:
        raise ValueError(f"1 to {MAX_SALTS} salts, got {n_salts}")
    if not 0 < table_size < (1 << 32):
        raise ValueError(f"a table of 1 to 2^32 - 1 bits, got {table_size}")
    route = route or route_of(table_size, n_salts, count)
    words = words_for(table_size)
    if route == "direct":
        return InsertPlan(table_size, n_salts, count, route, 0, 1, 0, count, int(count > 0))
    if route == "subslice":
        log2 = SUB_LOG2 if slice_log2 is None else slice_log2
        factor = STASH_FACTOR if stash_factor is None else stash_factor
        if not SUB_LOG2_RANGE[0] <= log2 <= SUB_LOG2_RANGE[1]:
            raise ValueError(f"a sub-slice of 2^{SUB_LOG2_RANGE[0]} to 2^{SUB_LOG2_RANGE[1]} "
                             f"bits, got 2^{log2}")
        if table_size < 1 << log2:
            raise ValueError(f"a table of {table_size} bits holds no whole sub-slice of "
                             f"2^{log2} bits")
        buckets = -(-table_size // (1 << log2))
        if buckets > MAX_SUB_BUCKETS:
            raise ValueError(f"{buckets} buckets of 2^{log2} bits; at most {MAX_SUB_BUCKETS}")
        if factor < 1:
            raise ValueError(f"a stash of at least the table's words, got {factor}x")
        chunk_keys = min(int(factor * words), (1 << 31) - 1) // n_salts
        if chunk_keys < 1:
            raise ValueError(f"a table of {table_size} bits holds no stash of one key at "
                             f"{n_salts} salts")
        return InsertPlan(table_size, n_salts, count, route, log2, buckets, 0, chunk_keys,
                          -(-count // chunk_keys))
    if route != "partitioned":
        raise ValueError(f"a route of {tuple(ROUTE_KERNELS)}, got {route!r}")
    log2 = SLICE_LOG2 if slice_log2 is None else slice_log2
    tile_keys = min(THREADS, TILE_ELEMS // n_salts)
    if not 5 <= log2 <= 31:
        raise ValueError(f"a slice of 2^5 to 2^31 bits, got 2^{log2}")
    buckets = -(-table_size // (1 << log2))
    if buckets > MAX_BUCKETS:
        raise ValueError(f"{buckets} buckets of 2^{log2} bits; at most {MAX_BUCKETS}")
    chunk_keys = words // (n_salts + 1) // tile_keys * tile_keys
    if chunk_keys < tile_keys:
        raise ValueError(f"a table of {table_size} bits holds no stash of {tile_keys} keys at "
                         f"{n_salts} salts")
    return InsertPlan(table_size, n_salts, count, route, log2, buckets, tile_keys, chunk_keys,
                      -(-count // chunk_keys))


def _key_args(words, keys, blinded) -> tuple:
    """(source, lo, hi, s, r, start, w, w_len, count) of the keys: ``keys=(lo,
    hi)`` int64 word tensors, or ``blinded=(s, r, w, w_len, start, count)``;
    lo and hi are tensors (or None)."""
    if (keys is None) == (blinded is None):
        raise ValueError("give keys or blinded")
    if keys is not None:
        lo, hi = keys
        return (_WORDS, lo, hi, 0, 0, 0, 0, 0, _check_keys(words, lo, hi))
    s, r, w, w_len, start, count = (int(v) for v in blinded)
    _check_w(w, w_len, 64)
    if not (0 <= s < (1 << 64) and 0 <= r < (1 << 64) and 0 <= start and 0 <= count):
        raise ValueError(f"bad blinded range {blinded}")
    return (_BLINDED, None, None, s, r, start, w, w_len, count)


def _chunk(key_args, first: int, count: int) -> tuple:
    """The C key arguments of keys [first, first + count) of ``key_args``."""
    source, lo, hi, s, r, start, w, w_len, _ = key_args
    if source == _WORDS:
        return (source, lo.data_ptr() + 8 * first, hi.data_ptr() + 8 * first, 0, 0, 0, 0, 0,
                count)
    return (source, None, None, s, r, start + first, w, w_len, count)


def insert_cuda(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
                keys=None, blinded=None) -> InsertPlan:
    """Set the bits of the keys in the packed table ``words``, in place:
    ``keys=(lo, hi)`` int64 word tensors [K], or ``blinded=(s, r, w, w_len,
    start, count)``. The route is ``route_of``'s; returns its plan
    (``insert_plan``)."""
    chain, _ = _check_table(words, salts, sizes)
    key_args = _key_args(words, keys, blinded)
    plan = insert_plan(int(chain[-1]), salts.numel(), key_args[-1])
    if plan.route == "direct":
        _direct(words, salts, chain, mixed, key_args)
    elif plan.route == "subslice":
        _subslice(words, salts, chain, mixed, key_args, plan)
    else:
        _partitioned(words, salts, chain, mixed, key_args, plan)
    return plan


def insert_direct(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
                  keys=None, blinded=None):
    """``insert_cuda`` through the direct kernel at any table size: one
    launch (none for no key). ``measure_bloom --sweep`` times it."""
    chain, _ = _check_table(words, salts, sizes)
    _direct(words, salts, chain, mixed, _key_args(words, keys, blinded))


def insert_subslice(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
                    keys=None, blinded=None, slice_log2: int | None = None,
                    stash_factor: float | None = None):
    """``insert_cuda`` through the sub-slice kernels at any table size that
    holds a whole sub-slice of 2^``slice_log2`` bits and at most
    ``MAX_SUB_BUCKETS`` of them, a chunk's stash at most ``stash_factor``
    times the table's words."""
    chain, _ = _check_table(words, salts, sizes)
    key_args = _key_args(words, keys, blinded)
    plan = insert_plan(int(chain[-1]), salts.numel(), key_args[-1], route="subslice",
                       slice_log2=slice_log2, stash_factor=stash_factor)
    _subslice(words, salts, chain, mixed, key_args, plan)


def insert_partitioned(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
                       keys=None, blinded=None, slice_log2: int | None = None):
    """``insert_cuda`` through the partitioned kernels at any table size
    that gives at most ``MAX_BUCKETS`` buckets of 2^``slice_log2`` bits."""
    chain, _ = _check_table(words, salts, sizes)
    key_args = _key_args(words, keys, blinded)
    plan = insert_plan(int(chain[-1]), salts.numel(), key_args[-1], route="partitioned",
                       slice_log2=slice_log2)
    _partitioned(words, salts, chain, mixed, key_args, plan)


def _direct(words, salts, chain, mixed, key_args):
    count = key_args[-1]
    if count == 0:
        return
    lib = load()
    code = lib.pplp_bf_insert(words.data_ptr(), salts.data_ptr(), salts.numel(),
                              chain.ctypes.data, chain.size, int(mixed),
                              *_chunk(key_args, 0, count),
                              cuda_build.raw_stream(words.get_device()))
    cuda_build.check(code, lib, "bf_insert")
    launches_by_kernel["bf_insert"] += 1


def partition_buffers(plan: InsertPlan, device) -> tuple:
    """(stash, hist, counts) of a partitioned insert, as int32 tensors: the
    stash of one chunk's indices (u32 [chunk_keys * n_salts]), the blocks'
    histograms (u32 [chunk_keys / tile_keys, buckets]) and each chunk's
    totals and cursors (u32 [chunks, 2 * buckets], zero)."""
    stash = torch.empty(plan.chunk_keys * plan.n_salts, dtype=torch.int32, device=device)
    hist = torch.empty(plan.chunk_keys // plan.tile_keys, plan.buckets, dtype=torch.int32,
                       device=device)
    counts = torch.zeros(plan.chunks, 2 * plan.buckets, dtype=torch.int32, device=device)
    return stash, hist, counts


def _head(salts, chain, mixed, key_c, plan) -> tuple:
    return (salts.data_ptr(), salts.numel(), chain.ctypes.data, chain.size, int(mixed), *key_c,
            plan.tile_keys, plan.slice_log2, plan.buckets)


def _count(lib, head, hist, counts, st):
    cuda_build.check(lib.pplp_bf_insert_count(*head, hist.data_ptr(), counts.data_ptr(), st),
                     lib, "bf_insert_count")
    launches_by_kernel["bf_insert_count"] += 1


def _scatter(lib, head, hist, counts, stash, st):
    cuda_build.check(lib.pplp_bf_insert_scatter(*head, hist.data_ptr(), counts.data_ptr(),
                                                stash.data_ptr(), st), lib, "bf_insert_scatter")
    launches_by_kernel["bf_insert_scatter"] += 1


def _apply(lib, words, stash, n, st):
    cuda_build.check(lib.pplp_bf_insert_apply(words.data_ptr(), stash.data_ptr(), n, st), lib,
                     "bf_insert_apply")
    launches_by_kernel["bf_insert_apply"] += 1


def _partitioned(words, salts, chain, mixed, key_args, plan: InsertPlan):
    """Each chunk of keys: count, scatter into the stash, apply; the buffers
    are made once an insert, on the table's stream."""
    count = key_args[-1]
    if count == 0:
        return
    lib, st = load(), cuda_build.raw_stream(words.get_device())
    stash, hist, counts = partition_buffers(plan, words.device)
    for c in range(plan.chunks):
        first = c * plan.chunk_keys
        n = min(plan.chunk_keys, count - first)
        head = _head(salts, chain, mixed, _chunk(key_args, first, n), plan)
        _count(lib, head, hist, counts[c], st)
        _scatter(lib, head, hist, counts[c], stash, st)
        _apply(lib, words, stash, n * plan.n_salts, st)


def subslice_buffers(plan: InsertPlan, device) -> tuple:
    """(stash, counts) of a sub-slice insert, as int32 tensors: the stash of
    one chunk's indices (u32 [chunk_keys * n_salts]) and each chunk's
    totals, cursors and offsets (u32 [chunks, 3 * buckets], zero)."""
    stash = torch.empty(plan.chunk_keys * plan.n_salts, dtype=torch.int32, device=device)
    counts = torch.zeros(plan.chunks, 3 * plan.buckets, dtype=torch.int32, device=device)
    return stash, counts


def _sub_head(salts, chain, mixed, key_c, plan) -> tuple:
    return (salts.data_ptr(), salts.numel(), chain.ctypes.data, chain.size, int(mixed), *key_c,
            plan.slice_log2, plan.buckets)


def _sub_count(lib, head, counts, st):
    cuda_build.check(lib.pplp_bf_insert_sub_count(*head, counts.data_ptr(), st), lib,
                     "bf_insert_sub_count")
    launches_by_kernel["bf_insert_sub_count"] += 1


def _sub_scatter(lib, head, counts, stash, st):
    cuda_build.check(lib.pplp_bf_insert_sub_scatter(*head, counts.data_ptr(), stash.data_ptr(),
                                                    st), lib, "bf_insert_sub_scatter")
    launches_by_kernel["bf_insert_sub_scatter"] += 1


def _sub_apply(lib, words, stash, counts, plan, st):
    cuda_build.check(lib.pplp_bf_insert_sub_apply(words.data_ptr(), words.numel(),
                                                  stash.data_ptr(), counts.data_ptr(),
                                                  plan.slice_log2, plan.buckets, st), lib,
                     "bf_insert_sub_apply")
    launches_by_kernel["bf_insert_sub_apply"] += 1


def _subslice(words, salts, chain, mixed, key_args, plan: InsertPlan):
    """Each chunk of keys: count, scatter into the stash by sub-slice,
    apply each sub-slice in shared memory; the buffers are made once an
    insert, on the table's stream."""
    count = key_args[-1]
    if count == 0:
        return
    lib, st = load(), cuda_build.raw_stream(words.get_device())
    stash, counts = subslice_buffers(plan, words.device)
    for c in range(plan.chunks):
        first = c * plan.chunk_keys
        head = _sub_head(salts, chain, mixed,
                         _chunk(key_args, first, min(plan.chunk_keys, count - first)), plan)
        _sub_count(lib, head, counts[c], st)
        _sub_scatter(lib, head, counts[c], stash, st)
        _sub_apply(lib, words, stash, counts[c], plan, st)


def _check_step(words, salts, sizes, plan: InsertPlan, keys, blinded, hist, counts, stash=None):
    """The checks of a step on one chunk: the table, the plan, the chunk's
    keys and the buffers; returns (chain, key arguments)."""
    chain, _ = _check_table(words, salts, sizes)
    if plan.route != "partitioned" or (plan.table_size, plan.n_salts) != (int(chain[-1]),
                                                                          salts.numel()):
        raise ValueError(f"{plan} is not a partition of this table and these salts")
    key_args = _key_args(words, keys, blinded)
    if key_args[-1] > plan.chunk_keys:
        raise ValueError(f"a chunk of at most {plan.chunk_keys} keys, got {key_args[-1]}")
    need = ((hist, plan.chunk_keys // plan.tile_keys * plan.buckets), (counts, 2 * plan.buckets),
            (stash, plan.chunk_keys * plan.n_salts))
    for buf, size in need:
        if buf is not None and (buf.device != words.device or buf.dtype != torch.int32
                                or not buf.is_contiguous() or buf.numel() != size):
            raise ValueError(f"need a contiguous int32 buffer of {size} on {words.device}")
    return chain, key_args


def count_cuda(words, salts, sizes, mixed: bool, plan: InsertPlan, hist, counts, *, keys=None,
               blinded=None):
    """``bf_insert_count`` on one chunk of the keys of an insert into
    ``words`` (at most ``plan.chunk_keys``): the blocks' histograms of
    buckets into ``hist`` and the chunk's totals added into ``counts[:B]``,
    a row of ``partition_buffers``' counts. One launch (none for no key)."""
    chain, key_args = _check_step(words, salts, sizes, plan, keys, blinded, hist, counts)
    if key_args[-1]:
        _count(load(), _head(salts, chain, mixed, _chunk(key_args, 0, key_args[-1]), plan),
               hist, counts, cuda_build.raw_stream(words.get_device()))


def scatter_cuda(words, salts, sizes, mixed: bool, plan: InsertPlan, hist, counts, stash, *,
                 keys=None, blinded=None):
    """``bf_insert_scatter`` on the chunk that ``count_cuda`` counted into
    ``hist`` and ``counts``: its indices sorted by bucket into the stash's
    first keys x salts words. One launch (none for no key)."""
    chain, key_args = _check_step(words, salts, sizes, plan, keys, blinded, hist, counts, stash)
    if key_args[-1]:
        _scatter(load(), _head(salts, chain, mixed, _chunk(key_args, 0, key_args[-1]), plan),
                 hist, counts, stash, cuda_build.raw_stream(words.get_device()))


def apply_cuda(words, stash, n: int):
    """``bf_insert_apply``: the stash's first ``n`` indices (below the
    table's bits) set in ``words``, in place. One launch (none for n = 0)."""
    if not (words.is_cuda and stash.device == words.device and words.dtype == stash.dtype ==
            torch.int32 and words.is_contiguous() and stash.is_contiguous()):
        raise ValueError("apply takes contiguous int32 words and stash on one CUDA device")
    if not 0 <= n <= stash.numel():
        raise ValueError(f"{n} indices of a stash of {stash.numel()}")
    if n:
        _apply(load(), words, stash, n, cuda_build.raw_stream(words.get_device()))


def _check_sub_step(words, salts, sizes, plan: InsertPlan, counts, stash, keys=None,
                    blinded=None, *, with_keys=True):
    """The checks of a sub-slice step on one chunk: the table, the plan,
    the chunk's keys (``with_keys``; the apply takes none) and the buffers;
    returns (chain, key arguments or None)."""
    chain, _ = _check_table(words, salts, sizes)
    if plan.route != "subslice" or (plan.table_size, plan.n_salts) != (int(chain[-1]),
                                                                       salts.numel()):
        raise ValueError(f"{plan} is not a sub-slice plan of this table and these salts")
    key_args = _key_args(words, keys, blinded) if with_keys else None
    if key_args and key_args[-1] > plan.chunk_keys:
        raise ValueError(f"a chunk of at most {plan.chunk_keys} keys, got {key_args[-1]}")
    for buf, size in ((counts, 3 * plan.buckets), (stash, plan.chunk_keys * plan.n_salts)):
        if buf is not None and (buf.device != words.device or buf.dtype != torch.int32
                                or not buf.is_contiguous() or buf.numel() != size):
            raise ValueError(f"need a contiguous int32 buffer of {size} on {words.device}")
    return chain, key_args


def sub_count_cuda(words, salts, sizes, mixed: bool, plan: InsertPlan, counts, *, keys=None,
                   blinded=None):
    """``bf_insert_sub_count`` on one chunk of the keys of an insert into
    ``words`` (at most ``plan.chunk_keys``): the chunk's totals by
    sub-slice added into ``counts[:B]``, a row of ``subslice_buffers``'
    counts. One launch (none for no key)."""
    chain, key_args = _check_sub_step(words, salts, sizes, plan, counts, None, keys, blinded)
    if key_args[-1]:
        _sub_count(load(), _sub_head(salts, chain, mixed, _chunk(key_args, 0, key_args[-1]),
                                     plan), counts, cuda_build.raw_stream(words.get_device()))


def sub_scatter_cuda(words, salts, sizes, mixed: bool, plan: InsertPlan, counts, stash, *,
                     keys=None, blinded=None):
    """``bf_insert_sub_scatter`` on the chunk that ``sub_count_cuda``
    counted into ``counts``: its indices sorted by sub-slice into the
    stash's first keys x salts words, the sub-slices' offsets into
    ``counts[2B:]``. One launch (none for no key)."""
    chain, key_args = _check_sub_step(words, salts, sizes, plan, counts, stash, keys, blinded)
    if key_args[-1]:
        _sub_scatter(load(), _sub_head(salts, chain, mixed, _chunk(key_args, 0, key_args[-1]),
                                       plan), counts, stash,
                     cuda_build.raw_stream(words.get_device()))


def sub_apply_cuda(words, salts, sizes, plan: InsertPlan, counts, stash):
    """``bf_insert_sub_apply``: each sub-slice's run of the stash (as
    ``counts`` places it) set in ``words`` in shared memory, in place. One
    launch."""
    _check_sub_step(words, salts, sizes, plan, counts, stash, with_keys=False)
    _sub_apply(load(), words, stash, counts, plan, cuda_build.raw_stream(words.get_device()))


def probe_cuda(words: torch.Tensor, salts: torch.Tensor, sizes, mixed: bool, *,
               keys=None, blind_distances=None) -> torch.Tensor:
    """Membership in the packed table ``words`` -> bool: ``keys=(lo, hi)``
    int64 word tensors [K] -> [K], or ``blind_distances=(bd, w, w_len)``
    with bd a contiguous int64 tensor of any shape, values below 2^32, and
    0 < w_len < 32 -> bool shaped like bd. One launch (none for no key); the
    verdicts stay on the device."""
    chain, address = _check_table(words, salts, sizes)
    if (keys is None) == (blind_distances is None):
        raise ValueError("give keys or blind_distances")
    if keys is not None:
        lo, hi = keys
        count = _check_keys(words, lo, hi)
        args = (_WORDS, lo.data_ptr(), hi.data_ptr(), 0, 0, count)
    else:
        lo, w, w_len = blind_distances
        count = _check_keys(words, lo)
        w, w_len = int(w), int(w_len)
        _check_w(w, w_len, 32)
        args = (_BLIND_DISTANCES, lo.data_ptr(), None, w, w_len, count)
    out = torch.empty(lo.shape, dtype=torch.bool, device=words.device)
    if count == 0:
        return out
    lib = load()
    code = lib.pplp_bf_probe(words.data_ptr(), words.numel(), salts.data_ptr(), salts.numel(),
                             address, chain.size, mixed, *args, out.data_ptr(),
                             cuda_build.raw_stream(words.get_device()))
    cuda_build.check(code, lib, "bf_probe")
    launches_by_kernel["bf_probe"] += 1
    return out


def probe_floor_cuda(words: torch.Tensor, count: int):
    """An empty kernel at the geometry of ``bf_probe`` on ``count`` keys in
    the packed table ``words`` (blocks, threads, dynamic shared memory): the
    probe's launch floor. Not a launch of ``bf_probe``, so not counted."""
    if not words.is_cuda or count < 1:
        raise ValueError("the launch floor takes a CUDA table and at least one key")
    lib = load()
    cuda_build.check(lib.pplp_bf_probe_floor(words.numel(), count,
                                             cuda_build.raw_stream(words.get_device())),
                     lib, "bf_probe_floor")
