"""A numpy model of the Bloom kernels (``pplp_tpu_torch/csrc/bloom.cu``) in
u32 arithmetic, held against the reference.

The model follows the kernels step for step: a key's (lo, hi) words from
each key source (given words; the fused blinded range ((s (start + i + r)
mod 2^64) << w_len) | w; the fused blind distances (bd << w_len) | w), one
round of the AP hash per salt, fmix32 in "mixed" mode, the reduction by
each size of the chain (``fastmod``: the high word of (ceil(2^64 / d) h mod
2^64) d, held against Python's ``%``), then word idx >> 5 and bit idx & 31 of a packed
table of ceil(table_size / 32) u32 words, whose little-endian bytes are the
wire's table. It is held against ``pplp_tpu.primitives.bloom``'s
``_indices`` / ``_chain_indices`` and the bytes of its ``_pack_bits_fn``,
against the port's plain version, and the fused key sources against
``blind_distance_keys`` (the tail chunk included) and the reference
pipeline's key formation. At r = 8192's 3,859,468,176 bits (above 2^31) it
checks indices and word indices without allocating the table.

The partitioned insert (a table above ``DIRECT_MAX_BITS``) is modelled
chunk by chunk as ``bf_insert_count``, ``bf_insert_scatter`` and
``bf_insert_apply`` run it: each index's bucket by a u32 shift, per-tile
and per-chunk counts, exclusive-scan offsets, a stash that holds every
(key, salt) index once inside its bucket's range, and the stash applied in
bucket order; held bit for bit against ``model_insert`` and the reference's
bytes, on ragged last buckets and chunks, chains of sizes, chunk starts of
the blinded source, and r = 8192's bucket ids past 2^31.

The sub-slice insert (a table of ``SUBSLICE_MIN_BITS`` to
``DIRECT_MAX_BITS`` bits) is modelled chunk by chunk as
``bf_insert_sub_count``, ``bf_insert_sub_scatter`` and
``bf_insert_sub_apply`` run it: buckets of 2^sub_log2 bits by a u32
shift, the chunk's totals, each tile of ``sub_tile_keys(salts)`` keys
hashed salt-major into a raw tile, counted, its runs reserved at the exclusive
scan of the totals plus a cursor, sorted by bucket and written out, and
each bucket's run ORed into a copy of its words (fewer in the table's last
bucket) that is stored back once; held bit for bit against
``model_insert``, the reference's bytes and filters and the port's plain
filter, in both index modes, on a size chain, a prefilled table, ragged
last buckets, several chunks and key counts that are not a multiple of the
tile, and chunk starts of the blinded source.

The probe is modelled as ``bf_probe`` runs it: a key's salts one at a
time, the key stopped at its first clear bit (``model_probe_early_exit``,
with the words it reads, one 32-byte sector each, against
``measure_bloom.probe_reads``). Exact comparisons throughout; no card
needed.
"""

import functools
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import primitives as rprim
from pplp_tpu.primitives import bloom as rbloom
from pplp_tpu_torch import primitives as prim
from pplp_tpu_torch.measure_bloom import probe_reads
from pplp_tpu_torch.ops import bloom_cuda
from pplp_tpu_torch.primitives import bloom
from pplp_tpu_torch.primitives.blinding import blinded_keys, distance_keys

U32 = np.uint32
R8192_BITS = 3_859_468_176  # BloomParameters(8192^2, 1e-12).table_size


# --- the model ----------------------------------------------------------

def model_key_words(keys: np.ndarray):
    """u64 keys -> (lo, hi) u32 words."""
    return (keys & np.uint64(0xFFFFFFFF)).astype(U32), (keys >> np.uint64(32)).astype(U32)


def model_blinded_range(s, r, w, w_len, start, count) -> np.ndarray:
    """Key source kBlinded: bd = s (start + i + r) mod 2^64, (bd << w_len) | w."""
    i = np.arange(count, dtype=np.uint64)
    bd = np.uint64(s) * (np.uint64(start) + i + np.uint64(r))  # wraps mod 2^64
    return (bd << np.uint64(w_len)) | np.uint64(w)


def model_blind_distances(bd: np.ndarray, w, w_len) -> np.ndarray:
    """Key source kBlindDistances: (bd << w_len) | w for bd < 2^32."""
    return (bd.astype(np.uint64) << np.uint64(w_len)) | np.uint64(w)


def model_multiplier(d: int) -> np.uint64:
    """ceil(2^64 / d) mod 2^64, as ``make_chain`` makes it: ~0 / d + 1."""
    return np.uint64((((1 << 64) - 1) // d + 1) & ((1 << 64) - 1))


def model_fastmod(h: np.ndarray, mul: np.uint64, d: int) -> np.ndarray:
    """``fastmod``: the high word of (mul h mod 2^64) d, from 32-bit halves
    in u64 (hi d + (lo d >> 32) < 2^64 for d < 2^32)."""
    d64 = np.uint64(d)
    low = mul * h.astype(np.uint64)  # wraps mod 2^64
    lo, hi = low & np.uint64(0xFFFFFFFF), low >> np.uint64(32)
    return ((hi * d64 + ((lo * d64) >> np.uint64(32))) >> np.uint64(32)).astype(U32)


def model_indices(keys: np.ndarray, salts: np.ndarray, sizes, mixed: bool) -> np.ndarray:
    """bit_index for every (salt, key): [S, K] u32."""
    i1, i2 = model_key_words(keys)
    h = salts.astype(U32)[:, None]
    with np.errstate(over="ignore"):
        h = h ^ ((h << U32(7)) ^ (i1 * (h >> U32(3))) ^ ~((h << U32(11)) + (i2 ^ (h >> U32(5)))))
        if mixed:
            h = h ^ (h >> U32(16))
            h = h * U32(0x85EBCA6B)
            h = h ^ (h >> U32(13))
            h = h * U32(0xC2B2AE35)
            h = h ^ (h >> U32(16))
    for size in sizes:
        h = model_fastmod(h, model_multiplier(size), size)
    return h


def model_insert(words: np.ndarray, idx: np.ndarray):
    """atomicOr(&words[idx >> 5], 1 << (idx & 31)) for every index."""
    idx = idx.reshape(-1)
    np.bitwise_or.at(words, idx >> U32(5), U32(1) << (idx & U32(31)))


def model_probe(words: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Every salt's bit set (the kernel stops at the first clear one)."""
    return ((words[idx >> U32(5)] >> (idx & U32(31))) & U32(1)).astype(bool).all(axis=0)


def model_probe_early_exit(words: np.ndarray, idx: np.ndarray):
    """``probe_key``: each key's salts one at a time, the key stopped at its
    first clear bit. Returns (verdicts [K], words read a key [K])."""
    n_salts, count = idx.shape
    verdicts = np.ones(count, bool)
    reads = np.zeros(count, np.int64)
    for k in range(count):
        for j in range(n_salts):
            reads[k] += 1
            if not (words[idx[j, k] >> U32(5)] >> (idx[j, k] & U32(31))) & U32(1):
                verdicts[k] = False
                break
    return verdicts, reads


def model_bytes(words: np.ndarray, table_size: int) -> bytes:
    assert sys.byteorder == "little"
    return words.view(np.uint8)[:table_size // 8].tobytes()


# --- the partitioned insert ----------------------------------------------

def model_buckets(idx: np.ndarray, slice_log2: int) -> np.ndarray:
    """bucket = idx >> slice_log2, a u32 shift."""
    return idx.astype(U32) >> U32(slice_log2)


def model_count(idx: np.ndarray, tile_keys: int, slice_log2: int, n_buckets: int):
    """bf_insert_count on one chunk's indices [S, K]: each tile's (block's)
    histogram of buckets [tiles, B] and the chunk's totals [B]."""
    b = model_buckets(idx, slice_log2)
    tile = np.broadcast_to(np.arange(idx.shape[1]) // tile_keys, idx.shape)
    hist = np.zeros((-(-idx.shape[1] // tile_keys), n_buckets), U32)
    np.add.at(hist, (tile.reshape(-1), b.reshape(-1)), U32(1))
    return hist, hist.sum(axis=0, dtype=U32)


def exclusive_scan(c: np.ndarray) -> np.ndarray:
    return (np.cumsum(c, dtype=U32) - c).astype(U32)


def model_scatter(idx: np.ndarray, hist, totals, tile_keys: int, slice_log2: int):
    """bf_insert_scatter: every tile reserves its run of each bucket (the
    bucket's chunk offset, the exclusive scan of totals, plus a cursor; the
    kernel's blocks reserve in any order, the model in tile order), sorts
    its indices by bucket (a thread a key, its salts in order) and writes
    them out in order. Returns the stash and the buckets' offsets."""
    offsets = exclusive_scan(totals)
    cursors = np.zeros_like(totals)
    stash = np.full(int(totals.sum()), 0xFFFFFFFF, U32)
    for t in range(hist.shape[0]):
        tile = idx[:, t * tile_keys:(t + 1) * tile_keys].T.reshape(-1)  # key-major
        local = exclusive_scan(hist[t])
        dst = offsets + cursors
        cursors += hist[t]
        b = model_buckets(tile, slice_log2)
        order = np.argsort(b, kind="stable")
        sorted_tile, sb = tile[order], b[order]
        j = np.arange(sorted_tile.size, dtype=U32)
        stash[dst[sb] + (j - local[sb])] = sorted_tile
    return stash, offsets


def model_partitioned(words, keys_of, count, salts, sizes, mixed, plan):
    """The partitioned insert of keys ``keys_of(first, n)`` (u64 keys
    [first, first + n)) into ``words``, chunk by chunk; checks each chunk's
    stash and returns the chunks' (stash, offsets, totals)."""
    chunks = []
    for first in range(0, count, plan.chunk_keys):
        n = min(plan.chunk_keys, count - first)
        idx = model_indices(keys_of(first, n), salts, sizes, mixed)
        hist, totals = model_count(idx, plan.tile_keys, plan.slice_log2, plan.buckets)
        stash, offsets = model_scatter(idx, hist, totals, plan.tile_keys, plan.slice_log2)
        # Every (key, salt) index once, each inside its bucket's range.
        assert stash.size == idx.size
        assert np.array_equal(np.sort(stash), np.sort(idx.reshape(-1)))
        b = model_buckets(stash, plan.slice_log2)
        pos = np.arange(stash.size)
        assert ((offsets[b] <= pos) & (pos < offsets[b] + totals[b])).all()
        assert (np.diff(b.astype(np.int64)) >= 0).all()  # sorted by bucket
        # The stash and the histograms fit in the table's words.
        assert stash.size + hist.size <= words.size
        model_insert(words, stash)  # bf_insert_apply: the stash in order
        chunks.append((stash, offsets, totals))
    return chunks


# --- the sub-slice insert -------------------------------------------------

def _kernel_constant(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                         bloom_cuda.SOURCE.read_text()).group(1))


SUB_TILE = _kernel_constant("kSubTile")  # indices a scatter block's tile holds at most
SUB_THREADS = _kernel_constant("kSubScatterThreads")


def model_sub_tile_keys(n_salts: int) -> int:
    """``sub_tile_keys``: SUB_TILE / n_salts keys a tile, rounded down to
    whole rounds of the scatter's threads where that leaves at least one."""
    keys = SUB_TILE // n_salts
    return keys // SUB_THREADS * SUB_THREADS if keys >= SUB_THREADS else keys


def model_sub_count(idx: np.ndarray, sub_log2: int, n_buckets: int) -> np.ndarray:
    """bf_insert_sub_count on one chunk's indices [S, K]: its totals by
    bucket (the kernel's blocks add theirs in any order)."""
    return np.bincount(model_buckets(idx, sub_log2).reshape(-1),
                       minlength=n_buckets).astype(U32)


def model_sub_scatter(idx: np.ndarray, totals, sub_log2: int, tile_keys: int):
    """bf_insert_sub_scatter: every tile of ``tile_keys`` keys (a block)
    hashes into a raw tile salt-major (raw[j * keys + i]), counts it by
    bucket, reserves each bucket's run at its offset (the exclusive scan of
    totals) plus a cursor (the kernel's blocks in any order, the model's in
    tile order), sorts the raw tile by bucket (the kernel's order inside a
    bucket is free, the model's stable) and writes it out in order.
    Returns the stash, the buckets' offsets and the (tile, bucket) runs."""
    offsets = exclusive_scan(totals)
    cursors = np.zeros_like(totals)
    stash = np.full(int(totals.sum()), 0xFFFFFFFF, U32)
    runs = []
    for t in range(-(-idx.shape[1] // tile_keys)):
        raw = idx[:, t * tile_keys:(t + 1) * tile_keys].reshape(-1)  # salt-major
        b = model_buckets(raw, sub_log2)
        count = np.bincount(b, minlength=totals.size).astype(U32)
        dst = offsets + cursors
        cursors += count
        local = exclusive_scan(count)
        order = np.argsort(b, kind="stable")
        sorted_tile, sb = raw[order], b[order]
        j = np.arange(sorted_tile.size, dtype=U32)
        stash[dst[sb] + (j - local[sb])] = sorted_tile
        runs += [(int(dst[k]), int(count[k])) for k in np.flatnonzero(count)]
    assert np.array_equal(cursors, totals)
    return stash, offsets, runs


def model_sub_apply(words: np.ndarray, stash, totals, offsets, sub_log2: int):
    """bf_insert_sub_apply: a block a bucket with indices copies its words
    (2^sub_log2 bits; fewer in the table's last bucket, and none past its
    last word) into shared memory, ORs in its run of the stash and stores
    the words back once."""
    span = 1 << (sub_log2 - 5)
    for b in np.flatnonzero(totals):
        w0 = int(b) * span
        nw = min(span, words.size - w0)
        smem = words[w0:w0 + nw].copy()
        run = stash[offsets[b]:offsets[b] + totals[b]]
        assert (model_buckets(run, sub_log2) == b).all()
        np.bitwise_or.at(smem, (run >> U32(5)) - U32(w0), U32(1) << (run & U32(31)))
        words[w0:w0 + nw] = smem


def model_subslice(words, keys_of, count, salts, sizes, mixed, plan):
    """The sub-slice insert of keys ``keys_of(first, n)`` (u64 keys [first,
    first + n)) into ``words``, chunk by chunk; checks each chunk's stash
    and returns the number of chunks."""
    tile_keys = model_sub_tile_keys(salts.size)
    chunks = 0
    for first in range(0, count, plan.chunk_keys):
        n = min(plan.chunk_keys, count - first)
        idx = model_indices(keys_of(first, n), salts, sizes, mixed)
        totals = model_sub_count(idx, plan.slice_log2, plan.buckets)
        stash, offsets, runs = model_sub_scatter(idx, totals, plan.slice_log2, tile_keys)
        # Every (key, salt) index once, each inside its bucket's range, each
        # (tile, bucket) run contiguous; the stash within its cap.
        assert stash.size == idx.size <= plan.chunk_keys * plan.n_salts
        assert plan.chunk_keys * plan.n_salts <= bloom_cuda.STASH_FACTOR * words.size
        assert np.array_equal(np.sort(stash), np.sort(idx.reshape(-1)))
        b = model_buckets(stash, plan.slice_log2)
        assert (np.diff(b.astype(np.int64)) >= 0).all()
        for start, length in runs:
            assert (b[start:start + length] == b[start]).all()
        model_sub_apply(words, stash, totals, offsets, plan.slice_log2)
        chunks += 1
    return chunks


def _params(mod, count, fpp, mode):
    p = mod.BloomParameters(projected_element_count=count, false_positive_probability=fpp,
                            random_seed=0xA5A5A5A5, index_mode=mode)
    assert p.compute_optimal_parameters()
    return p


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    keys[:2] = (1 << 64) - 1, 0
    return keys


# --- against the reference -----------------------------------------------

@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_model_indices_and_bytes_match_reference(mode):
    """The model's indices equal the reference's ``_indices``; its word
    table's bytes equal ``_pack_bits_fn`` of the reference's unpacked table
    and the reference filter's ``serialize()`` table."""
    n = 5000
    keys = _keys(n, 1)
    rbf = rprim.BloomFilter(_params(rprim, n, 1e-4, mode))
    salts, ts, mixed = rbf.salts, rbf.table_size, mode == "mixed"
    lo, hi = model_key_words(keys)
    idx = model_indices(keys, salts, (ts,), mixed)
    want = np.asarray(rbloom._indices(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(salts),
                                      jnp.uint32(ts), mixed))
    assert np.array_equal(idx, want)
    words = np.zeros(bloom_cuda.words_for(ts), U32)
    model_insert(words, idx)
    bits = np.zeros(ts, np.uint8)
    bits[idx.reshape(-1)] = 1
    packed = np.asarray(rbloom._pack_bits_fn(ts)(jnp.asarray(bits)))
    assert model_bytes(words, ts) == packed.tobytes()
    rbf.insert_u64_batch(jnp.asarray(lo), jnp.asarray(hi))
    assert rbf.serialize().endswith(model_bytes(words, ts))
    # The probe: members all present, the verdicts the reference's.
    probes = np.concatenate([keys[:300], _keys(700, 2)])
    plo, phi = model_key_words(probes)
    got = model_probe(words, model_indices(probes, salts, (ts,), mixed))
    assert got[:300].all()
    assert np.array_equal(got, np.asarray(rbf.contains_u64_batch(jnp.asarray(plo),
                                                                  jnp.asarray(phi))))


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_model_size_chain_matches_reference(mode):
    """A compressed filter's chain of three sizes: the model's indices equal
    ``_chain_indices``, and its table after the reference's own compressions
    is the reference's, byte for byte."""
    keys = _keys(900, 3)
    rbf = rprim.CompressibleBloomFilter(_params(rprim, 1000, 1e-3, mode))
    mixed = mode == "mixed"
    rbf.insert_u64_batch(*(jnp.asarray(k) for k in model_key_words(keys[:600])))
    rbf._sync_host()
    rbf.bit_table = np.array(rbf.bit_table)
    assert rbf.compress(30.0) and rbf.compress(25.0)
    sizes = tuple(rbf.size_list)
    assert len(sizes) == 3
    lo, hi = model_key_words(keys[600:])
    idx = model_indices(keys[600:], rbf.salts, sizes, mixed)
    want = np.asarray(rbloom._chain_indices(jnp.asarray(lo), jnp.asarray(hi),
                                            jnp.asarray(rbf.salts), sizes, mixed))
    assert np.array_equal(idx, want)
    words = np.zeros(bloom_cuda.words_for(sizes[-1]), U32)
    words.view(np.uint8)[:sizes[-1] // 8] = rbf.bit_table
    model_insert(words, idx)
    rbf.insert_u64_batch(jnp.asarray(lo), jnp.asarray(hi))
    rbf._sync_host()
    assert model_bytes(words, sizes[-1]) == np.asarray(rbf.bit_table).tobytes()


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_model_indices_above_2_31(mode):
    """At r = 8192 and fpp 1e-12 the table has 3,859,468,176 bits: indices
    reach past 2^31, word indices stay below 2^27, and the model agrees with
    the reference's ``_indices``, the port's plain ``_indices`` (int64) and
    the host's scalar path, with no table allocated."""
    p = _params(prim, 8192 * 8192, 1e-12, mode)
    assert (p.table_size, p.number_of_hashes) == (R8192_BITS, 40)
    bf = prim.BloomFilter(p, device="cpu")
    ts, mixed = bf.table_size, mode == "mixed"
    keys = np.concatenate([_keys(3000, 4), model_blinded_range(0x3FFFFFFF, 0x12345, 0xBEEF, 16,
                                                              67_000_000, 1000)])
    idx = model_indices(keys, bf.salts, (ts,), mixed)
    assert idx.max() >= 1 << 31 and (idx >> U32(5)).max() < 1 << 27 and idx.max() < ts
    lo, hi = model_key_words(keys)
    want = np.asarray(rbloom._indices(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(bf.salts),
                                      jnp.uint32(ts), mixed))
    assert np.array_equal(idx, want)
    ours = bloom._indices(torch.from_numpy(lo.astype(np.int64)),
                          torch.from_numpy(hi.astype(np.int64)),
                          bf._salts_device(), (ts,), mixed).numpy()
    assert np.array_equal(idx, ours)
    for j in (0, 1, 2999, 3500):
        assert list(bf._host_indices(int(keys[j]).to_bytes(8, "little"))) == idx[:, j].tolist()


# --- the fused key sources ------------------------------------------------

@pytest.mark.parametrize("sq_radius,w", [(100, 0x1), (70_001, 0xBEEF), (1 << 16, 0x7FFF)])
def test_blinded_source_matches_blind_distance_keys(sq_radius, w):
    """The fused source's keys for di in [0, r^2) are blind_distance_keys'
    keys (the port's and the reference's) with the tail's repeats dropped;
    the same bits are set, and the count of fresh keys is r^2 either way."""
    bl = prim.Blinding(r=0xFFFFFFF0, s=0xFEDCBA98, w=w)
    keys = model_blinded_range(bl.s, bl.r, bl.w, bl.w_len, 0, sq_radius)
    chunks = list(prim.blind_distance_keys(bl, sq_radius, "cpu"))
    rchunks = list(rprim.blind_distance_keys(rprim.Blinding(r=bl.r, s=bl.s, w=bl.w), sq_radius))
    lo = np.concatenate([c[0].numpy() for c in chunks])
    hi = np.concatenate([c[1].numpy() for c in chunks])
    assert np.array_equal(lo, np.concatenate([np.asarray(c[0]) for c in rchunks]))
    fresh = sum(c[2] for c in chunks)
    assert fresh == sq_radius
    mlo, mhi = model_key_words(keys)
    assert np.array_equal(mlo, lo[:sq_radius]) and np.array_equal(mhi, hi[:sq_radius])
    # The tail repeats the last key: no other key, so no other bit.
    assert (lo[sq_radius:] == mlo[-1]).all() and (hi[sq_radius:] == mhi[-1]).all()
    # A later range (start > 0), as the port's distance_keys makes it.
    di = torch.arange(12_345, 12_345 + 500, dtype=torch.int64)
    klo, khi = distance_keys(di, bl.s, bl.r, bl.w, bl.w_len)
    mlo, mhi = model_key_words(model_blinded_range(bl.s, bl.r, bl.w, bl.w_len, 12_345, 500))
    assert np.array_equal(klo.numpy(), mlo) and np.array_equal(khi.numpy(), mhi)


def test_blind_distance_source_matches_the_pipeline_keys():
    """(bd << w_len) | w for bd < 2^32: the model's words are the port's
    ``blinded_keys`` and the reference pipeline's formation
    (``pplp_tpu/parallel/pipeline.py:122-124``)."""
    rng = np.random.default_rng(6)
    bd = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(U32)
    for w, w_len in ((0xA5A5, 16), (1, 1), (0x7FFFFFFF, 31)):
        lo, hi = model_key_words(model_blind_distances(bd, w, w_len))
        klo, khi = blinded_keys(torch.from_numpy(bd.astype(np.int64)), w, w_len)
        assert np.array_equal(klo.numpy(), lo) and np.array_equal(khi.numpy(), hi)
        jbd = jnp.asarray(bd)
        rlo = (jbd << jnp.uint32(w_len)) | jnp.uint32(w)
        rhi = jbd >> jnp.uint32(32 - w_len)
        assert np.array_equal(np.asarray(rlo), lo) and np.array_equal(np.asarray(rhi), hi)


def test_model_words_are_the_plain_filters_bytes():
    """The port's plain filter (unpacked table) and its packed CPU filter
    (words) give the model's bytes for the same blinded range."""
    bl = prim.Blinding(r=0x1234, s=0x3FFFFFFB, w=0x5A5A)
    sq = 20_000
    keys = model_blinded_range(bl.s, bl.r, bl.w, bl.w_len, 0, sq)
    for packed in (False, True):
        bf = prim.BloomFilter(_params(prim, sq, 1e-6, "mixed"), device="cpu", packed=packed)
        bf.insert_blind_distances(bl, sq)
        words = np.zeros(bloom_cuda.words_for(bf.table_size), U32)
        model_insert(words, model_indices(keys, bf.salts, (bf.table_size,), True))
        assert bf.serialize() == bf._header_bytes() + model_bytes(words, bf.table_size)
        assert bf.inserted_element_count == sq
        if packed:
            assert np.array_equal(bf.bits_device.numpy().view(U32), words)


# --- the partitioned insert against the reference -------------------------

SLICE = 16  # 65,536-bit slices: the kernels' arithmetic on small tables
RAGGED = 5 * (1 << SLICE) + 776  # a table with a ragged last bucket of 776 bits


@pytest.mark.parametrize("case", ["just above one slice", "ragged last bucket", "two sizes",
                                  "three sizes", "128 salts"])
@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_partitioned_model_matches_reference(case, mode):
    """The partitioned model's words equal ``model_insert`` of every index
    and the reference's ``_pack_bits_fn`` bytes of its unpacked table, with
    a key count that is not a multiple of the chunk; the chain's indices
    are the reference's ``_indices`` / ``_chain_indices``."""
    sizes = {"just above one slice": ((1 << 17) + 8,), "ragged last bucket": (RAGGED,),
             "two sizes": (2 * RAGGED, RAGGED), "three sizes": (3 * RAGGED + 8, 2 * RAGGED, RAGGED),
             "128 salts": (3 * RAGGED,)}[case]
    slice_log2 = 17 if case == "just above one slice" else SLICE
    salts = np.asarray(bloom._PREDEF_SALT[:128 if case == "128 salts" else 13], U32)
    mixed, ts = mode == "mixed", sizes[-1]
    plan = bloom_cuda.insert_plan(ts, salts.size, 1, slice_log2=slice_log2, route="partitioned")
    count = 2 * plan.chunk_keys + 123
    keys = _keys(count, 7)
    assert plan.buckets == -(-ts // (1 << slice_log2)) and ts % (1 << slice_log2)
    words = np.zeros(bloom_cuda.words_for(ts), U32)
    chunks = model_partitioned(words, lambda a, n: keys[a:a + n], count, salts, sizes, mixed,
                               plan)
    assert len(chunks) == 3 == -(-count // plan.chunk_keys)
    idx = model_indices(keys, salts, sizes, mixed)
    lo, hi = model_key_words(keys)
    jl, jh, js = jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(salts)
    want = (rbloom._indices(jl, jh, js, jnp.uint32(ts), mixed) if len(sizes) == 1 else
            rbloom._chain_indices(jl, jh, js, sizes, mixed))
    assert np.array_equal(idx, np.asarray(want))
    direct = np.zeros_like(words)
    model_insert(direct, idx)
    assert np.array_equal(words, direct)
    bits = np.zeros(ts, np.uint8)
    bits[idx.reshape(-1)] = 1
    packed = np.asarray(rbloom._pack_bits_fn(ts)(jnp.asarray(bits)))
    assert model_bytes(words, ts) == packed.tobytes()


_UNSAFE = prim.Blinding.deterministic(7)  # safe_blinding=False at seed 7


@pytest.mark.parametrize("s,r,w,sq_radius", [
    (0xFEDCBA98, 0xFFFFFFF0, 0xBEEF, 70_001),
    # the seed's full 32-bit s and r at r = 400 (test_torch_protocol.py's
    # test_unsafe_blinding_matches_reference)
    (_UNSAFE.s, _UNSAFE.r, _UNSAFE.w, 400 * 400),
])
def test_partitioned_chunk_starts_of_the_blinded_source(s, r, w, sq_radius):
    """The blinded source cut into chunks (each chunk's keys from start +
    its first key) gives ``blind_distance_keys``' keys, the port's and the
    reference's, and the partitioned model's words equal the direct
    model's over the whole range."""
    bl = prim.Blinding(r=r, s=s, w=w)
    salts = np.asarray(bloom._PREDEF_SALT[:13], U32)
    plan = bloom_cuda.insert_plan(RAGGED, 13, sq_radius, slice_log2=SLICE, route="partitioned")
    assert sq_radius % plan.chunk_keys and plan.chunks >= 2

    def keys_of(first, n):
        return model_blinded_range(bl.s, bl.r, bl.w, bl.w_len, first, n)

    keys = np.concatenate([keys_of(a, min(plan.chunk_keys, sq_radius - a))
                           for a in range(0, sq_radius, plan.chunk_keys)])
    chunks = list(prim.blind_distance_keys(bl, sq_radius, "cpu"))
    lo = np.concatenate([c[0].numpy() for c in chunks])
    hi = np.concatenate([c[1].numpy() for c in chunks])
    rlo = np.concatenate([np.asarray(c[0]) for c in rprim.blind_distance_keys(
        rprim.Blinding(r=bl.r, s=bl.s, w=bl.w), sq_radius)])
    mlo, mhi = model_key_words(keys)
    assert np.array_equal(mlo, lo[:sq_radius]) and np.array_equal(mhi, hi[:sq_radius])
    assert np.array_equal(rlo, lo)
    words = np.zeros(bloom_cuda.words_for(RAGGED), U32)
    model_partitioned(words, keys_of, sq_radius, salts, (RAGGED,), True, plan)
    direct = np.zeros_like(words)
    model_insert(direct, model_indices(keys, salts, (RAGGED,), True))
    assert np.array_equal(words, direct)


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_partitioned_buckets_above_2_31(mode):
    """r = 8192's 3,859,468,176 bits in slices of 2^SLICE_LOG2: bucket ids
    of indices past 2^31 by u32 shift equal a Python-int reference, the last
    bucket is ragged, and the plan's chunks keep the stash and histograms
    within the table's words; no table is allocated."""
    bf = prim.BloomFilter(_params(prim, 8192 * 8192, 1e-12, mode), device="cpu")
    plan = bloom_cuda.insert_plan(R8192_BITS, 40, 8192 * 8192)
    assert plan.route == "partitioned" and plan.slice_log2 == bloom_cuda.SLICE_LOG2
    assert plan.buckets == -(-R8192_BITS // (1 << plan.slice_log2)) <= bloom_cuda.MAX_BUCKETS
    assert R8192_BITS % (1 << plan.slice_log2)  # the last bucket is ragged
    assert plan.chunks == 23 and plan.count % plan.chunk_keys
    words = bloom_cuda.words_for(R8192_BITS)
    assert plan.chunk_keys * 40 + plan.chunk_keys // plan.tile_keys * plan.buckets <= words
    keys = np.concatenate([_keys(3000, 8), model_blinded_range(0x3FFFFFFF, 0x12345, 0xBEEF, 16,
                                                              60_000_000, 1000)])
    idx = model_indices(keys, bf.salts, (R8192_BITS,), mode == "mixed")
    assert idx.max() >= 1 << 31
    b = model_buckets(idx, plan.slice_log2)
    assert b.dtype == U32 and b.max() == plan.buckets - 1
    assert b.tolist() == [[int(i) >> plan.slice_log2 for i in row] for row in idx.tolist()]
    hist, totals = model_count(idx, plan.tile_keys, plan.slice_log2, plan.buckets)
    assert int(totals.sum()) == idx.size
    assert hist.shape == (-(-keys.size // plan.tile_keys), plan.buckets)


# --- the sub-slice insert against the reference ----------------------------

SUB_CASES = {  # name: (projected keys, fpp, salts or None, sub_log2, stash factor, prefill)
    "ragged last sub-slice": (5000, 1e-4, None, 12, None, False),
    "exactly one sub-slice": (None, None, 13, 12, None, False),
    "749 buckets of 2^7": (5000, 1e-4, None, 7, None, False),
    "prefilled": (5000, 1e-4, None, 11, None, True),
    "several chunks, a ragged last one": (5000, 1e-4, None, 12, 1, False),
    "128 salts": (900, 1e-4, 128, 10, None, False),
}


@pytest.mark.parametrize("case", list(SUB_CASES))
@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_subslice_model_matches_reference(case, mode):
    """The sub-slice model's words equal the reference filter's table
    (``insert_u64_batch``, then ``serialize()``), the port's plain insert's
    (``insert_plain`` on the unpacked table) and ``model_insert``'s, with a
    key count that is not a multiple of a tile; on a prefilled table the
    bits already set stay."""
    projected, fpp, n_salts, sub_log2, factor, prefill = SUB_CASES[case]
    mixed = mode == "mixed"
    p = _params(rprim, projected or 200, fpp or 1e-4, mode)
    if projected is None:  # a table of exactly one sub-slice
        p.table_size = 1 << sub_log2
    if n_salts:
        p.number_of_hashes = n_salts
    rbf = rprim.BloomFilter(p)
    salts, ts = rbf.salts, rbf.table_size
    assert n_salts is None or salts.size == n_salts
    tile_keys = model_sub_tile_keys(salts.size)
    count = 3 * tile_keys + 7
    keys = _keys(count + 500, 21)
    words = np.zeros(bloom_cuda.words_for(ts), U32)
    plain = torch.zeros(ts, dtype=torch.uint8)
    tsalts = torch.from_numpy(salts.astype(np.int64))

    def insert_elsewhere(k):  # the reference's filter and the port's plain insert
        lo, hi = model_key_words(k)
        rbf.insert_u64_batch(jnp.asarray(lo), jnp.asarray(hi))
        bloom.insert_plain(plain, torch.from_numpy(lo.astype(np.int64)),
                           torch.from_numpy(hi.astype(np.int64)), tsalts, (ts,), mixed)

    if prefill:  # 500 keys first
        insert_elsewhere(keys[count:])
        model_insert(words, model_indices(keys[count:], salts, (ts,), mixed))
    direct = words.copy()
    plan = bloom_cuda.insert_plan(ts, salts.size, count, route="subslice", slice_log2=sub_log2,
                                  stash_factor=factor)
    assert plan.buckets == -(-ts // (1 << sub_log2))
    chunks = model_subslice(words, lambda a, n: keys[a:a + n], count, salts, (ts,), mixed, plan)
    assert chunks == plan.chunks
    if factor == 1:
        assert chunks >= 3 and count % plan.chunk_keys
    model_insert(direct, model_indices(keys[:count], salts, (ts,), mixed))
    assert np.array_equal(words, direct)
    insert_elsewhere(keys[:count])
    assert rbf.serialize().endswith(model_bytes(words, ts))
    assert bloom.pack_bits(plain).numpy().tobytes() == model_bytes(words, ts)


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_subslice_model_size_chain_matches_reference(mode):
    """A compressed filter's chain of three sizes, in sub-slices of the
    chain's last size (ragged): the model's table after the reference's
    own compressions is the reference's, byte for byte."""
    keys = _keys(3000, 22)
    rbf = rprim.CompressibleBloomFilter(_params(rprim, 4000, 1e-3, mode))
    mixed = mode == "mixed"
    rbf.insert_u64_batch(*(jnp.asarray(k) for k in model_key_words(keys[:1000])))
    rbf._sync_host()
    rbf.bit_table = np.array(rbf.bit_table)
    assert rbf.compress(30.0) and rbf.compress(25.0)
    sizes = tuple(rbf.size_list)
    assert len(sizes) == 3 and sizes[-1] % (1 << 10)
    words = np.zeros(bloom_cuda.words_for(sizes[-1]), U32)
    words.view(np.uint8)[:sizes[-1] // 8] = rbf.bit_table
    plan = bloom_cuda.insert_plan(sizes[-1], rbf.salts.size, 2000, route="subslice",
                                  slice_log2=10)
    model_subslice(words, lambda a, n: keys[1000 + a:1000 + a + n], 2000, rbf.salts, sizes,
                   mixed, plan)
    rbf.insert_u64_batch(*(jnp.asarray(k) for k in model_key_words(keys[1000:])))
    rbf._sync_host()
    assert model_bytes(words, sizes[-1]) == np.asarray(rbf.bit_table).tobytes()


@pytest.mark.parametrize("s,r,w,sq_radius", [
    (0xFEDCBA98, 0xFFFFFFF0, 0xBEEF, 30_001),
    (_UNSAFE.s, _UNSAFE.r, _UNSAFE.w, 173 * 173),
])
def test_subslice_chunk_starts_of_the_blinded_source(s, r, w, sq_radius):
    """The blinded source in chunks of the sub-slice route (each chunk's
    keys from start + its first key): the model's words equal the direct
    model's and the port's plain filter's ``insert_blind_distances`` over
    the whole range."""
    bl = prim.Blinding(r=r, s=s, w=w)
    bf = prim.BloomFilter(_params(prim, sq_radius, 1e-4, "mixed"), device="cpu")
    salts, ts = bf.salts, bf.table_size
    plan = bloom_cuda.insert_plan(ts, salts.size, sq_radius, route="subslice", slice_log2=12,
                                  stash_factor=1)
    assert sq_radius % plan.chunk_keys and plan.chunks >= 2

    def keys_of(first, n):
        return model_blinded_range(bl.s, bl.r, bl.w, bl.w_len, first, n)

    words = np.zeros(bloom_cuda.words_for(ts), U32)
    assert model_subslice(words, keys_of, sq_radius, salts, (ts,), True, plan) == plan.chunks
    direct = np.zeros_like(words)
    model_insert(direct, model_indices(keys_of(0, sq_radius), salts, (ts,), True))
    assert np.array_equal(words, direct)
    bf.insert_blind_distances(bl, sq_radius)
    assert bf.serialize() == bf._header_bytes() + model_bytes(words, ts)


def test_subslice_constants_are_the_kernels():
    """``bloom_cuda``'s sub-slice limits are ``bloom.cu``'s; the tile holds
    512 keys at the client/server filter's 13 salts, 204 at 40 and 64 at
    128; a scatter block's two tiles and its arrays fit one SM's shared
    memory twice, and an apply block holds the largest sub-slice."""
    assert _kernel_constant("kMaxSubBuckets") == bloom_cuda.MAX_SUB_BUCKETS
    assert (_kernel_constant("kMinSubLog"),
            _kernel_constant("kMaxSubLog")) == bloom_cuda.SUB_LOG2_RANGE
    assert bloom_cuda.SUB_LOG2_RANGE[0] <= bloom_cuda.SUB_LOG2 <= bloom_cuda.SUB_LOG2_RANGE[1]
    assert [model_sub_tile_keys(s) for s in (13, 40, 128)] == [512, 204, 64]
    scatter = 4 * (2 * SUB_TILE + 4 * bloom_cuda.MAX_SALTS + 3 * bloom_cuda.MAX_SUB_BUCKETS
                   + SUB_THREADS // 32)
    assert 2 * scatter <= 227 * 1024
    assert 4 << (bloom_cuda.SUB_LOG2_RANGE[1] - 5) <= 227 * 1024


# --- the probe's reduction and early exit ----------------------------------

def _sizes_on_the_paths() -> dict:
    """Every table size ``chip_smoke.py`` builds: the demo's at r = 4096 and
    8192 (fpp 1e-12), the client/server one (r = 4096, fpp 1e-4), config[3]'s
    (r = 99, fpp 1e-4) and a compressed chain of three sizes."""
    out = {f"r={r} fpp {f:g}": _params(prim, r * r, f, "mixed").table_size
           for r, f in ((4096, 1e-12), (8192, 1e-12), (4096, 1e-4), (99, 1e-4))}
    bf = prim.CompressibleBloomFilter(_params(prim, 200_000, 1e-4, "mixed"), device="cpu")
    assert bf.compress(30.0) and bf.compress(20.0)
    out.update({f"chain {j}": size for j, size in enumerate(bf.size_list)})
    return out


_PATH_SIZES = _sizes_on_the_paths()
_EDGE_SIZES = {"1": 1, "2": 2, "3": 3, "2^31": 1 << 31, "2^31 + 1": (1 << 31) + 1,
               "2^32 - 1": (1 << 32) - 1}


@pytest.mark.parametrize("d", list({**_EDGE_SIZES, **_PATH_SIZES}.values()),
                         ids=list({**_EDGE_SIZES, **_PATH_SIZES}))
def test_fastmod_is_the_remainder(d):
    """``fastmod`` equals Python's ``%`` at h in {0, 1, d - 1, d, 2^32 - 1}
    (those below 2^32) and 10^5 random u32s, at the edge divisors and every
    size of the main paths."""
    assert _PATH_SIZES["r=4096 fpp 1e-12"] == 964_867_048
    assert _PATH_SIZES["r=8192 fpp 1e-12"] == R8192_BITS
    assert _PATH_SIZES["r=4096 fpp 0.0001"] == 321_668_808
    assert _PATH_SIZES["r=99 fpp 0.0001"] == 187_920
    edge = [h for h in (0, 1, d - 1, d, (1 << 32) - 1) if 0 <= h < 1 << 32]
    rng = np.random.default_rng(d % 1_000_003)
    h = np.concatenate([np.asarray(edge, np.uint64),
                        rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)]).astype(U32)
    got = model_fastmod(h, model_multiplier(d), d)
    assert got.dtype == U32
    assert np.array_equal(got, (h.astype(np.uint64) % np.uint64(d)).astype(U32))
    assert [int(x) for x in got[:len(edge)]] == [x % d for x in edge]


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_fastmod_chain_matches_reference(mode):
    """``model_indices`` on the reciprocal equals the reference's
    ``_chain_indices`` on the compressed chain of three sizes that
    ``chip_smoke.py`` builds."""
    sizes = tuple(v for k, v in _PATH_SIZES.items() if k.startswith("chain"))
    assert len(sizes) == 3
    keys = _keys(4000, 11)
    salts = np.asarray(bloom._PREDEF_SALT[:13], U32)
    lo, hi = model_key_words(keys)
    want = rbloom._chain_indices(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(salts), sizes,
                                 mode == "mixed")
    assert np.array_equal(model_indices(keys, salts, sizes, mode == "mixed"), np.asarray(want))


_PROBE_CASES = {1: 0.5, 13: 0.9, 40: 0.97, 128: 0.992}  # salts: the table's density


@functools.lru_cache(maxsize=None)
def _probe_case(n_salts: int):
    """A table of 40,000 bits at the density that leaves both verdicts
    common, 1,500 keys, their indices, and the reference's verdicts."""
    rng = np.random.default_rng(n_salts)
    ts = 40_000
    bits = (rng.random(ts) < _PROBE_CASES[n_salts]).astype(np.uint8)
    words = np.zeros(bloom_cuda.words_for(ts), U32)
    words.view(np.uint8)[:ts // 8] = np.packbits(bits, bitorder="little")
    keys = _keys(1500, n_salts)
    salts = np.asarray(bloom._PREDEF_SALT[:n_salts], U32)
    idx = model_indices(keys, salts, (ts,), True)
    lo, hi = model_key_words(keys)
    want = np.asarray(rbloom._contains_fn(True)(jnp.asarray(bits), jnp.asarray(lo),
                                                jnp.asarray(hi), jnp.asarray(salts),
                                                jnp.uint32(ts)))
    return words, idx, want


@pytest.mark.parametrize("n_salts", list(_PROBE_CASES))
def test_probe_early_exit_matches_reference(n_salts):
    """The probe that stops a key at its first clear bit gives the verdicts
    of ``model_probe`` (every salt tested) and the reference's
    ``_contains_fn``, at 1, 13, 40 and 128 salts; it reads what
    ``measure_bloom.probe_reads`` counts: every salt of a present key, an
    absent key's salts up to its first clear bit."""
    words, idx, want = _probe_case(n_salts)
    got, reads = model_probe_early_exit(words, idx)
    assert np.array_equal(got, model_probe(words, idx)) and np.array_equal(got, want)
    assert 0 < got.sum() < got.size or n_salts == 1
    miss = ((words[idx >> U32(5)] >> (idx & U32(31))) & U32(1)) == 0
    first = np.where(miss.any(0), miss.argmax(0) + 1, n_salts)  # salts up to the first clear
    assert (reads[got] == n_salts).all() and np.array_equal(reads, first)
    assert probe_reads(torch.from_numpy(miss)) == int(reads.sum())


def test_probe_constants_are_the_kernels():
    """``bloom_cuda``'s stage limit is ``bloom.cu``'s, and a staged table,
    the salts and the copy's barrier fit the 48 KB of static and default
    dynamic shared memory."""
    text = bloom_cuda.SOURCE.read_text()
    stage = int(re.search(r"constexpr \w+ kStageWords = (\d+);", text).group(1))
    assert stage == bloom_cuda.STAGE_WORDS
    assert 4 * bloom_cuda.STAGE_WORDS <= 48 * 1024 - 4 * bloom_cuda.MAX_SALTS - 8
