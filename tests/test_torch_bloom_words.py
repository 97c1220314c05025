"""A numpy model of the Bloom kernels (``pplp_tpu_torch/csrc/bloom.cu``) in
u32 arithmetic, held against the reference.

The model follows the kernels step for step: a key's (lo, hi) words from
each key source (given words; the fused blinded range ((s (start + i + r)
mod 2^64) << w_len) | w; the fused blind distances (bd << w_len) | w), one
round of the AP hash per salt, fmix32 in "mixed" mode, the reduction by
each size of the chain, then word idx >> 5 and bit idx & 31 of a packed
table of ceil(table_size / 32) u32 words, whose little-endian bytes are the
wire's table. It is held against ``pplp_tpu.primitives.bloom``'s
``_indices`` / ``_chain_indices`` and the bytes of its ``_pack_bits_fn``,
against the port's plain version, and the fused key sources against
``blind_distance_keys`` (the tail chunk included) and the reference
pipeline's key formation. At r = 8192's 3,859,468,176 bits (above 2^31) it
checks indices and word indices without allocating the table. Exact
comparisons throughout; no card needed.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import primitives as rprim
from pplp_tpu.primitives import bloom as rbloom
from pplp_tpu_torch import primitives as prim
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
        h = h % U32(size)
    return h


def model_insert(words: np.ndarray, idx: np.ndarray):
    """atomicOr(&words[idx >> 5], 1 << (idx & 31)) for every index."""
    idx = idx.reshape(-1)
    np.bitwise_or.at(words, idx >> U32(5), U32(1) << (idx & U32(31)))


def model_probe(words: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Every salt's bit set (the kernel stops at the first clear one)."""
    return ((words[idx >> U32(5)] >> (idx & U32(31))) & U32(1)).astype(bool).all(axis=0)


def model_bytes(words: np.ndarray, table_size: int) -> bytes:
    assert sys.byteorder == "little"
    return words.view(np.uint8)[:table_size // 8].tobytes()


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
