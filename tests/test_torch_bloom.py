"""The port's Bloom filter and blinding keys against the reference's.

Same keys (from a numpy seed, or from the same blinding values) go into
``pplp_tpu.primitives`` and ``pplp_tpu_torch.primitives``: the filters'
bit tables and ``serialize()`` bytes are identical under both index modes
(after batch and host inserts, clear, set algebra, streaming, and the
compressible filter's compressions), and ``blind_distance_keys`` yields
identical chunks. Exact comparisons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu import primitives as rprim
from pplp_tpu_torch import primitives as prim
from pplp_tpu_torch.primitives.bloom import pack_bits


def _params(mod, count, fpp, mode):
    p = mod.BloomParameters(projected_element_count=count,
                            false_positive_probability=fpp,
                            random_seed=0xA5A5A5A5, index_mode=mode)
    assert p.compute_optimal_parameters()
    return p


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    lo[:2] = hi[:2] = (1 << 32) - 1
    return lo, hi


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_filter_bits_and_bytes_match_reference(mode):
    n = 6000
    lo, hi = _keys(n)
    rp, pp = _params(rprim, n, 1e-4, mode), _params(prim, n, 1e-4, mode)
    assert (pp.table_size, pp.number_of_hashes) == (rp.table_size, rp.number_of_hashes)
    rbf, bf = rprim.BloomFilter(rp), prim.BloomFilter(pp, "cpu")
    assert (bf.salts == rbf.salts).all()
    rbf.insert_u64_batch(jnp.asarray(lo.astype(np.uint32)), jnp.asarray(hi.astype(np.uint32)))
    # Two calls on the port side: inserts accumulate in place.
    half = n // 2
    bf.insert_u64_batch(torch.from_numpy(lo[:half].astype(np.int64)),
                        torch.from_numpy(hi[:half].astype(np.int64)))
    bf.insert_u64_batch(torch.from_numpy(lo[half:].astype(np.int64)),
                        torch.from_numpy(hi[half:].astype(np.int64)))
    assert bf.serialize() == rbf.serialize()
    assert (bf.bit_table == rbf.bit_table).all()

    # Membership on the host, and on the deserialized copy.
    keys = [(int(hi[i]) << 32) | int(lo[i]) for i in range(50)]
    assert all(bf.contains_u64(k) for k in keys)
    other = prim.BloomFilter.deserialize(rbf.serialize(), index_mode=mode)
    rother = rprim.BloomFilter.deserialize(rbf.serialize(), index_mode=mode)
    assert other == bf
    probes = [k ^ (1 << 63) for k in keys] + keys
    assert [other.contains_u64(k) for k in probes] == [rother.contains_u64(k) for k in probes]


def test_pack_bits_matches_numpy():
    rng = np.random.default_rng(1)
    for m in (8, 13, 1000, 4099):
        bits = rng.integers(0, 2, size=m, dtype=np.uint8)
        want = np.packbits(bits, bitorder="little")
        assert (pack_bits(torch.from_numpy(bits)).numpy() == want).all()


@pytest.mark.parametrize("sq_radius,w", [(100, 0x1), (70_000, 0xBEEF), (1 << 16, 0x7FFF)])
def test_blind_distance_keys_chunk_for_chunk(sq_radius, w):
    bl = prim.Blinding(r=0xFFFFFFF0, s=0xFEDCBA98, w=w)
    rbl = rprim.Blinding(r=bl.r, s=bl.s, w=bl.w)
    ours = list(prim.blind_distance_keys(bl, sq_radius, "cpu"))
    theirs = list(rprim.blind_distance_keys(rbl, sq_radius))
    assert len(ours) == len(theirs)
    for (klo, khi, c), (rlo, rhi, rc) in zip(ours, theirs):
        assert c == rc
        assert (klo.numpy() == np.asarray(rlo).astype(np.int64)).all()
        assert (khi.numpy() == np.asarray(rhi).astype(np.int64)).all()
    # And against the key format in Python ints.
    klo, khi, c = ours[0]
    for di in (0, 1, c - 1):
        want = prim.pack_key(bl.s * (di + bl.r), bl.w, bl.w_len)
        assert (int(khi[di]) << 32) | int(klo[di]) == want


def test_blinding_copies_match_reference():
    rsw = lambda b: (b.r, b.s, b.w)  # noqa: E731
    for seed in (0, 7, 1234):
        assert rsw(prim.Blinding.deterministic(seed)) == rsw(rprim.Blinding.deterministic(seed))
        for t_bits, r2 in ((40, 1024), (56, 4096 * 4096)):
            a = prim.Blinding.for_protocol(t_bits, r2, seed, max_s_bits=30)
            b = rprim.Blinding.for_protocol(t_bits, r2, seed, max_s_bits=30)
            assert rsw(a) == rsw(b)


def _both(cls, n, mode):
    """A reference filter and the port's from the same parameters."""
    return (getattr(rprim, cls)(_params(rprim, n, 1e-3, mode)),
            getattr(prim, cls)(_params(prim, n, 1e-3, mode), "cpu"))


def _batch_both(rbf, bf, lo, hi):
    rbf.insert_u64_batch(jnp.asarray(lo.astype(np.uint32)), jnp.asarray(hi.astype(np.uint32)))
    bf.insert_u64_batch(torch.from_numpy(lo.astype(np.int64)),
                        torch.from_numpy(hi.astype(np.int64)))
    # The reference's host table comes back from jax read-only, so its host
    # paths (insert_bytes, clear, set algebra, compress) would fail on it:
    # fetch it and hold a writable copy.
    rbf._sync_host()
    rbf.bit_table = np.array(rbf.bit_table)


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_host_inserts_clear_and_fpp_match_reference(mode):
    """insert_bytes / insert_u64 on the host after a batch insert on the
    device, effective_fpp, then clear: bytes identical at every step."""
    rbf, bf = _both("BloomFilter", 500, mode)
    lo, hi = _keys(300, seed=3)
    _batch_both(rbf, bf, lo, hi)
    for f in (rbf, bf):
        f.insert_u64(0x0123456789ABCDEF)
        f.insert_u64((1 << 64) - 1)
        for data in (b"", b"a", b"ab", b"abc", b"abcd", b"abcdefghijk", bytes(range(23))):
            f.insert_bytes(data)
    assert bf.serialize() == rbf.serialize()
    assert bf.inserted_element_count == rbf.inserted_element_count == 309
    assert bf.effective_fpp() == rbf.effective_fpp()
    assert bf.contains_bytes(b"abcdefghijk") and bf.contains_u64(0x0123456789ABCDEF)
    # A device probe after the host inserts sees them.
    assert bool(bf.contains_u64_batch(torch.tensor([0x89ABCDEF]), torch.tensor([0x01234567]))[0])
    rbf.clear()
    bf.clear()
    assert bf.serialize() == rbf.serialize()
    assert bf.effective_fpp() == rbf.effective_fpp() == 0.0
    assert not bf.bit_table.any()


@pytest.mark.parametrize("chunk", [7, 1 << 10, 16 << 20])
def test_iter_serialized_joins_to_serialize(chunk):
    """The streamed bytes equal ``serialize()`` and the reference's, with
    the table dirty on the device and again from the host copy."""
    rbf, bf = _both("BloomFilter", 2000, "mixed")
    lo, hi = _keys(1500, seed=4)
    _batch_both(rbf, bf, lo, hi)
    want = rbf.serialize()
    parts = list(bf.iter_serialized(chunk))
    assert b"".join(parts) == want
    assert all(len(p) <= max(chunk, len(parts[0])) for p in parts)
    assert b"".join(bf.iter_serialized(chunk)) == bf.serialize() == want
    assert bf.compute_serialization_size() == len(want)


def test_set_algebra_matches_reference():
    lo, hi = _keys(800, seed=5)
    filters = []
    for part in (slice(0, 500), slice(300, 800)):
        pair = _both("BloomFilter", 1000, "reference")
        _batch_both(*pair, lo[part], hi[part])
        filters.append(pair)
    (ra, a), (rb, b) = filters
    for op in ("__ior__", "__iand__", "__ixor__"):
        getattr(ra, op)(rb)
        getattr(a, op)(b)
        assert a.serialize() == ra.serialize(), op


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_compressible_filter_matches_reference(mode):
    """Inserts, two compressions (and refused ones), inserts through the
    size chain, probes, the wire bytes and a round trip."""
    rbf, bf = _both("CompressibleBloomFilter", 1000, mode)
    lo, hi = _keys(900, seed=6)
    _batch_both(rbf, bf, lo[:600], hi[:600])
    for pct in (0.0, 100.0, 150.0, -1.0, 99.9999):
        assert bf.compress(pct) is rbf.compress(pct) is False
    assert bf.compress(30.0) is rbf.compress(30.0) is True
    _batch_both(rbf, bf, lo[600:750], hi[600:750])
    assert bf.compress(25.0) is rbf.compress(25.0) is True
    _batch_both(rbf, bf, lo[750:], hi[750:])
    for f in (rbf, bf):
        f.insert_bytes(b"compressed")
    assert bf.size_list == rbf.size_list and len(bf.size_list) == 3
    wire = rbf.serialize()
    assert bf.serialize() == wire
    assert bf.compute_serialization_size() == rbf.compute_serialization_size() == len(wire)
    assert b"".join(bf.iter_serialized(100)) == wire
    keys = [(int(hi[i]) << 32) | int(lo[i]) for i in range(0, 900, 7)]
    probes = keys + [k ^ (1 << 40) for k in keys]
    got = bf.contains_u64_batch(torch.tensor([k & 0xFFFFFFFF for k in probes]),
                                torch.tensor([k >> 32 for k in probes]))
    want = rbf.contains_u64_batch(jnp.asarray([k & 0xFFFFFFFF for k in probes], jnp.uint32),
                                  jnp.asarray([k >> 32 for k in probes], jnp.uint32))
    assert got.tolist() == np.asarray(want).tolist()
    assert all(got[:len(keys)].tolist())
    assert [bf.contains_u64(k) for k in probes] == [rbf.contains_u64(k) for k in probes]
    back = prim.CompressibleBloomFilter.deserialize(wire, index_mode=mode)
    rback = rprim.CompressibleBloomFilter.deserialize(wire, index_mode=mode)
    assert back.size_list == rback.size_list
    assert back.serialize() == wire
    assert [back.contains_u64(k) for k in probes] == [rback.contains_u64(k) for k in probes]
    with pytest.raises(ValueError, match="size chain"):
        prim.CompressibleBloomFilter.deserialize(wire[:-8] + (1).to_bytes(8, "little"))
