"""The port's Bloom filter and blinding keys against the reference's.

Same keys (from a numpy seed, or from the same blinding values) go into
``pplp_tpu.primitives`` and ``pplp_tpu_torch.primitives``: the filters'
bit tables and ``serialize()`` bytes are identical under both index modes
(after batch and host inserts, clear, set algebra, a message's frame
filled in place, and the compressible filter's compressions), and
``blind_distance_keys`` yields identical chunks. Exact comparisons.
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
    rbf, bf = rprim.BloomFilter(rp), prim.BloomFilter(pp, device="cpu")
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
    other = prim.BloomFilter.deserialize(rbf.serialize(), index_mode=mode, device="cpu")
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
            getattr(prim, cls)(_params(prim, n, 1e-3, mode), device="cpu"))


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


@pytest.mark.parametrize("state", ["device", "host", "host_insert"])
def test_table_into_matches_serialize(state):
    """A message's frame (``frame_into``) filled by ``table_into`` and
    ``serialize()`` give the reference's bytes, with the table dirty on the
    device, current on the host, and after a host insert; the filter's host
    table then reads the message in place, read-only."""
    rbf, bf = _both("BloomFilter", 2000, "mixed")
    lo, hi = _keys(1500, seed=4)
    _batch_both(rbf, bf, lo, hi)
    if state != "device":
        bf.serialize()
    if state == "host_insert":
        for f in (rbf, bf):
            f.insert_u64(0x0123456789ABCDEF)
    want = rbf.serialize()
    message = bf.host_buffer(bf.compute_serialization_size())
    bf.table_into(bf.frame_into(message))
    assert message.tobytes() == bf.serialize() == want
    assert np.shares_memory(bf.bit_table, message) and not bf.bit_table.flags.writeable
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
    keys = [(int(hi[i]) << 32) | int(lo[i]) for i in range(0, 900, 7)]
    probes = keys + [k ^ (1 << 40) for k in keys]
    got = bf.contains_u64_batch(torch.tensor([k & 0xFFFFFFFF for k in probes]),
                                torch.tensor([k >> 32 for k in probes]))
    want = rbf.contains_u64_batch(jnp.asarray([k & 0xFFFFFFFF for k in probes], jnp.uint32),
                                  jnp.asarray([k >> 32 for k in probes], jnp.uint32))
    assert got.tolist() == np.asarray(want).tolist()
    assert all(got[:len(keys)].tolist())
    assert [bf.contains_u64(k) for k in probes] == [rbf.contains_u64(k) for k in probes]
    back = prim.CompressibleBloomFilter.deserialize(wire, index_mode=mode, device="cpu")
    rback = rprim.CompressibleBloomFilter.deserialize(wire, index_mode=mode)
    assert back.size_list == rback.size_list
    assert back.serialize() == wire
    assert [back.contains_u64(k) for k in probes] == [rback.contains_u64(k) for k in probes]
    with pytest.raises(ValueError, match="size chain"):
        prim.CompressibleBloomFilter.deserialize(wire[:-8] + (1).to_bytes(8, "little"),
                                                device="cpu")


def _message(cls, mode="mixed"):
    """A filter of ``cls`` with keys in it, and its serialized bytes as a
    writable array (the buffer a received message would be)."""
    bf = getattr(prim, cls)(_params(prim, 1000, 1e-3, mode), device="cpu")
    _batch((bf,), *_keys(600, seed=11))
    return bf, np.frombuffer(bf.serialize(), np.uint8).copy()


@pytest.mark.parametrize("cls", ["BloomFilter", "CompressibleBloomFilter"])
def test_deserialized_table_reads_the_message_in_place(cls):
    """``deserialize`` reads the table where it lies in the message
    (memoryview or bytes), read-only, and gives the serialized filter."""
    bf, message = _message(cls)
    for buf in (memoryview(message), message.tobytes()):
        got = getattr(prim, cls).deserialize(buf, "mixed", device="cpu")
        assert np.shares_memory(got.bit_table, np.frombuffer(buf, np.uint8))
        assert not got.bit_table.flags.writeable
        assert got == bf and got.serialize() == message.tobytes()


def _host_write(op):
    """The host write ``op`` as a function of a filter, on a second filter
    for the set operators."""
    if op == "insert_bytes":
        return lambda f: f.insert_bytes(b"written after deserialize")
    if op == "compress":
        return lambda f: f.compress(30.0)
    other = prim.BloomFilter(_params(prim, 1000, 1e-3, "mixed"), device="cpu")
    _batch((other,), *_keys(600, seed=12))
    return lambda f: getattr(f, op)(other)


@pytest.mark.parametrize("cls,op", [
    *((c, op) for c in ("BloomFilter", "CompressibleBloomFilter")
      for op in ("insert_bytes", "__ior__", "__iand__", "__ixor__")),
    ("CompressibleBloomFilter", "compress")])
def test_host_write_after_deserialize_leaves_the_message(cls, op):
    """A host write to a filter that reads its table in a message copies it
    first: the message stays byte for byte, and the filter equals one
    deserialized from a bytes copy, and the filter it was serialized from,
    after the same write."""
    bf, message = _message(cls)
    before = message.copy()
    write = _host_write(op)
    in_place = getattr(prim, cls).deserialize(memoryview(message), "mixed", device="cpu")
    copied = getattr(prim, cls).deserialize(before.tobytes(), "mixed", device="cpu")
    for f in (in_place, copied, bf):
        write(f)
    assert np.array_equal(message, before)
    assert in_place.serialize() == copied.serialize() == bf.serialize() != before.tobytes()


@pytest.mark.parametrize("cls", ["BloomFilter", "CompressibleBloomFilter"])
def test_filter_takes_no_default_device(cls):
    """The device is a required keyword: a filter never lands on the CPU
    because its caller named no device."""
    params = _params(prim, 100, 1e-3, "mixed")
    with pytest.raises(TypeError):
        getattr(prim, cls)(params)
    with pytest.raises(TypeError):
        getattr(prim, cls)(params, "cpu")
    wire = getattr(prim, cls)(params, device="cpu").serialize()
    with pytest.raises(TypeError):
        getattr(prim, cls).deserialize(wire, "mixed")
    assert getattr(prim, cls).deserialize(wire, "mixed", device="cpu").serialize() == wire


# --- The word table (a packed filter) against the plain version ----------
# On the card a filter keeps u32 words; on the CPU ``packed=True`` keeps the
# same words and runs the plain version on them, so the word-table methods
# (serialize, deserialize, the set operators, clear, compress) are held
# here against the unpacked plain filter.

def _pair(cls, n, mode, fpp=1e-3):
    p = _params(prim, n, fpp, mode)
    return (getattr(prim, cls)(p, device="cpu", packed=True),
            getattr(prim, cls)(p, device="cpu"))


def _batch(filters, lo, hi):
    for f in filters:
        f.insert_u64_batch(torch.from_numpy(lo.astype(np.int64)),
                           torch.from_numpy(hi.astype(np.int64)))


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_word_table_matches_plain(mode):
    """Batch inserts, the blinded range, host inserts, probes, serialize
    and a deserialized copy: the packed filter's words give the plain
    filter's bytes and verdicts at every step."""
    packed, plain = _pair("BloomFilter", 3000, mode)
    assert packed.bits_device.dtype == torch.int32 and plain.bits_device.dtype == torch.uint8
    assert packed.bits_device.numel() == (packed.table_size + 31) // 32
    lo, hi = _keys(1500, seed=7)
    _batch((packed, plain), lo, hi)
    bl = prim.Blinding(r=0xFFFFFF00, s=0x89ABCDEF, w=0x1F)
    for f in (packed, plain):
        f.insert_blind_distances(bl, 1000)
    assert packed.inserted_element_count == plain.inserted_element_count == 2500
    assert packed.serialize() == plain.serialize()
    for f in (packed, plain):
        f.insert_u64(0x0123456789ABCDEF)
        f.insert_bytes(b"abc")
    assert packed.serialize() == plain.serialize()
    probes = _keys(2000, seed=8)
    probe_lo = torch.from_numpy(np.concatenate([lo[:500], probes[0]]).astype(np.int64))
    probe_hi = torch.from_numpy(np.concatenate([hi[:500], probes[1]]).astype(np.int64))
    got = packed.contains_u64_batch(probe_lo, probe_hi)
    assert torch.equal(got, plain.contains_u64_batch(probe_lo, probe_hi)) and bool(got[:500].all())
    assert bool(packed.contains_u64_batch(torch.tensor([0x89ABCDEF]), torch.tensor([0x01234567])))
    back = prim.BloomFilter.deserialize(plain.serialize(), mode, device="cpu", packed=True)
    assert back.packed and back == plain
    assert torch.equal(back.contains_u64_batch(probe_lo, probe_hi), got)
    packed.clear()
    plain.clear()
    assert packed.serialize() == plain.serialize() and not packed.bits_device.any()


def test_word_table_set_algebra_matches_plain():
    """|=, &=, ^= on words (both packed, and a packed filter with an
    unpacked one) against the plain filters' host bytes."""
    lo, hi = _keys(800, seed=9)
    (pa, a), (pb, b) = _pair("BloomFilter", 1000, "mixed"), _pair("BloomFilter", 1000, "mixed")
    _batch((pa, a), lo[:500], hi[:500])
    _batch((pb, b), lo[300:], hi[300:])
    for op in ("__ior__", "__iand__", "__ixor__"):
        want = getattr(prim.BloomFilter.deserialize(a.serialize(), "mixed", device="cpu"), op)(b)
        for other in (pb, b):
            got = prim.BloomFilter.deserialize(a.serialize(), "mixed", device="cpu", packed=True)
            got = getattr(got, op)(other)
            assert got.serialize() == want.serialize(), op
        assert getattr(pa, op)(pb) is pa
        getattr(a, op)(b)
        assert pa.serialize() == a.serialize(), op


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_word_table_compress_matches_plain(mode):
    """A compressible filter on words: compress folds on the host and
    reloads the words at the new size; inserts through the size chain, the
    wire bytes and the probe equal the plain filter's."""
    packed, plain = _pair("CompressibleBloomFilter", 1000, mode)
    lo, hi = _keys(900, seed=10)
    _batch((packed, plain), lo[:600], hi[:600])
    assert packed.compress(30.0) is plain.compress(30.0) is True
    assert packed.bits_device.numel() == (packed.table_size + 31) // 32
    _batch((packed, plain), lo[600:], hi[600:])
    assert packed.compress(25.0) is plain.compress(25.0) is True
    assert packed.size_list == plain.size_list and len(packed.size_list) == 3
    assert packed.serialize() == plain.serialize()
    klo, khi = torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64))
    got = packed.contains_u64_batch(klo, khi)
    assert torch.equal(got, plain.contains_u64_batch(klo, khi)) and bool(got.all())


def test_device_paths_refuse_a_table_they_cannot_run():
    """The dispatchers run the plain version only on a CPU table, and the
    kernel wrappers only on CUDA tensors; a CPU filter may be unpacked, a
    CUDA one may not."""
    from pplp_tpu_torch.ops import bloom_cuda
    from pplp_tpu_torch.primitives import bloom

    keys = (torch.zeros(4, dtype=torch.int64),) * 2
    salts = torch.ones(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="no Bloom filter path"):
        bloom.probe(torch.zeros(64, dtype=torch.uint8, device="meta"), salts, 64, True, keys=keys)
    with pytest.raises(ValueError, match="no Bloom filter path"):
        bloom.insert(torch.zeros(2, dtype=torch.int32, device="meta"), salts, 64, True, keys=keys)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.insert_cuda(torch.zeros(2, dtype=torch.int32), salts, (64,), True, keys=keys)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.probe_cuda(torch.zeros(2, dtype=torch.int32), salts, (64,), True, keys=keys)
    assert not prim.BloomFilter(_params(prim, 100, 1e-3, "mixed"), device="cpu").packed


def test_insert_plan_routes_and_refusals():
    """``bloom_cuda.insert_plan``: the direct kernel for a small table
    (config[3]'s), the sub-slice route for the client/server filter's
    40.2 MB, the partitioned kernels above DIRECT_MAX_BITS (the demo's
    r = 4096 and 8192: 23 chunks whose stash and histograms fit in the
    table's words, at most MAX_BUCKETS buckets); it raises on what the
    kernels do not take, and the step wrappers refuse CPU tensors."""
    from pplp_tpu_torch.ops import bloom_cuda

    def plan(r, fpp, **kw):
        p = _params(prim, r * r, fpp, "mixed")
        return bloom_cuda.insert_plan(p.table_size, p.number_of_hashes, r * r, **kw)

    assert plan(99, 1e-4).launches() == {"bf_insert": 1}
    cs = plan(4096, 1e-4)
    assert cs.route == "subslice" and cs.table_size == 321_668_808 <= bloom_cuda.DIRECT_MAX_BITS
    for r, buckets in ((4096, 8), (8192, 29)):
        p = plan(r, 1e-12)
        assert p.route == "partitioned" and (p.buckets, p.chunks, p.tile_keys) == (buckets, 23, 256)
        assert p.launches() == dict.fromkeys(("bf_insert_count", "bf_insert_scatter",
                                              "bf_insert_apply"), 23)
        words = bloom_cuda.words_for(p.table_size)
        assert p.chunk_keys * (p.n_salts + 1) <= words and p.chunk_keys % p.tile_keys == 0
    assert plan(4096, 1e-4, route="partitioned").buckets == 3
    assert bloom_cuda.insert_plan(1 << 20, 128, 5, route="partitioned",
                                  slice_log2=16).tile_keys == 80
    with pytest.raises(ValueError, match="buckets"):
        plan(8192, 1e-12, slice_log2=26)
    with pytest.raises(ValueError, match="slice"):
        plan(4096, 1e-12, slice_log2=4)
    with pytest.raises(ValueError, match="no stash"):
        bloom_cuda.insert_plan(100_000, 40, 10, route="partitioned", slice_log2=12)
    with pytest.raises(ValueError, match="salts"):
        bloom_cuda.insert_plan(100_000, 129, 10)
    with pytest.raises(ValueError, match="route"):
        bloom_cuda.insert_plan(100_000, 13, 10, route="sorted")
    p = bloom_cuda.insert_plan(1 << 20, 13, 5000, route="partitioned", slice_log2=16)
    words = torch.zeros(bloom_cuda.words_for(p.table_size), dtype=torch.int32)
    salts = torch.ones(p.n_salts, dtype=torch.int64)
    stash, hist, counts = bloom_cuda.partition_buffers(p, "cpu")
    assert stash.numel() + hist.numel() <= words.numel() and counts.shape == (3, 32)
    blinded = (3, 5, 1, 1, 0, p.chunk_keys)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.count_cuda(words, salts, (p.table_size,), True, p, hist, counts[0],
                              blinded=blinded)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.scatter_cuda(words, salts, (p.table_size,), True, p, hist, counts[0], stash,
                                blinded=blinded)
    with pytest.raises(ValueError, match="CUDA"):
        bloom_cuda.apply_cuda(words, stash, 4)


@pytest.mark.parametrize("r,fpp,route", [(99, 1e-4, "direct"), (128, 1e-12, "direct"),
                                         (2048, 1e-4, "direct"), (4096, 1e-4, "subslice"),
                                         (2048, 1e-12, "subslice"),
                                         (4096, 1e-12, "partitioned")])
def test_insert_route_of_the_main_paths(r, fpp, route):
    """``route_of`` by the measured thresholds: the direct kernel below
    SUBSLICE_MIN_BITS (config[3]'s 187,920 bits, the demo's r = 128, the
    sweep's r = 2048 at 10.1 MB), the sub-slice route from there to
    DIRECT_MAX_BITS (the client/server filter, the demo's r = 2048 at
    30.2 MB), the partitioned one above; and ``insert_plan`` takes it."""
    from pplp_tpu_torch.ops import bloom_cuda

    p = _params(prim, r * r, fpp, "mixed")
    assert bloom_cuda.route_of(p.table_size, p.number_of_hashes, r * r) == route
    assert bloom_cuda.insert_plan(p.table_size, p.number_of_hashes, r * r).route == route
    assert (route == "direct") == (p.table_size < bloom_cuda.SUBSLICE_MIN_BITS)


def test_insert_plan_subslice_route():
    """The sub-slice plan: 614 buckets of 2^19 bits and 6 chunks at the
    client/server filter, a chunk's stash within STASH_FACTOR times the
    table's words (the last chunk ragged), one launch of each kernel a
    chunk; at the thresholds' edges the route falls to the direct kernel
    (a table below SUBSLICE_MIN_BITS, fewer than SUBSLICE_MIN_FILL indices
    a word); forced, it raises on a table without a whole sub-slice, on
    more than MAX_SUB_BUCKETS buckets, on sub-slices outside 2^7..2^20, on
    a stash below the table's words or too small for a key; its buffers
    and step wrappers refuse CPU tensors."""
    from pplp_tpu_torch.ops import bloom_cuda

    bits, keys = 321_668_808, 4096 * 4096
    cs = bloom_cuda.insert_plan(bits, 13, keys)
    words = bloom_cuda.words_for(bits)
    assert (cs.route, cs.slice_log2, cs.buckets, cs.chunks) == ("subslice", 19, 614, 6)
    assert bloom_cuda.SUB_LOG2 == 19 and bloom_cuda.STASH_FACTOR == 3.75
    assert cs.chunk_keys * 13 <= bloom_cuda.STASH_FACTOR * words < (cs.chunk_keys + 1) * 13
    # The stash in the allocator's 2 MiB blocks and the counts: within four
    # tables; no cap within four tables gives fewer chunks.
    stash, counts = 4 * cs.chunk_keys * 13, 4 * 3 * cs.buckets * cs.chunks
    assert -(-stash // (2 << 20)) * (2 << 20) + counts <= 4 * 4 * words
    assert -(-keys // (4 * words // 13)) == cs.chunks
    assert keys % cs.chunk_keys and cs.launches() == dict.fromkeys(
        ("bf_insert_sub_count", "bf_insert_sub_scatter", "bf_insert_sub_apply"), 6)
    for factor, chunks in ((1, 22), (2, 11)):
        p = bloom_cuda.insert_plan(bits, 13, keys, route="subslice", stash_factor=factor)
        assert p.chunks == chunks and p.chunk_keys * 13 <= factor * words
    assert bloom_cuda.insert_plan(bits, 13, keys, route="subslice", slice_log2=20).buckets == 307
    assert bloom_cuda.insert_plan(bits, 13, 0, route="subslice").launches() == dict.fromkeys(
        bloom_cuda.ROUTE_KERNELS["subslice"], 0)
    edge = bloom_cuda.SUBSLICE_MIN_BITS
    full = -(-bloom_cuda.SUBSLICE_MIN_FILL * bloom_cuda.words_for(edge) // 13)
    assert bloom_cuda.route_of(edge, 13, full) == "subslice"
    assert bloom_cuda.route_of(edge, 13, full - 1) == "direct"
    exact = bloom_cuda.SUBSLICE_MIN_FILL * bloom_cuda.words_for(edge)  # one salt
    assert bloom_cuda.route_of(edge, 1, exact) == "subslice"
    assert bloom_cuda.route_of(edge, 1, exact - 1) == "direct"
    assert bloom_cuda.route_of(edge - 1, 13, 10 * full) == "direct"
    assert bloom_cuda.route_of(bloom_cuda.DIRECT_MAX_BITS + 1, 13, 10 * full) == "partitioned"
    with pytest.raises(ValueError, match="whole sub-slice"):
        bloom_cuda.insert_plan((1 << 19) - 1, 13, 10, route="subslice")
    with pytest.raises(ValueError, match="buckets"):
        bloom_cuda.insert_plan(bits, 13, 10, route="subslice", slice_log2=18)
    for log2 in (6, 21):
        with pytest.raises(ValueError, match="sub-slice of"):
            bloom_cuda.insert_plan(bits, 13, 10, route="subslice", slice_log2=log2)
    with pytest.raises(ValueError, match="stash"):
        bloom_cuda.insert_plan(bits, 13, 10, route="subslice", stash_factor=0)
    with pytest.raises(ValueError, match="no stash"):
        bloom_cuda.insert_plan(128, 128, 10, route="subslice", slice_log2=7, stash_factor=1)
    p = bloom_cuda.insert_plan(1 << 20, 13, 5000, route="subslice", slice_log2=16)
    table = torch.zeros(bloom_cuda.words_for(p.table_size), dtype=torch.int32)
    salts = torch.ones(13, dtype=torch.int64)
    stash, counts = bloom_cuda.subslice_buffers(p, "cpu")
    assert stash.numel() == p.chunk_keys * 13 <= bloom_cuda.STASH_FACTOR * table.numel()
    assert counts.shape == (p.chunks, 3 * 16) and not counts.any()
    blinded = (3, 5, 1, 1, 0, p.chunk_keys)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.insert_subslice(table, salts, (p.table_size,), True, blinded=blinded)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.sub_count_cuda(table, salts, (p.table_size,), True, p, counts[0],
                                  blinded=blinded)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.sub_scatter_cuda(table, salts, (p.table_size,), True, p, counts[0], stash,
                                    blinded=blinded)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bloom_cuda.sub_apply_cuda(table, salts, (p.table_size,), p, counts[0], stash)


def test_chain_is_checked_once_a_size_list():
    """``bloom_cuda.chain_array``: one read-only u32 array a size list, made
    and checked on its first use and shared after; a compressed filter's
    new list is a new array; bad lists raise every time."""
    from pplp_tpu_torch.ops import bloom_cuda

    bf = prim.CompressibleBloomFilter(_params(prim, 5000, 1e-3, "mixed"), device="cpu",
                                      packed=True)
    before = bloom_cuda.chain_array(bf._sizes())
    assert before is bloom_cuda.chain_array(bf._sizes()) and not before.flags.writeable
    assert before.dtype == np.uint32 and before.tolist() == [bf.table_size]
    assert bf.compress(40.0)
    after = bloom_cuda.chain_array(bf._sizes())
    assert after is not before and after.tolist() == bf.size_list and len(after) == 2
    for bad in ((), (0,), (1 << 32,), (5,) * (bloom_cuda.MAX_SIZES + 1)):
        for _ in range(2):
            with pytest.raises(ValueError):
                bloom_cuda.chain_array(bad)
