"""The port's Bloom filter and blinding keys against the reference's.

Same keys (from a numpy seed, or from the same blinding values) go into
``pplp_tpu.primitives`` and ``pplp_tpu_torch.primitives``: the filters'
bit tables and ``serialize()`` bytes are identical under both index modes,
and ``blind_distance_keys`` yields identical chunks. Exact comparisons.
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
