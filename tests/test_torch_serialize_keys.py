"""The port's key wire formats against the reference's, on the CPU.

Keys come from injected randomness (s, a, e and each gadget digit's a, e,
drawn with numpy): pk and sk through each package's own key generation,
the relinearization keys through the port's (the reference holds the same
arrays), on the tpu
chain (four primes below 2^30) and the seal chain (three 36-37-bit primes)
at n = 4096:

* ``save_public_key``, ``save_secret_key`` and ``save_kswitch_keys``
  (gadget widths 1 and 2) give the same bytes as the reference's;
* a reference blob loaded into the port gives the port's own keys, leaf for
  leaf (the NTT-domain residues, every Shoup companion, ``s_shoup`` and
  ``pk1_shoup`` included, and the gadget groups), and a port blob loaded
  into the reference gives the reference's own keys;
* a wrong magic or a blob of another context is refused by both.

Comparisons are exact.
"""

import numpy as np
import pytest
import torch

from pplp_tpu.bfv import BFVContext as RBFVContext
from pplp_tpu.bfv import EncryptionParameters as REncryptionParameters
from pplp_tpu.bfv import behz as rbehz
from pplp_tpu.bfv import serialize as rserialize
from pplp_tpu.bfv.keys import SecretKey as RSecretKey
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz, serialize
from pplp_tpu_torch.protocol import stages
from test_torch_protocol import _ref_residues, _reference_keys

N = 4096
T = 1 << 40


def _leaf(a) -> np.ndarray:
    """A reference key array (u32, or a (lo, hi) u32 pair on m62) as int64."""
    if isinstance(a, (tuple, list)):
        lo, hi = (np.asarray(x).astype(np.uint64) for x in a)
        return (lo | (hi << np.uint64(32))).view(np.int64)
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module", params=["tpu", "seal"])
def keys(request):
    """(profile, port context and keys, reference context and keys): pk,
    sk and relinearization keys at widths 1 and 2 from the same arrays."""
    profile = request.param
    parms = bfv.EncryptionParameters.bfv(N, T, profile=profile)
    ctx = bfv.BFVContext.build(parms, "cpu")
    rctx = RBFVContext.build(REncryptionParameters.bfv(N, T, profile=profile))
    assert rctx.parms.coeff_modulus == parms.coeff_modulus
    rng = np.random.default_rng(808 if profile == "tpu" else 909)
    qs = np.array(parms.coeff_modulus, dtype=np.int64)[:, None]
    s = rng.integers(-1, 2, size=N)
    e = rng.integers(-6, 7, size=N)
    a_ntt = (rng.integers(0, 1 << 62, size=(ctx.L, N)) % qs).astype(np.int64)
    res = lambda v: _ref_residues(np.asarray(v)[None, :] % qs, profile)  # noqa: E731
    sk, pk = stages.keygen_injected(ctx, s, a_ntt, e)
    rsk, rpk = _reference_keys(rctx, res(s), _ref_residues(a_ntt, profile), res(e))

    # Relinearization keys: the port's from injected digits; the reference's
    # the same arrays in its own form (its key generation is held against
    # the port's in tests/test_torch_behz*.py).
    ours, theirs = {}, {}
    for width in (1, 2):
        groups = behz._digit_groups(ctx.L, width)
        digits = [((rng.integers(0, 1 << 62, size=(ctx.L, N)) % qs).astype(np.int64),
                   rng.integers(-6, 7, size=N)[None, :] % qs) for _ in groups]
        ours[width] = behz.create_relin_keys(
            ctx, sk, None, width=width,
            inject=[(torch.from_numpy(a), torch.from_numpy(e)) for a, e in digits])
        assert ours[width].groups == groups
        theirs[width] = rbehz.KSwitchKeys(
            **{name: _ref_residues(getattr(ours[width], name).numpy(), profile)
               for name in ("k0", "k0_shoup", "k1", "k1_shoup")}, groups=groups)
    return profile, ctx, (sk, pk, ours), rctx, (rsk, rpk, theirs)


def _check_port(got, want):
    for name in vars(want):
        if name == "groups":
            assert got.groups == want.groups
        else:
            assert torch.equal(getattr(got, name), getattr(want, name)), name


def _check_reference(got, want):
    for name in vars(want):
        if name == "groups":
            assert tuple(got.groups) == tuple(want.groups)
        else:
            assert np.array_equal(_leaf(getattr(got, name)), _leaf(getattr(want, name))), name


def test_public_and_secret_keys_match_reference(keys):
    _, ctx, (sk, pk, _), rctx, (rsk, rpk, _) = keys
    # The injected keygens agree leaf for leaf.
    _check_reference(RSecretKey(*(s.numpy() for s in (sk.s_ntt, sk.s_shoup))), rsk)
    for save, load, rsave, rload, k, rk in (
        (serialize.save_public_key, serialize.load_public_key,
         rserialize.save_public_key, rserialize.load_public_key, pk, rpk),
        (serialize.save_secret_key, serialize.load_secret_key,
         rserialize.save_secret_key, rserialize.load_secret_key, sk, rsk),
    ):
        blob = save(k, ctx)
        assert blob == rsave(rk, rctx)
        _check_port(load(rsave(rk, rctx), ctx), k)
        _check_reference(rload(blob, rctx), rk)
        assert save(load(blob, ctx), ctx) == blob


@pytest.mark.parametrize("width", [1, 2])
def test_kswitch_keys_match_reference(keys, width):
    _, ctx, (_, _, ours), rctx, (_, _, theirs) = keys
    blob = serialize.save_kswitch_keys(ours[width], ctx)
    assert blob == rserialize.save_kswitch_keys(theirs[width], rctx)
    assert int.from_bytes(blob[18:20], "little") == len(ours[width].groups)
    loaded = serialize.load_kswitch_keys(blob, ctx)
    _check_port(loaded, ours[width])
    _check_reference(rserialize.load_kswitch_keys(blob, rctx), theirs[width])


def test_wrong_magic_and_context_are_refused(keys):
    profile, ctx, (sk, pk, ours), rctx, _ = keys
    other = "seal" if profile == "tpu" else "tpu"  # L = 3 against L = 4
    octx = bfv.BFVContext.build(bfv.EncryptionParameters.bfv(N, T, profile=other), "cpu")
    orctx = RBFVContext.build(REncryptionParameters.bfv(N, T, profile=other))
    blobs = {serialize.load_public_key: serialize.save_public_key(pk, ctx),
             serialize.load_secret_key: serialize.save_secret_key(sk, ctx),
             serialize.load_kswitch_keys: serialize.save_kswitch_keys(ours[2], ctx)}
    rload = {serialize.load_public_key: rserialize.load_public_key,
             serialize.load_secret_key: rserialize.load_secret_key,
             serialize.load_kswitch_keys: rserialize.load_kswitch_keys}
    for load, blob in blobs.items():
        wrong = next(b for f, b in blobs.items() if f is not load)
        with pytest.raises(ValueError, match="magic"):
            load(wrong, ctx)
        with pytest.raises(ValueError, match="context mismatch"):
            load(blob, octx)
        with pytest.raises(AssertionError, match="magic"):
            rload[load](wrong, rctx)
        with pytest.raises(AssertionError, match="context mismatch"):
            rload[load](blob, orctx)

