"""The port's CKKS against the reference, on the CPU.

At N = 1024 on four 28-bit primes, scale 2^26, with the reference's keygen
and encryption words injected into the port:

* the encoder's integer coefficients, ``coeffs_to_rns``'s residues and the
  decoder's slots;
* ``ckks_encrypt`` from the reference's words: the same residues;
* ``ckks_multiply`` without relinearization, with special-prime keys and
  with width-1 RNS-gadget keys (the reference's carried across), then
  ``ckks_rescale``: the same residues at every step; the decrypted
  product within ``tests/test_ckks.py``'s bound (2e-2) of the clear one;
* ``ckks_decrypt``'s centred coefficients;
* the aggregation demo and the networked pair over 127.0.0.1 (port alone)
  within 1e-2 of the true sum, as ``tests/test_ckks.py`` bounds them.

Residues are compared exactly (tolerance 0). The reference's device calls
run under ``jax.jit`` in one module fixture.
"""

import socket
import threading

import jax
import numpy as np
import pytest
import torch

from pplp_tpu.bfv import keyswitch as rks
from pplp_tpu.bfv.keys import KeyGenerator as RKeyGenerator
from pplp_tpu.ckks import ckks as rckks
from pplp_tpu.ops.primes import get_primes
from pplp_tpu_torch import bfv
from pplp_tpu_torch.bfv import behz, keyswitch
from pplp_tpu_torch.ckks import ckks, netmain
from pplp_tpu_torch.ckks.demo import run_aggregation_demo
from pplp_tpu_torch.protocol.transport import connect_to_client, connect_to_server
from test_torch_keyswitch import _bits, _leaf, _same, _sp_leaves, sp_words

N = 1024
CHAIN = tuple(get_primes(28, 4, N))
SCALE = float(1 << 26)
A = np.array([1.5, -2.0, 3.25, 0.5])
B = np.array([2.0, 4.0, -1.0, 8.0])


@pytest.fixture(scope="module")
def ck():
    rctx = rckks.CKKSContext.build(n=N, scale=SCALE, coeff_modulus=CHAIN)
    ctx = ckks.CKKSContext.build(n=N, scale=SCALE, coeff_modulus=CHAIN, device="cpu")
    renc, enc = rckks.CKKSEncoder(rctx), ckks.CKKSEncoder(ctx)
    rkg = RKeyGenerator(rctx.base, 2)
    key_a, key_e = jax.random.split(rkg._key_pk)
    kg = bfv.KeyGenerator.from_bits(ctx.base, _bits(rkg._key_s, (N,)),
                                    _bits(key_a, (2, len(CHAIN), N)), _bits(key_e, (2, N)))
    rsk, rpk = rkg.secret_key(), rkg.create_public_key()
    rks.build_ctx_qp(rctx.base)  # cached outside the jit below
    ctx_qp, _ = keyswitch.build_ctx_qp(ctx.base)
    keys = {name: jax.random.key(i) for i, name in enumerate(("a", "b", "sp", "rlk"), 4)}
    ma, mb = (renc.coeffs_to_rns(renc.encode(v)) for v in (A, B))

    def reference(keys):
        ca = rckks.ckks_encrypt(rctx, rpk, ma, keys["a"])
        cb = rckks.ckks_encrypt(rctx, rpk, mb, keys["b"])
        spk = rks.create_sp_relin_keys(rctx.base, rkg, keys["sp"])
        rlk = rckks.ckks_create_relin_keys(rctx, rsk, keys["rlk"])
        return {"ca": ca.polys, "cb": cb.polys, "sp_keys": _sp_leaves(spk),
                "rlk": (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup),
                "ct3": rckks.ckks_multiply(rctx, ca, cb).polys,
                "sp": rckks.ckks_multiply(rctx, ca, cb, rlk=spk).polys,
                "gadget": rckks.ckks_multiply(rctx, ca, cb, rlk=rlk).polys}

    want = jax.jit(reference)(keys)
    rct = lambda polys: rckks.Ciphertext(tuple(polys), "coeff")  # noqa: E731
    rescaled = {}
    for kind in ("sp", "gadget"):
        rctx2, rct2 = rckks.ckks_rescale(rctx, rct(want[kind]))
        rsk2 = rckks.restrict_secret_key(rctx2, rsk)
        rescaled[kind] = (rct2.polys, rckks.ckks_decrypt(rctx2, rsk2, rct2))
    # The port's keys and encryptions from the same words.
    sk, pk = kg.secret_key(), kg.create_public_key()
    enc_words = {}
    for name in ("a", "b"):
        ku, k0, k1 = jax.random.split(keys[name], 3)
        enc_words[name] = (_bits(ku, (N,)), _bits(k0, (2, N)), _bits(k1, (2, N)))
    port_keys = {
        "sp": keyswitch.create_sp_relin_keys(ctx.base, kg, words=sp_words(keys["sp"], ctx.base,
                                                                          ctx_qp)),
        "gadget": behz.relin_keys_from_reference(ctx.base, *(_leaf(x) for x in want["rlk"]),
                                                 None),
    }
    return dict(rctx=rctx, ctx=ctx, renc=renc, enc=enc, rsk=rsk, sk=sk, pk=pk, want=want,
                rescaled=rescaled, enc_words=enc_words, port_keys=port_keys)


def _encrypt(ck, name, values):
    enc = ck["enc"]
    return ckks.ckks_encrypt_from_bits(ck["ctx"], ck["pk"], enc.coeffs_to_rns(enc.encode(values)),
                                       *ck["enc_words"][name])


def test_encoder_matches_reference(ck):
    enc, renc = ck["enc"], ck["renc"]
    rng = np.random.default_rng(1)
    z = rng.uniform(-50, 50, N // 2) + 1j * rng.uniform(-50, 50, N // 2)
    for values in (A, B, z, [0.0]):
        coeffs = enc.encode(values)
        assert np.array_equal(coeffs, renc.encode(values))
        assert np.array_equal(enc.coeffs_to_rns(coeffs).numpy(),
                              _leaf(renc.coeffs_to_rns(coeffs)))
        assert np.array_equal(enc.decode(coeffs), renc.decode(coeffs))
    batch = np.stack([enc.encode(A), enc.encode(B)])
    rows = enc.coeffs_to_rns(batch)
    assert rows.shape == (2, len(CHAIN), N)
    assert np.array_equal(rows[1].numpy(), _leaf(renc.coeffs_to_rns(batch[1])))


def test_encrypt_from_words_matches_reference(ck):
    assert _same(_encrypt(ck, "a", A), ck["want"]["ca"])
    assert _same(_encrypt(ck, "b", B), ck["want"]["cb"])


def test_sp_relin_keys_match_reference(ck):
    for got, want in zip(_sp_leaves(ck["port_keys"]["sp"]), ck["want"]["sp_keys"]):
        assert np.array_equal(got.numpy(), _leaf(want))


def test_relin_keys_are_width_1(ck):
    g = torch.Generator().manual_seed(1)
    rlk = ckks.ckks_create_relin_keys(ck["ctx"], ck["sk"], g)
    assert rlk.groups == tuple((i,) for i in range(len(CHAIN)))


@pytest.mark.parametrize("kind", ["sp", "gadget"])
def test_multiply_rescale_matches_reference(ck, kind):
    ctx = ck["ctx"]
    ca, cb = _encrypt(ck, "a", A), _encrypt(ck, "b", B)
    assert _same(ckks.ckks_multiply(ctx, ca, cb), ck["want"]["ct3"])
    prod = ckks.ckks_multiply(ctx, ca, cb, rlk=ck["port_keys"][kind])
    assert _same(prod, ck["want"][kind])
    ctx2, prod2 = ckks.ckks_rescale(ctx, prod)
    want_polys, want_coeffs = ck["rescaled"][kind]
    assert ctx2.base.L == len(CHAIN) - 1 and ctx2.scale == SCALE * SCALE / CHAIN[-1]
    assert _same(prod2, want_polys)
    coeffs = ckks.ckks_decrypt(ctx2, ckks.restrict_secret_key(ctx2, ck["sk"]), prod2)
    assert coeffs.tolist() == want_coeffs.tolist()
    got = np.real(ckks.CKKSEncoder(ctx2).decode(coeffs.astype(np.float64))[:4])
    # tests/test_ckks.py::test_ckks_multiply_rescale's bound.
    assert np.max(np.abs(got - A * B)) < 2e-2


def test_decrypt_matches_reference(ck):
    ctx, rctx = ck["ctx"], ck["rctx"]
    ca = _encrypt(ck, "a", A)
    coeffs = ckks.ckks_decrypt(ctx, ck["sk"], ca)
    rca = rckks.Ciphertext(tuple(ck["want"]["ca"]), "coeff")
    assert coeffs.tolist() == rckks.ckks_decrypt(rctx, ck["rsk"], rca).tolist()
    got = np.real(ck["enc"].decode(coeffs.astype(np.float64))[:4])
    assert np.max(np.abs(got - A)) < 1e-3  # tests/test_ckks.py's bound
    batch = bfv.Ciphertext(tuple(torch.stack([p, p]) for p in ca.polys))
    assert ckks.ckks_decrypt(ctx, ck["sk"], batch).tolist() == [coeffs.tolist()] * 2


def test_aggregation_demo():
    res = run_aggregation_demo(verbose=False, device="cpu")
    assert res.true_sum == 157.75
    assert res.abs_error < 1e-2
    values = np.random.default_rng(3).uniform(0, 120, 40).tolist()
    res = run_aggregation_demo(values, n=1024, seed=9, verbose=False, device="cpu")
    assert res.abs_error < 1e-2


def test_networked_pair():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    listener.close()
    values = np.random.default_rng(4).uniform(0, 100, 24).tolist()
    server = threading.Thread(target=lambda: netmain.run_aggregation_server(
        connect_to_client("127.0.0.1", port), len(values), device="cpu"))
    server.start()
    for _ in range(200):  # until the server listens
        try:
            chan = connect_to_server("127.0.0.1", port)
            break
        except OSError:
            threading.Event().wait(0.05)
    total = netmain.run_aggregation_keyholder(chan, values, n=1024, device="cpu")
    server.join(timeout=60)
    assert not server.is_alive()
    assert abs(total - sum(values)) < 1e-2
