"""The port's proximity protocol, end to end on the CPU, against the reference.

* ``run_local_demo`` gives the clear-oracle verdict and the blind distance
  s(d^2 + r) mod t on the cases of ``tests/test_protocol.py``.
* With injected randomness (s, a, e and each message's u, e0, e1 drawn with
  numpy) the port's roles and the reference's put byte-identical messages
  on the wire: the three ciphertexts, w ‖ BF, and the blind distance; on
  both profiles. The w ‖ BF message equals the reference's streamed one.
* The CLI and ``ProtocolConfig`` defaults equal the reference's (the
  default profile is ``seal``); the seal demo runs from the CLI on the CPU.
* ``import pplp_tpu_torch`` loads neither jax nor the JAX package; without a
  card the device chooser and ``chip_smoke.py`` fail instead of falling back.
* With ``safe_blinding=False`` (the reference's full 32-bit s and r) both
  packages give the same blind distance and verdict, the reference's
  overflow quirk included.
"""

import dataclasses
import gc
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pplp_tpu.bfv import BFVContext as RBFVContext
from pplp_tpu.bfv import EncryptionParameters as REncryptionParameters
from pplp_tpu.bfv import Encryptor as REncryptor
from pplp_tpu.bfv import Plaintext as RPlaintext
from pplp_tpu.bfv.ciphertext import Ciphertext as RCiphertext
from pplp_tpu.bfv.keys import PublicKey as RPublicKey
from pplp_tpu.bfv.keys import SecretKey as RSecretKey
from pplp_tpu.bfv.keys import _shoup as rshoup
from pplp_tpu.bfv.serialize import save_ciphertext as rsave_ciphertext
from pplp_tpu.ops import ntt as rntt
from pplp_tpu.bfv.serialize import save_parms as rsave_parms
from pplp_tpu.cli import build_parser as rbuild_parser
from pplp_tpu.protocol import ProtocolConfig as RProtocolConfig
from pplp_tpu.protocol import run_local_demo as rrun_local_demo
from pplp_tpu.protocol.roles import ProximityClient as RClient
from pplp_tpu.protocol.roles import ProximityServer as RServer
from pplp_tpu.utils.hexcodec import uint64_to_hex_string
from pplp_tpu_torch import bfv, cli
from pplp_tpu_torch.bfv import behz, serialize
from pplp_tpu_torch.device import cuda_device
from pplp_tpu_torch.primitives import Blinding
from pplp_tpu_torch.protocol import ProtocolConfig, run_local_demo
from pplp_tpu_torch.protocol.roles import ProximityClient, ProximityServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(poly_modulus_degree_bits=12, plain_modulus_bits=40, profile="tpu",
             seed=1234, false_positive_probability=1e-6)


@pytest.mark.parametrize(
    "xa,ya,xb,yb,radius,expect_near",
    [
        (1234, 1212, 1000, 1000, 128, False),   # d^2 = 99700 > 128^2
        (1234, 1212, 1000, 1000, 320, True),    # d^2 = 99700 < 320^2
        (500, 500, 500, 500, 1, True),          # identical points
        (0, 0, 100, 0, 100, False),             # boundary: d^2 == r^2 -> far
        (0, 0, 100, 0, 101, True),
    ],
)
def test_demo_verdicts_match_clear_oracle(xa, ya, xb, yb, radius, expect_near):
    cfg = ProtocolConfig(xa=xa, ya=ya, xb=xb, yb=yb, radius=radius, **SMALL)
    res = run_local_demo(cfg, verbose=False, device="cpu")
    d2 = (xa - xb) ** 2 + (ya - yb) ** 2
    assert (d2 < radius * radius) == expect_near  # oracle self-check
    assert res.is_near == expect_near
    bl = Blinding.for_protocol(cfg.plain_modulus_bits, cfg.sq_radius, cfg.seed)
    assert res.blind_distance == (bl.s * (d2 + bl.r)) % cfg.plain_modulus
    assert set(res.stage_ns) == {"setParms", "kGen", "setBF", "enc", "homoCalc", "dec"}
    assert res.bf_device == torch.device("cpu")


@pytest.mark.parametrize("radius", [400, 100])
@pytest.mark.parametrize("mode", ["mixed", "reference"])
def test_unsafe_blinding_matches_reference(radius, mode):
    """``safe_blinding=False`` on the tpu profile (n = 4096, t = 2^20, seed
    7): the blinding is the seed's full 32-bit s and r, and the port gives
    the reference's blind distance s(d^2 + r) mod t and verdict. At r = 400
    both read "far" though d^2 = 99,700 is near: the server inserts keys of
    s(d^2 + r) mod 2^64 and the client probes the mod-t value, the
    reference's overflow quirk, carried over as it is."""
    kw = dict(xa=1234, ya=1212, xb=1000, yb=1000, radius=radius, profile="tpu",
              poly_modulus_degree_bits=12, plain_modulus_bits=20, seed=7,
              safe_blinding=False, bf_index_mode=mode)
    ref = rrun_local_demo(RProtocolConfig(**kw), verbose=False)
    res = run_local_demo(ProtocolConfig(**kw), verbose=False, device="cpu")
    bl = Blinding.deterministic(7)
    d2 = (1234 - 1000) ** 2 + (1212 - 1000) ** 2
    assert d2 == 99_700 and (d2 < radius * radius) is (radius == 400)
    assert res.blind_distance == ref.blind_distance == bl.s * (d2 + bl.r) % (1 << 20)
    assert res.is_near is ref.is_near is False


def _reference_keys(ctx, s_res, a_ntt, e_res):
    """The reference keygen (``protocol/jitted.py::keygen_fn``) on injected
    randomness instead of threefry draws, on either profile."""

    def f(s, a, e):
        p, q2 = ctx.prof, ctx.tables.q_b(1)
        s_ntt = rntt.forward(s, ctx.tables)
        s_shoup = rshoup(ctx, s_ntt)
        e_ntt = rntt.forward(e, ctx.tables)
        pk0 = p.neg(p.add(p.mulmod_shoup(a, s_ntt, s_shoup, q2), e_ntt, q2), q2)
        return s_ntt, s_shoup, pk0, rshoup(ctx, pk0), rshoup(ctx, a)

    s_ntt, s_shoup, pk0, pk0s, pk1s = jax.jit(f)(s_res, a_ntt, e_res)
    return (RSecretKey(s_ntt, s_shoup),
            RPublicKey(pk0_ntt=pk0, pk1_ntt=a_ntt, pk0_shoup=pk0s, pk1_shoup=pk1s))


def _ref_residues(v, profile):
    """Host residues (int64 < 2^62) -> the reference's u32 array (tpu) or
    (lo, hi) u32 pair (seal)."""
    v = np.asarray(v).astype(np.uint64)
    if profile == "tpu":
        return jnp.asarray(v.astype(np.uint32))
    return (jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def test_wire_messages_byte_identical_with_injected_randomness():
    _wire_messages_byte_identical(SMALL)


def test_seal_wire_messages_byte_identical_with_injected_randomness():
    _wire_messages_byte_identical(dict(SMALL, profile="seal"))


def _wire_messages_byte_identical(small):
    kw = dict(xa=1234, ya=1212, xb=1000, yb=1000, radius=320, **small)
    cfg, rcfg = ProtocolConfig(**kw), RProtocolConfig(**kw)
    rng = np.random.default_rng(77)
    n = cfg.poly_modulus_degree
    chain = cfg.encryption_parameters().coeff_modulus
    qs = np.array(chain, dtype=np.int64)[:, None]
    ternary = lambda: rng.integers(-1, 2, size=n)  # noqa: E731
    noise = lambda: rng.integers(-6, 7, size=n)  # noqa: E731
    s, e = ternary(), noise()
    a_ntt = (rng.integers(0, 1 << 62, size=(len(chain), n)) % qs).astype(np.int64)
    msgs = [(ternary(), noise(), noise()) for _ in range(3)]
    res = lambda v: _ref_residues(np.asarray(v)[None, :] % qs, cfg.profile)  # noqa: E731

    # Reference roles: keys and encryptions from the injected arrays.
    rclient = RClient(rcfg)
    rsk, rpk = _reference_keys(rclient.ctx, res(s), _ref_residues(a_ntt, cfg.profile),
                               res(e))
    rclient.sk = rsk
    enc = REncryptor(rclient.ctx, rpk)
    assemble = jax.jit(lambda *a: enc._assemble(*a).polys)
    values = (kw["xa"] ** 2 + kw["ya"] ** 2, kw["xa"] << 1, kw["ya"] << 1)
    rblobs = []
    for v, (u, e0, e1) in zip(values, msgs):
        lo, hi = RPlaintext(uint64_to_hex_string(v), n=n).pair_u32(n)
        polys = assemble(jnp.asarray(lo), jnp.asarray(hi), res(u), res(e0), res(e1))
        rblobs.append(rsave_ciphertext(RCiphertext(tuple(polys), "coeff"), rclient.ctx))
    rserver = RServer(rcfg)
    rserver.receive_parms(rclient.parms_message())
    rserver.build_bloom_filter()
    rserver.receive_ciphertexts(rblobs)
    rbd, rbf = rserver.blind_distance_message(), rserver.bf_message()
    rclient.receive_bf(rbf)
    r_near = rclient.receive_blind_distance(rbd)

    # The port's roles on the same arrays.
    client = ProximityClient(cfg, "cpu")
    client.keygen(inject=(s, a_ntt, e))
    blobs = client.ciphertext_messages(inject=msgs)
    server = ProximityServer(cfg, "cpu")
    server.receive_parms(client.parms_message())
    server.build_bloom_filter()
    server.receive_ciphertexts(blobs)
    bd, bf = server.blind_distance_message(), server.bf_message()
    client.receive_bf(bf)
    near = client.receive_blind_distance(bd)

    assert client.parms_message() == rclient.parms_message()
    assert blobs == rblobs
    assert bf == rbf
    assert bd == rbd
    assert near is r_near is True
    assert client.blind_distance == rclient.blind_distance


@pytest.mark.parametrize("mode", ["reference", "mixed"])
def test_bf_message_size_and_chunks_match_reference(mode):
    """The w ‖ BF message that ``send_bf`` sends: ``bf_message`` equals the
    reference server's joined ``bf_message_chunks`` (what its ``send_bf``
    streams), its ``bf_message`` and its ``bf_message_size``."""
    kw = dict(xa=1234, ya=1212, xb=1000, yb=1000, radius=40, bf_index_mode=mode, **SMALL)
    cfg, rcfg = ProtocolConfig(**kw), RProtocolConfig(**kw)
    parms = RClient(rcfg).parms_message()
    rserver, server = RServer(rcfg), ProximityServer(cfg, "cpu")
    for s in (rserver, server):
        s.receive_parms(parms)
        s.build_bloom_filter()
    want = b"".join(rserver.bf_message_chunks())
    message = server.bf_message()
    assert message == want == rserver.bf_message()
    assert len(message) == rserver.bf_message_size() == len(want)


def _servers(seed, mode="mixed"):
    """The reference's and the port's server for one configuration, each
    with its filter built: (the reference's w || BF, the port's server)."""
    kw = dict(xa=1234, ya=1212, xb=1000, yb=1000, radius=40, bf_index_mode=mode,
              **{**SMALL, "seed": seed})
    cfg, rcfg = ProtocolConfig(**kw), RProtocolConfig(**kw)
    parms = RClient(rcfg).parms_message()
    rserver, server = RServer(rcfg), ProximityServer(cfg, "cpu")
    for s in (rserver, server):
        s.receive_parms(parms)
        s.build_bloom_filter()
    return rserver.bf_message(), server


def test_bf_message_is_one_buffer_read_in_place():
    """``bf_message`` is the reference's bytes, as one read-only buffer of
    ``8 + compute_serialization_size()`` bytes: it compares with
    ``bytes`` to one ``bool``, joins and slices as bytes do; the server's
    filter and the client's read their tables in its place; a host write to
    either filter afterwards leaves it as it was."""
    want, server = _servers(1234)
    message = server.bf_message()
    assert message == want and len(message) == 8 + server.bf.compute_serialization_size()
    assert (message != want) is False and (message != want[:-1] + b"?") is True
    assert len(message) == len(want) and b"".join([message[:8], message[8:]]) == want
    assert memoryview(message)[8:] == want[8:] and message.readonly
    buf = np.frombuffer(message, np.uint8)
    assert np.shares_memory(server.bf.bit_table, buf) and not server.bf.bit_table.flags.writeable
    client = ProximityClient(ProtocolConfig(bf_index_mode="mixed", **SMALL), "cpu")
    client.receive_bf(message)
    assert np.shares_memory(client.bf.bit_table, buf) and client.bf == server.bf
    for bf in (server.bf, client.bf):
        bf.insert_u64(0x0123456789ABCDEF)
        assert bf.contains_u64(0x0123456789ABCDEF)
    assert message == want and server.bf.serialize() != want[8:]
    # A second message is written anew from the host table, the insert in it.
    again = server.bf_message()
    assert again == want[:8] + server.bf.serialize() and message == want


@pytest.mark.parametrize("dropped", [0, 1])
def test_bf_messages_alive_at_once_hold_their_own_memory(dropped):
    """Two servers' messages alive at once lie in different memory; the one
    kept equals its reference after the other server and its message are
    dropped and a third server's message is made."""
    wants, servers = zip(*(_servers(seed) for seed in (11, 12)))
    assert wants[0] != wants[1]
    messages = [s.bf_message() for s in servers]
    assert not np.shares_memory(np.frombuffer(messages[0], np.uint8),
                                np.frombuffer(messages[1], np.uint8))
    kept = 1 - dropped
    servers, messages = list(servers), list(messages)
    del servers[dropped], messages[dropped]
    gc.collect()
    third = _servers(13)[1].bf_message()
    assert messages[0] == wants[kept] and servers[0].bf_message() == wants[kept]
    assert len(third) == len(wants[kept])


def test_import_loads_no_jax():
    code = (
        "import sys, pplp_tpu_torch, pplp_tpu_torch.cli, pplp_tpu_torch.protocol, "
        "pplp_tpu_torch.ops.ntt_cuda, pplp_tpu_torch.ops.behz_cuda, "
        "pplp_tpu_torch.ops.mulmod_chain, pplp_tpu_torch.bfv.behz_fused, "
        "pplp_tpu_torch.bfv.rescale, pplp_tpu_torch.measure_multiply, "
        "pplp_tpu_torch.parallel, pplp_tpu_torch.bfv.rns_decrypt, "
        "pplp_tpu_torch.protocol.netmain, pplp_tpu_torch.protocol.transport, "
        "pplp_tpu_torch.benchmark.sweep, pplp_tpu_torch.utils.profiling, "
        "pplp_tpu_torch.utils.csvwriter, pplp_tpu_torch.dgk, pplp_tpu_torch.dgk.batched, "
        "pplp_tpu_torch.dgk.protocol, pplp_tpu_torch.ops.dgk_cuda, "
        "pplp_tpu_torch.measure_dgk, pplp_tpu_torch.bfv.keyswitch, pplp_tpu_torch.bfv.galois, "
        "pplp_tpu_torch.bfv.batch_encoder, pplp_tpu_torch.ckks, pplp_tpu_torch.ckks.netmain, "
        "pplp_tpu_torch.secure2pc, pplp_tpu_torch.secure2pc.networked, "
        "pplp_tpu_torch.secure2pc.climain, pplp_tpu_torch.secure2pc.yao, "
        "pplp_tpu_torch.parallel.mesh, pplp_tpu_torch.parallel.distributed, "
        "pplp_tpu_torch.parallel.ntt_dist, pplp_tpu_torch.parallel.behz_dist, "
        "pplp_tpu_torch.parallel.multiproc_smoke, pplp_tpu_torch.ops.bloom_cuda, "
        "pplp_tpu_torch.measure_bloom\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'pplp_tpu' or m.startswith('pplp_tpu.')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_device()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    """No card, or no repo beside it: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cli_demo_runs_on_cpu(capsys):
    assert cli.main(["demo", "--device", "cpu", "-d", "12", "-b", "40", "-r", "16",
                     "--seed", "3", "--profile", "tpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-2] == "far"


def test_cli_seal_profile_not_ported():
    """Nothing of the seal profile (the CLI's default) is left unported: the
    demo runs (``test_cli_seal_demo_matches_oracle``), and the ct x ct
    multiply, relinearization and mod switching, once refused there, run on
    the CLI's default parameters (n = 8192, t = 2^56, width-2 keys): an
    encrypted product decrypts to the negacyclic product, and a switched
    ciphertext to its plaintext under the restricted key."""
    ctx = bfv.BFVContext.build(ProtocolConfig().encryption_parameters(), "cpu")
    assert ctx.tables.profile == "m62" and (ctx.n, ctx.t) == (8192, 1 << 56)
    g = torch.Generator().manual_seed(13)
    kg = bfv.KeyGenerator(ctx, g)
    sk, pk = kg.secret_key(), kg.create_public_key()
    rlk = behz.create_relin_keys(ctx, sk, g)
    assert len(rlk.groups[0]) == 2
    rng = np.random.default_rng(56)
    a, b = (rng.integers(0, 1 << 16, size=ctx.n) for _ in range(2))
    enc, dec = bfv.Encryptor(ctx, pk), bfv.Decryptor(ctx, sk)
    ca, cb = enc.encrypt(bfv.Plaintext(a.tolist()), g), enc.encrypt(bfv.Plaintext(b.tolist()), g)
    full = np.concatenate([np.convolve(a, b), [0]])
    want = [int(v) % ctx.t for v in full[:ctx.n] - full[ctx.n:]]
    assert dec.decrypt(bfv.Evaluator(ctx).multiply_relinearize(ca, cb, rlk)).coeffs == want
    small, switched = bfv.evaluator.mod_switch_to_next(ctx, ca)
    assert small.L == ctx.L - 1
    ssk = bfv.evaluator.restrict_secret_key(small, sk)
    assert bfv.Decryptor(small, ssk).decrypt(switched).coeffs[:ctx.n] == a.tolist()


def test_defaults_match_reference():
    """The repair: the port's flags and ProtocolConfig default to the
    reference's, field for field (profile seal), on every subcommand (demo,
    client, server, tc, ts, and 2pc, whose role is required). ``--device``
    is the one flag the port adds."""
    for argv in (["demo"], ["client"], ["server"], ["tc"], ["ts"], ["2pc", "-r", "0"]):
        ref = vars(rbuild_parser().parse_args(argv))
        ours = vars(cli.build_parser().parse_args(argv))
        assert ours.pop("device") == "cuda", argv
        assert ours == ref, argv
        assert ours.get("profile", "seal") == "seal"
    assert ours["compare"] == "yao" and ours["otp_bits"] == 2048
    assert dataclasses.asdict(ProtocolConfig()) == dataclasses.asdict(RProtocolConfig())
    assert ProtocolConfig().profile == "seal"


@pytest.mark.parametrize("argv", [
    ["client", "-H", "::1", "-p", "7", "-6", "-x", "5", "-y", "6", "-r", "9", "-b", "40",
     "-d", "12", "--profile", "tpu", "--device", "cpu"],
    ["server", "-H", "0.0.0.0", "-p", "1", "-x", "0", "-y", "7", "-r", "8192"],
    ["tc", "-H", "h", "-p", "5", "-x", "1", "-y", "2", "-b", "1", "-d", "15", "--out-leg",
     "a.csv", "--out-opt", "b.csv"],
    ["ts", "-H", "10.0.0.1", "-p", "65535", "-x", "0", "-y", "1", "--out-leg", "a.csv",
     "--out-opt", "b.csv", "--profile", "tpu"],
    ["2pc", "-r", "1", "-a", "::1", "-p", "9", "--ipv6", "--circuit", "poly", "--compare",
     "open", "-x", "-5", "-y", "-77", "--radius", "32768", "--ax", "1,-2,3", "--ay=-4,5,6",
     "--otp-bits", "512", "--seed", "3", "--device", "cpu"],
], ids=lambda a: a[0])
def test_network_flags_match_reference(argv):
    """Short forms and values parse to the reference's namespace; out-of-range
    values are refused by both parsers (2pc: -r, -p and --radius)."""
    ours = vars(cli.build_parser().parse_args(argv))
    ours.pop("device")
    ref_argv = [a for a in argv if a not in ("--device", "cpu")]
    assert ours == vars(rbuild_parser().parse_args(ref_argv))
    bads = ([["-r", "2"], ["-r", "-1"], ["-r", "0", "-p", "0"], ["-r", "0", "-p", "65536"],
             ["-r", "0", "--radius", "0"], ["-r", "0", "--radius", str((1 << 15) + 1)]]
            if argv[0] == "2pc" else
            [["-p", "0"], ["-p", "65536"], ["-x", str((1 << 27) + 1)]])
    for bad in bads:
        for parser in (rbuild_parser(), cli.build_parser()):
            with pytest.raises(SystemExit):
                parser.parse_args([argv[0], *bad])


def test_cli_seal_demo_matches_oracle(capsys):
    """``demo --profile seal -d 12 -b 40`` on the CPU: the verdict is the
    clear oracle's and the blind distance s(d^2 + r) mod t, with the
    blinding ``Blinding.for_protocol`` draws for the seed."""
    for radius, near in ((320, True), (128, False)):
        assert cli.main(["demo", "--device", "cpu", "--profile", "seal", "-d", "12",
                         "-b", "40", "-r", str(radius), "--seed", "1234"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        bl = Blinding.for_protocol(40, radius * radius, 1234)
        assert lines[-2] == ("near" if near else "far")
        assert (99_700 < radius * radius) == near
        assert lines[-3] == f"blind_distance: {bl.s * (99_700 + bl.r) % (1 << 40):x}"


@pytest.mark.parametrize("n", [4096, 8192])
def test_seal_serialize_byte_identical(n):
    """Seal limbs pack to 5 (36-37-bit primes) or 6 (43-44-bit) bytes."""
    parms = bfv.EncryptionParameters.bfv(n, 1 << 56)
    ctx = bfv.BFVContext.build(parms, "cpu")
    jctx = RBFVContext.build(REncryptionParameters.bfv(n, 1 << 56))
    assert ctx.parms.coeff_modulus == jctx.parms.coeff_modulus
    assert serialize.save_parms(ctx.parms) == rsave_parms(jctx.parms)
    widths = {(m.bit_count + 7) // 8 for m in ctx.moduli}
    assert widths == ({5} if n == 4096 else {6})
    rng = np.random.default_rng(n)
    qs = np.array([m.value for m in ctx.moduli], np.uint64)[:, None]
    polys = [(rng.integers(0, 1 << 63, size=(ctx.L, n), dtype=np.uint64) % qs)
             for _ in range(2)]
    polys[0][:, :2] = qs - np.uint64(1)
    rct = RCiphertext(tuple(_ref_residues(p, "seal") for p in polys), "coeff")
    ct = bfv.Ciphertext(tuple(torch.from_numpy(p.astype(np.int64)) for p in polys))
    blob = rsave_ciphertext(rct, jctx)
    assert serialize.save_ciphertext(ct, ctx) == blob
    back = serialize.load_ciphertext(blob, ctx)
    assert all((a.numpy() == p.astype(np.int64)).all() for a, p in zip(back.polys, polys))
