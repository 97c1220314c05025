"""The client/server entry (``entries/client_server.py``) on the CPU: a tiny
``cs`` cell, added as files to a copy of the benchmark (``tiny.tree``,
``tiny.add_cell``), runs its server in a process of its own and its client
here, reads correct against the plain reference, fails on planted faults
and under the control, and leaves no server process behind: after a run,
after a failed set-up, and after its parent is killed."""

from __future__ import annotations

import json
import multiprocessing
import os
import signal
import subprocess
import sys
import time

import pytest

from pplp_bench import control, harness
from pplp_bench.tests import tiny

CS_CONFIG = dict(tiny.DEMO_CONFIG, entry="client_server", false_positive_probability=1e-4)
CS_MIX = dict(tiny.DEMO_MIX, loop="closed, one client, sessions back to back over one loopback "
              "TCP connection")
CELL = "cs-tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.tree(tmp_path_factory.mktemp("tiny"))
    tiny.write(root / "pplp_bench" / "configs" / "cs-tiny.json", CS_CONFIG)
    tiny.write(root / "pplp_bench" / "traffic" / "tiny-cs.json", CS_MIX)
    tiny.add_cell(root, CELL, "cs-tiny", "tiny-cs", like="cs-seal-r4096")
    return root


def run(root, trace=False, seconds=2.5, seed=tiny.SEED):
    return harness.run_cell(root, CELL, seed, seconds, trace, "cpu", time.perf_counter())


def servers_alive() -> list:
    """This process's children that ``multiprocessing`` started and that
    still run: the server and the resource tracker that spawning starts."""
    alive = [p.pid for p in multiprocessing.active_children()]
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if int(ppid) == os.getpid() and state != "Z" and b"multiprocessing" in cmd:
            alive.append(int(pid))
    return alive


def _state(pid: int) -> str | None:
    """The process's state letter (Z: a zombie, which holds nothing), or
    None when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return None


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cs_cell_agrees_with_the_reference(root, capsys, trace):
    out = run(root, trace)
    assert out["correct"], (out["checks"], out["errors"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v == 0 for v, _ in out["checks"].values())
    names = set(out["metrics"])
    if trace:
        assert {"cs.setbf_ms", "cs.send_bf_ms", "cs.recv_bf_ms", "cs.bfv_ms", "cs.dec_ms"} <= names
        assert all(out["metrics"][n]["value"] > 0 for n in names)
        # No device on the CPU: the device readers find nothing and are left out.
        assert not any(n.startswith("device.") or "roofline" in n for n in names)
        summary = json.loads(capsys.readouterr().out.split("cs server: ")[-1].splitlines()[0])
        assert summary["trace"]["units"] == 1 and summary["trace"]["routes"] == {"plain": 1}
    else:
        assert names == {"setup_s", "tests_per_s", "test_ms_p90"}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    assert not servers_alive()


def _altered_answer(monkeypatch):
    from pplp_tpu_torch.protocol.roles import ProximityClient

    decrypt = ProximityClient.receive_blind_distance

    def altered(self, blob):
        near = decrypt(self, blob)
        self.blind_distance += 1
        return near
    monkeypatch.setattr(ProximityClient, "receive_blind_distance", altered)


def _altered_frame(monkeypatch):
    from pplp_tpu_torch.protocol.transport import Channel

    recv = Channel.recv_frame_with_header

    def altered(self):
        header, payload = recv(self)
        return header, payload[:-1] + bytes([payload[-1] ^ 1])
    monkeypatch.setattr(Channel, "recv_frame_with_header", altered)


@pytest.mark.parametrize("fault,check", [(_altered_answer, "blind_distance_wrong"),
                                         (_altered_frame, "wire_wrong")],
                         ids=["answer altered", "frame altered"])
def test_cs_faults_read_not_correct(root, monkeypatch, fault, check):
    """The client's blind distance altered where it is decrypted; a byte of
    every frame the client reads altered where it comes off the socket."""
    fault(monkeypatch)
    out = run(root, seconds=1.0)
    assert not out["correct"]
    assert out["checks"][check][0] > 0
    assert not servers_alive()


def test_cs_control_reads_not_correct(root):
    """The reference's filter at the square root of the stated rate has
    another size: the frame's header and bytes catch it."""
    for seed in (3, 2**31 + 11):
        got = control.readings(root, CELL, seed, 6, "cpu")
        assert got["wire_wrong"][0] > 0, got


def test_server_is_gone_after_a_failed_set_up(root, monkeypatch):
    from pplp_tpu_torch.benchmark import sweep

    def broken(*args, **kw):
        raise ConnectionError("planted")
    monkeypatch.setattr(sweep, "run_client", broken)
    with pytest.raises(ConnectionError, match="planted"):
        run(root, seconds=1.0)
    assert not servers_alive()


def test_server_is_gone_after_its_parent_is_killed(root, tmp_path):
    code = (f"import sys, time; sys.path[:0] = [{str(tiny.REPO)!r}]\n"
            "import torch\nfrom pathlib import Path\nfrom pplp_bench import harness\n"
            f"cell = harness.resolve(Path({str(root)!r}), {CELL!r})\n"
            "session = harness.Session(cell, 5, 1.0, torch.device('cpu'), "
            "harness.Spans(torch.device('cpu')))\n"
            "state = cell.entry.set_up(session)\n"
            "print(state.server.proc.pid, flush=True)\n"
            "time.sleep(600)\n")
    parent = subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, stdout=subprocess.PIPE,
                              text=True)
    try:
        pid = int(parent.stdout.readline())
        assert _state(pid) not in (None, "Z")
    finally:
        parent.send_signal(signal.SIGKILL)
        parent.wait(60)
    deadline = time.monotonic() + 30
    while _state(pid) not in (None, "Z") and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _state(pid) in (None, "Z")
    if _state(pid) is None:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
