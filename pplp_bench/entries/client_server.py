"""Entry module: the client/server deployment, two processes on one card
over loopback TCP (the reference's ``./tc`` + ``./ts``, opt variant).

The server is a process of its own (``multiprocessing``'s spawn), started
in ``set_up``. It binds a free port on 127.0.0.1, keeps its listener open,
and runs one ``sweep.run_server`` session (opt: parms before keygen, no
public key) for each cue on a control pipe, with the blinding the cue gives.
A unit is one ``sweep.run_client`` session in this process, over one TCP
connection kept for the run and opened again only after a failed session.
The server's stage times, its traced stretch and its peak memory come back
over the control pipe, never over the protocol's socket.

The server exits when this end of the pipe closes, and at once when its
parent dies (``PR_SET_PDEATHSIG``). Like ``run.py``, it refuses to run
where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass, field

from pplp_bench import yardstick
from pplp_bench.reference import bloom as ref_bloom
from pplp_bench.reference import frames
from pplp_bench.reference import proximity as ref
from pplp_bench.traffic import DemoTraffic, Sample

# A session drawn apart from the window's stream, to warm every shape up.
WARM_TEST = 1 << 40
HOST = "127.0.0.1"
# Seconds a wait may take: the server's start (import torch, CUDA); the warm
# session, which may build the kernels in either process; a wait of the
# window's sessions (a session takes well under a second).
START_TIMEOUT_S = 300.0
WARM_TIMEOUT_S = 900.0
TIMEOUT_S = 60.0
# The client's stages (``sweep.run_client``) and the server's
# (``sweep.run_server``), as spans of a unit.
CLIENT_STAGES = ("setParms", "sendParms", "kGen", "enc", "sendCip", "recvBF", "recvBD", "dec")
SERVER_STAGES = ("recvParms", "setParms", "setBF", "recvCips", "homoCalc", "sendBF", "sendBD")


@dataclass
class Record:
    results: dict = field(default_factory=dict)  # i -> (blind distance, near, one-coefficient flag)
    wire: dict = field(default_factory=dict)  # i -> (header, payload) of w || filter, sampled


def _config(c: dict, radius: int, **party):
    """The configuration's ``ProtocolConfig`` with one party's own values
    (coordinates, the client's key seed)."""
    from pplp_tpu_torch.protocol.config import ProtocolConfig

    return ProtocolConfig(
        radius=radius, plain_modulus_bits=c["plain_modulus_bits"],
        poly_modulus_degree_bits=c["poly_modulus_degree_bits"],
        false_positive_probability=c["false_positive_probability"], bf_seed=c["bf_seed"],
        profile=c["profile"], bf_index_mode=c["bf_index_mode"], **party)


# -- the server process -----------------------------------------------------

def _die_with(parent: int):
    """Have the kernel kill this process when its parent dies."""
    import ctypes
    import signal

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, int(signal.SIGKILL)) != 0:  # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:  # the parent died before the call
        os._exit(1)


class ServerTrace:
    """The server's traced sessions: the harness's ``Tracer`` in this
    process, started by the first session that the client cues as traced
    (the client's profiler runs from that unit on) and indexed by the
    client's units, so the two stretches hold the same sessions. The
    program's spans are recorded from the same session on. ``summary``
    gives, once the stretch is done: its sessions, the device seconds a
    session of the operations launched in ``setBF`` (``spans.credit``), the
    device's busy seconds (``Stretch.busy``) and the stretch's seconds, and
    the routes ``bloom.insert`` took."""

    def __init__(self, device, units: int):
        self.device, self.units = device, units
        self.tracer = None
        self.summary: dict | None = None

    def before(self, i: int | None, traced: bool):
        from pplp_bench.tracing import Spans, Tracer
        from pplp_tpu_torch.utils import profiling

        if traced and self.tracer is None:
            self.tracer = Tracer(Spans(self.device), True, skip=i, units=self.units)
            profiling.enable()
            self.anchor = profiling.clock_anchor()
        if self.tracer is not None and i is not None:
            self.tracer.before(i)

    def after(self, i: int | None):
        tracer = self.tracer
        if tracer is None or i is None or not tracer.pending:
            return
        prof = tracer.prof
        tracer.after(i)
        if tracer.stretch is not None:
            self._summarize(tracer.stretch, prof)

    def _summarize(self, stretch, prof):
        from torch.autograd import DeviceType

        from pplp_bench.spans import credit, device_ops, mapped
        from pplp_bench.tracing import STRETCH
        from pplp_tpu_torch.utils import profiling

        profiling.disable()
        recorded = profiling.drain()
        on_clock = mapped(recorded, self.anchor)
        events = prof.profiler.kineto_results.events()
        (t0, t1), = [(e.start_ns(), e.end_ns()) for e in events
                     if e.name() == STRETCH and e.device_type() == DeviceType.CPU]
        kernels, copies = credit(device_ops(events),
                                 [s for s in on_clock if s[2] == "setBF"], t0, t1)
        routes: dict[str, int] = {}
        for sp, (start, _, name) in zip(recorded, on_clock):
            if name == "bloom.insert" and t0 <= start <= t1:
                route = sp.attrs.get("route", "unknown")
                routes[route] = routes.get(route, 0) + 1
        self.summary = {
            "units": stretch.units,
            "setbf_device_s": (kernels.get("setBF", 0) + copies.get("setBF", 0))
            * 1e-9 / stretch.units,
            "busy_s": stretch.busy_s,
            "window_s": stretch.window_s,
            "device_ops": len(stretch.device_ops),
            "routes": routes,
        }

    def finish(self):
        """End a stretch that a failed session left open."""
        from pplp_tpu_torch.utils import profiling

        tracer = self.tracer
        if tracer is not None and tracer.prof is not None:
            tracer.prof.__exit__(None, None, None)
            tracer.prof = None
            profiling.disable()


def serve(conn, parent: int, device: str, config: dict, radius: int, trace_units: int):
    """The server process: ``("ready", port)``, then a reply to each cue
    until the pipe closes. A cue ``("session", tag, fresh, i, traced,
    timeout, xb, yb, (r, s, w))`` runs one server session for the client's
    unit ``i`` (None: the warm session), on a new connection when ``fresh``,
    and replies ``("done", tag, {stage: seconds})`` or ``("failed", tag,
    why)``; ``("summary", tag)`` replies ``("summary", tag, ...)`` with the
    traced stretch and the peak memory."""
    _die_with(parent)
    try:
        import torch

        from pplp_bench.run import forbidden_modules
        from pplp_tpu_torch.benchmark import sweep
        from pplp_tpu_torch.primitives import Blinding
        from pplp_tpu_torch.protocol import transport

        bad = forbidden_modules()
        if bad:
            raise RuntimeError(f"loaded modules of JAX or the JAX package: {', '.join(bad)}")
        dev = torch.device(device)
        listener = transport.listen(HOST, 0)
    except Exception as exc:  # reported to the parent, which raises
        conn.send(("error", f"{type(exc).__name__}: {exc}"))
        return
    conn.send(("ready", listener.getsockname()[1]))
    trace, chan = ServerTrace(dev, trace_units), None
    try:
        while True:
            try:
                cue = conn.recv()
            except EOFError:  # the parent closed the pipe or died
                break
            if cue[0] == "summary":
                trace.finish()
                peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
                conn.send(("summary", cue[1],
                           {"trace": trace.summary, "memory_peak_bytes": peak}))
                continue
            _, tag, fresh, i, traced, timeout, xb, yb, (r, s, w) = cue
            if fresh and chan is not None:
                chan.close()
                chan = None
            try:
                if chan is None:
                    chan = transport.accept(listener, timeout)
                chan.sock.settimeout(timeout)
                trace.before(i, traced)
                d = sweep.run_server(chan, _config(config, radius, xb=xb, yb=yb),
                                     recv_pk=False, device=dev, blinding=Blinding(r=r, s=s, w=w))
                trace.after(i)
            except Exception as exc:  # the session failed: drop its connection, tell the parent
                if chan is not None:
                    chan.close()
                    chan = None
                conn.send(("failed", tag, f"{type(exc).__name__}: {exc}"))
                continue
            conn.send(("done", tag, {k: getattr(d, f"d_{k}") * 1e-9 for k in SERVER_STAGES}))
    finally:
        if chan is not None:
            chan.close()
        listener.close()


class Server:
    """The server process and its control pipe."""

    def __init__(self, session):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.tags = itertools.count()
        self.proc = ctx.Process(
            target=serve, name="pplp-bench-cs-server", daemon=True,
            args=(child, os.getpid(), str(session.device), session.config,
                  int(session.mix["radius"]), int(session.mix["trace_units"])))
        self.proc.start()
        child.close()
        try:
            _, self.port = self._next(START_TIMEOUT_S)
        except BaseException:
            self.stop()
            raise

    def _next(self, timeout: float):
        if not self.conn.poll(timeout):
            raise TimeoutError(f"the server did not answer within {timeout} s")
        try:
            msg = self.conn.recv()
        except EOFError:
            raise ConnectionError(f"the server process ended (exit code {self.proc.exitcode})")
        if msg[0] == "error":
            raise RuntimeError(f"the server process failed: {msg[1]}")
        return msg

    def cue(self, *msg) -> int:
        """Send a cue; its tag, which the reply carries."""
        tag = next(self.tags)
        self.conn.send((msg[0], tag, *msg[1:]))
        return tag

    def reply(self, tag: int, timeout: float) -> tuple:
        """(kind, payload) of the reply to the cue ``tag``; late replies to
        earlier cues, whose sessions failed, are passed over."""
        deadline = time.monotonic() + timeout
        while True:
            kind, got, *rest = self._next(max(0.0, deadline - time.monotonic()))
            if got == tag:
                return kind, *rest

    def stop(self):
        """Close the pipe, which ends the server; kill it if it lingers."""
        self.conn.close()
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(30)
        _stop_resource_tracker()


def _stop_resource_tracker():
    """Spawning started ``multiprocessing``'s resource tracker, a process
    that tracks nothing here (no semaphore, no shared memory) and would
    outlive this one, unreaped where the machine's first process reaps no
    orphan. End it and reap it, as ``ResourceTracker._stop`` does (not in
    every Python 3.12); a later spawn starts it again."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if tracker._fd is not None and tracker._pid is not None:
        os.close(tracker._fd)  # the tracker ends when this end closes
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


@dataclass
class State:
    traffic: DemoTraffic
    sample: Sample
    server: Server | None = None
    chan: object = None  # the client's transport.Channel, None until (re)connected
    record: Record = field(default_factory=Record)


def run_session(session, state: State, i: int | None, test, timeout: float):
    """One session: the client here, the server on its cue -> the client's
    ``sweep.ClientSession``. The server's stage seconds and the client's go
    into the unit's spans (``server.<stage>`` and ``<stage>``)."""
    from pplp_tpu_torch.benchmark import sweep
    from pplp_tpu_torch.protocol import transport

    fresh = state.chan is None
    if fresh:
        state.chan = transport.connect_to_server(HOST, state.server.port, timeout=timeout)
    state.chan.sock.settimeout(timeout)
    tag = state.server.cue("session", fresh, i, session.spans.ranges, timeout, test.xb,
                           test.yb, (test.r, test.s, test.w))
    cfg = _config(session.config, int(session.mix["radius"]), xa=test.xa, ya=test.ya,
                  seed=test.key_seed)
    try:
        run = sweep.run_client(state.chan, cfg, send_pk=False, device=session.device)
    except Exception:
        state.chan.close()
        state.chan = None
        state.server.reply(tag, timeout)  # the server's side of the failed session
        raise
    kind, got = state.server.reply(tag, timeout)
    if kind != "done":
        state.chan.close()
        state.chan = None
        raise RuntimeError(f"the server's session failed: {got}")
    spans = session.spans.current
    for stage in CLIENT_STAGES:
        spans[stage] = getattr(run.durations, f"d_{stage}") * 1e-9
    for stage, seconds in got.items():
        spans[f"server.{stage}"] = seconds
    return run


def _state(session) -> State:
    return State(DemoTraffic(session.mix, session.config["plain_modulus_bits"], session.seed),
                 Sample(session.seed, int(session.mix["wire_check_every"])))


def set_up(session) -> State:
    # A program without these session functions fails here, before a
    # server process starts.
    from pplp_tpu_torch.benchmark.sweep import run_client, run_server  # noqa: F401

    state = _state(session)
    state.server = Server(session)
    try:
        run_session(session, state, None, state.traffic.test(WARM_TEST), WARM_TIMEOUT_S)
    except BaseException:
        if state.chan is not None:
            state.chan.close()
        state.server.stop()
        raise
    return state


def unit(session, state: State, i: int):
    run = run_session(session, state, i, state.traffic.test(i), TIMEOUT_S)
    client = run.client
    state.record.results[i] = (client.blind_distance, client.is_near, client.decrypt_consistent)
    if i in state.sample:
        state.record.wire[i] = run.bf_frame


def release(state: State) -> tuple:
    """Close the connection, take the server's summary and end the server."""
    summary = None
    if state.chan is not None:
        state.chan.close()
        state.chan = None
    if state.server is not None:
        try:
            summary = state.server.reply(state.server.cue("summary"), TIMEOUT_S)[1]
        finally:
            state.server.stop()
            state.server = None
        print("cs server: " + json.dumps(summary), flush=True)
    return state.traffic, state.record, summary


def blank_record(session, units: int) -> tuple:
    """What ``release`` gives after ``units`` sessions, with no output in
    it: a control fills it in."""
    state = _state(session)
    for i in range(units):
        state.record.results[i] = (None, None, True)
        if i in state.sample:
            state.record.wire[i] = None
    return state.traffic, state.record, None


def check(session, record, control: str | None = None) -> dict:
    """Every session's blind distance and verdict against the reference; the
    sampled sessions' w || filter frames, header included, byte for byte
    against ``reference/frames.py``. A far session that the client found
    near is held against the reference's filter, which may hold its key too
    (a false positive at the stated rate); a near one must read near.
    ``decrypt_flagged`` counts the sessions whose decrypted plaintext the
    program itself flagged as holding more than the constant coefficient.
    With ``control``, the reference's weakened copy stands where the
    program's outputs were: its filter at the square root of the stated
    rate has another size, so ``wire_wrong`` catches it."""
    traffic, rec, _ = record
    c = session.config
    t = 1 << c["plain_modulus_bits"]
    mixed = c["bf_index_mode"] == "mixed"
    fpp = c["false_positive_probability"]

    def reference(test, with_filter, control=None):
        return ref.demo_test(test, traffic.radius, t, fpp, c["bf_seed"], mixed, session.device,
                             with_filter, control=control)

    bd_wrong = near_wrong = flagged = wire_wrong = 0
    for i, (bd, near, consistent) in rec.results.items():
        test = traffic.test(i)
        sampled = i in rec.wire
        if control is not None:
            got = reference(test, sampled, control)
            bd, near, consistent = got["blind_distance"], got["near"], True
            if sampled:
                rec.wire[i] = (frames.header(len(got["wire"])), got["wire"])
        want = reference(test, sampled or (bool(near) and not test.near))
        bd_wrong += bd != want["blind_distance"]
        near_wrong += near != want["near"]
        flagged += not consistent
        if sampled:
            header, payload = rec.wire[i]
            wire_wrong += header + payload != frames.frame(want["wire"])
    return {"blind_distance_wrong": (bd_wrong, 0), "verdict_wrong": (near_wrong, 0),
            "decrypt_flagged": (flagged, 0), "wire_wrong": (wire_wrong, 0),
            "wire_unchecked": (int(not rec.wire), 0)}


def work(session, record) -> dict:
    traffic, _, summary = record
    salts, bits = ref_bloom.optimal_parameters(traffic.radius ** 2,
                                               session.config["false_positive_probability"])
    return {"per_unit": 1, "keys": traffic.radius ** 2, "salts": salts, "table_bits": bits,
            "server": summary}


def end_to_end(session, window) -> dict:
    tests = len(window.unit_s)
    return {"tests_per_s": tests / window.window_s,
            "test_ms_p90": 1e3 * yardstick.quantile(window.unit_s, 0.9)}
