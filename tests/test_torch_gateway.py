"""The port's gateway on the CPU: the volunteer protocol over a real
loopback socket (native TCP framing and RFC 6455 WebSocket), its framing
faults, its socket timeouts, real PyTorch applies behind the socket, the CLI
server in a subprocess, snapshots, the op log, and the browser client.

Every socket, thread join and subprocess wait here has its own timeout; a
test that runs into one fails rather than waits.
"""
from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

from repro.core import elastic as jelastic
from repro_torch.configs.paper_lstm import TrainParams
from repro_torch.core import browser as browser_mod
from repro_torch.core import gateway
from repro_torch.core import wsframing as wf
from repro_torch.core.browser import BrowserClient
from repro_torch.core.elastic import OpLog, durable_fingerprint
from repro_torch.core.gateway import (GatewayServer, SocketTransport,
                                      WsClientTransport, _recv_frame,
                                      _send_frame, replay_oplog,
                                      run_volunteer, same_bits)
from repro_torch.core.mapreduce import (TrainingProblem, sequential_async,
                                        sequential_local)
from repro_torch.core.protocol import (FetchModel, Hello, LatestReq,
                                       MapWork, VolunteerSession,
                                       decode_message, encode_message)
from repro_torch.core.simulator import SyntheticProblem
from repro_torch.core.transport import InProcessTransport
from repro_torch.data.text import synthetic_corpus

N_VERSIONS, N_MB = 3, 4
N_TASKS = N_VERSIONS * (N_MB + 1)
JOIN = 60.0            # seconds any volunteer thread may take
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem():
    return SyntheticProblem(n_versions=N_VERSIONS, n_mb=N_MB)


@pytest.fixture
def server():
    s = GatewayServer(_problem(), n_versions=N_VERSIONS)
    s.start()
    yield s
    s.close()


def _join(threads, timeout=JOIN):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "volunteer thread did not finish in time"


def _volunteers(server, specs, **kw):
    """Run one volunteer thread per (vid, transport class); return
    {vid: (final_version, tasks)}."""
    results, errors = {}, []

    def worker(vid, cls):
        try:
            tr = cls("127.0.0.1", server.port, vid)
            try:
                results[vid] = run_volunteer(tr, vid, **kw)
            finally:
                tr.close()
        except Exception as e:              # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=spec, daemon=True)
               for spec in specs]
    for t in threads:
        t.start()
    _join(threads)
    assert not errors, errors
    return results


# ---------------------------------------------------------------------------
# transport and dialect
# ---------------------------------------------------------------------------

def test_single_volunteer_over_socket(server):
    transport = SocketTransport("127.0.0.1", server.port, "sock0")
    final, tasks = run_volunteer(transport, "sock0", N_VERSIONS)
    transport.close()
    assert (final, tasks) == (N_VERSIONS, N_TASKS)
    assert transport.bytes_moved > 0
    assert server.ds.latest_version == N_VERSIONS and server.done.is_set()


def test_socket_run_matches_inprocess_run(server):
    ref_server = GatewayServer(_problem(), n_versions=N_VERSIONS)
    ref = run_volunteer(InProcessTransport(ref_server.endpoint), "ref",
                        N_VERSIONS)
    ref_server.close()
    transport = SocketTransport("127.0.0.1", server.port, "sock0")
    out = run_volunteer(transport, "sock0", N_VERSIONS)
    transport.close()
    assert out == ref == (N_VERSIONS, N_TASKS)


def test_two_volunteers_share_the_run(server):
    results = _volunteers(server, [(f"gw{i}", SocketTransport)
                                   for i in range(2)], n_updates=N_VERSIONS)
    assert [results[v][0] for v in sorted(results)] == [N_VERSIONS] * 2
    assert sum(r[1] for r in results.values()) == N_TASKS


def test_ws_volunteer_matches_tcp_run(server):
    ref_server = GatewayServer(_problem(), n_versions=N_VERSIONS)
    ref_server.start()
    try:
        ref = _volunteers(ref_server, [("tcp0", SocketTransport)],
                          n_updates=N_VERSIONS)["tcp0"]
    finally:
        ref_server.close()
    out = _volunteers(server, [("ws0", WsClientTransport)],
                      n_updates=N_VERSIONS)["ws0"]
    assert out == ref == (N_VERSIONS, N_TASKS)


def test_ws_and_tcp_volunteers_share_one_run(server):
    results = _volunteers(server, [("ws0", WsClientTransport),
                                   ("tcp0", SocketTransport)],
                          n_updates=N_VERSIONS)
    assert [results[v][0] for v in sorted(results)] == [N_VERSIONS] * 2
    assert sum(r[1] for r in results.values()) == N_TASKS


def test_barrierless_policy_over_socket_uses_server_applier():
    s = GatewayServer(_problem(), n_versions=N_VERSIONS, policy="staleness:1")
    s.start()
    try:
        transport = SocketTransport("127.0.0.1", s.port, "thin0")
        final, tasks = run_volunteer(transport, "thin0", s.n_updates,
                                     policy="staleness:1")
        sent = dict(transport.sent)
        transport.close()
        assert final == tasks == s.n_updates == N_VERSIONS * N_MB
        assert sent.get("SubmitUpdate") == s.n_updates
        assert "PublishModel" not in sent
        assert s.endpoint.applier.applied == s.n_updates
    finally:
        s.close()


# ---------------------------------------------------------------------------
# framing faults
# ---------------------------------------------------------------------------

def test_non_ws_http_request_is_rejected_cleanly(server):
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    sock.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            break
        data += chunk
    sock.close()
    assert data.startswith(b"HTTP/1.1 400")
    tr = SocketTransport("127.0.0.1", server.port, "after400")
    assert run_volunteer(tr, "after400", N_VERSIONS) == (N_VERSIONS, N_TASKS)
    tr.close()


def test_oversize_length_prefix_closes_connection_server_side(server):
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    _send_frame(sock, Hello("big0"))
    assert _recv_frame(sock) is not None
    sock.sendall(struct.pack(">I", gateway.MAX_FRAME + 1))
    assert sock.recv(4096) == b""                 # server closed on us
    sock.close()
    tr = SocketTransport("127.0.0.1", server.port, "afterbig")
    assert run_volunteer(tr, "afterbig", N_VERSIONS) == (N_VERSIONS, N_TASKS)
    tr.close()


def test_oversize_length_prefix_closes_connection_client_side():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(10)
    port = lsock.getsockname()[1]

    def fake_server():
        conn, _ = lsock.accept()
        conn.settimeout(10)
        conn.recv(1 << 16)                        # swallow the Hello frame
        conn.sendall(struct.pack(">I", gateway.MAX_FRAME + 1) + b"junk")
        try:
            conn.recv(1)                          # hold open until client acts
        except OSError:
            pass
        conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    with pytest.raises(ConnectionError):
        SocketTransport("127.0.0.1", port, "dupe0", connect_timeout=5)
    _join([t], 15)
    lsock.close()


def _watch_disconnects(server, monkeypatch):
    monkeypatch.setattr(gateway, "FRAME_STALL_TIMEOUT", 0.3)
    dropped = []
    orig = server.endpoint.disconnect
    monkeypatch.setattr(server.endpoint, "disconnect",
                        lambda c: (dropped.append(c), orig(c))[1])
    return dropped


def _wait_for(cond, what, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_mid_frame_stall_tears_down_via_endpoint_disconnect(
        server, monkeypatch):
    dropped = _watch_disconnects(server, monkeypatch)
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    _send_frame(sock, Hello("stall0"))
    assert _recv_frame(sock) is not None
    sock.sendall(struct.pack(">I", 64))           # header, then... nothing
    _wait_for(lambda: "stall0" in dropped,
              "server never disconnected the mid-frame staller")
    assert sock.recv(4096) == b""
    sock.close()


def test_volunteer_killed_between_header_and_body(server, monkeypatch):
    dropped = _watch_disconnects(server, monkeypatch)
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    _send_frame(sock, Hello("corpse0"))
    assert _recv_frame(sock) is not None
    sock.sendall(struct.pack(">I", 64))           # header only...
    sock.close()                                  # ...then the tab closes
    _wait_for(lambda: "corpse0" in dropped,
              "server never disconnected the dead half-frame client")


def _dribble(sock, data: bytes, chunk: int = 1) -> None:
    for i in range(0, len(data), chunk):
        sock.sendall(data[i:i + chunk])
        time.sleep(0.001)


def test_torn_tcp_writes_reassemble_cleanly(server):
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    body = encode_message(Hello("torn0"))
    _dribble(sock, struct.pack(">I", len(body)) + body)
    assert _recv_frame(sock) is not None          # one intact dispatch
    body2 = encode_message(LatestReq())
    frame2 = struct.pack(">I", len(body2)) + body2
    sock.sendall(frame2[:len(frame2) // 2])
    sock.settimeout(0.5)
    with pytest.raises(socket.timeout):
        sock.recv(4096)                           # half a frame, no dispatch
    sock.settimeout(5)
    sock.sendall(frame2[len(frame2) // 2:])
    reply = _recv_frame(sock)
    assert reply is not None and reply.version == 0
    sock.close()


def test_torn_ws_writes_reassemble_cleanly(server):
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    request, key = wf.client_handshake_request(f"127.0.0.1:{server.port}")
    _dribble(sock, request, chunk=3)
    handshake = wf.ClientHandshake(key)
    while not handshake.done:
        handshake.feed(sock.recv(4096))
    framer = wf.client_framer()
    if handshake.leftover:
        framer.feed(handshake.leftover)
    wire = framer.send_message(encode_message(Hello("wstorn0")),
                               fragment_size=5)
    _dribble(sock, wire)
    events = []
    while not events:
        events = framer.feed(sock.recv(4096))
    assert len(events) == 1 and isinstance(events[0], wf.Message)
    assert decode_message(events[0].data) is not None
    sock.close()


# ---------------------------------------------------------------------------
# socket timeouts: every read bounded, every scoped timeout restored
# ---------------------------------------------------------------------------

def test_sock_timeout_restored_when_exception_escapes():
    a, b = socket.socketpair()
    try:
        a.settimeout(7.5)
        with pytest.raises(RuntimeError):
            with gateway._sock_timeout(a, 0.01):
                assert a.gettimeout() == 0.01
                raise RuntimeError("injected fault mid-section")
        assert a.gettimeout() == 7.5
        with gateway._sock_timeout(a, 1.0):
            with gateway._sock_timeout(a, 2.0):
                assert a.gettimeout() == 2.0
            assert a.gettimeout() == 1.0
        assert a.gettimeout() == 7.5
        with pytest.raises(ValueError, match="finite"):
            with gateway._sock_timeout(a, None):
                pass
        assert a.gettimeout() == 7.5
    finally:
        a.close()
        b.close()


def test_wait_notification_fault_does_not_leak_timeout(server, monkeypatch):
    """The port's mirror of the reference test: a decode fault inside a
    timed wait_notification leaves the socket back at the port's standing
    ``SOCKET_POLL`` timeout — not the scoped 0.2 s, and never None."""
    tr = SocketTransport("127.0.0.1", server.port, "leak0")
    assert tr.sock.gettimeout() == gateway.SOCKET_POLL
    assert tr.wait_notification(0.2) is None      # clean idle timeout
    assert tr.sock.gettimeout() == gateway.SOCKET_POLL

    def boom(sock):
        raise RuntimeError("injected decode fault")

    monkeypatch.setattr(gateway, "_recv_frame", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tr.wait_notification(0.2)
    monkeypatch.undo()
    assert tr.sock.gettimeout() == gateway.SOCKET_POLL
    assert tr.call(LatestReq()).version == 0      # still aligned
    tr.close()


@pytest.mark.parametrize("cls", [SocketTransport, WsClientTransport],
                         ids=["tcp", "ws"])
def test_untimed_wait_polls_and_ends_when_closed(server, monkeypatch, cls):
    """``wait_notification()`` with no timeout is a loop of bounded reads:
    it outlives many polls, and closing the transport ends it."""
    monkeypatch.setattr(gateway, "SOCKET_POLL", 0.05)
    tr = cls("127.0.0.1", server.port, "idle0")
    assert tr.sock.gettimeout() == 0.05
    out = []

    def wait():
        try:
            tr.wait_notification()
        except ConnectionError as e:
            out.append(e)

    t = threading.Thread(target=wait, daemon=True)
    t.start()
    time.sleep(0.4)                               # ~8 polls, still waiting
    assert t.is_alive()
    tr.sock.close()
    _join([t], 5)
    assert len(out) == 1


def test_server_close_ends_idle_connections(monkeypatch):
    """No server thread sits in a read only the peer can end: closing the
    gateway ends an idle volunteer connection from the server side."""
    monkeypatch.setattr(gateway, "SOCKET_POLL", 0.05)
    s = GatewayServer(_problem(), n_versions=N_VERSIONS)
    s.start()
    sock = socket.create_connection(("127.0.0.1", s.port), timeout=5)
    _send_frame(sock, Hello("idle1"))
    assert _recv_frame(sock) is not None
    s.close()
    assert sock.recv(4096) == b""                 # torn down within a poll
    sock.close()


# ---------------------------------------------------------------------------
# real applies behind the socket
# ---------------------------------------------------------------------------

REAL_VERSIONS = 2


@pytest.fixture(scope="module")
def real_problem():
    return gateway._real_problem(device="cpu")


@pytest.fixture(scope="module")
def references(real_problem):
    n_async = 4 * REAL_VERSIONS                   # n_mb 4: one per gradient
    p, s, _ = sequential_async(real_problem, n_updates=n_async)
    lp, ls, _ = sequential_local(real_problem, k=4, n_updates=REAL_VERSIONS)
    return {"staleness:2": (n_async, (p, s)),
            "local:4": (REAL_VERSIONS, (lp, ls))}


@pytest.mark.parametrize("cls", [SocketTransport, WsClientTransport],
                         ids=["tcp", "ws"])
@pytest.mark.parametrize("policy", ["staleness:2", "local:4"])
def test_real_apply_over_the_wire_bit_matches_sequential(
        real_problem, references, policy, cls):
    n_updates, ref = references[policy]
    s = GatewayServer(real_problem, n_versions=REAL_VERSIONS, policy=policy,
                      real_apply=True)
    assert s.n_updates == n_updates
    s.start()
    try:
        tr = cls("127.0.0.1", s.port, "real0")
        try:
            final, tasks = run_volunteer(tr, "real0", n_updates,
                                         policy=policy, problem=real_problem)
            blob = tr.call(FetchModel(n_updates)).blob
            sent = dict(tr.sent)
        finally:
            tr.close()
    finally:
        s.close()
    assert final == tasks == n_updates
    assert "PublishModel" not in sent
    assert same_bits(blob, ref)


def test_real_apply_racing_volunteers_finish_at_the_final_version(
        real_problem):
    policy = "staleness:2"
    s = GatewayServer(real_problem, n_versions=REAL_VERSIONS, policy=policy,
                      real_apply=True)
    s.start()
    try:
        results = _volunteers(
            s, [("r0", SocketTransport), ("r1", WsClientTransport),
                ("r2", SocketTransport)],
            n_updates=s.n_updates, policy=policy, problem=real_problem)
    finally:
        s.close()
    assert [results[v][0] for v in sorted(results)] == [s.n_updates] * 3
    versions = sorted(s.ds._models)
    assert versions == list(range(versions[0], s.n_updates + 1))


def test_real_apply_cli_server_subprocess(real_problem, references,
                                          tmp_path):
    """``python -m repro_torch.core.gateway --serve --real-apply --device
    cpu`` with one volunteer: the wire-fetched model bit-matches
    ``sequential_async`` and the server exits 0."""
    policy = "staleness:2"
    n_updates, ref = references[policy]
    port_file = str(tmp_path / "gw.port")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.gateway", "--serve",
         "--real-apply", "--device", "cpu", "--policy", policy,
         "--n-versions", str(REAL_VERSIONS), "--n-mb", "4",
         "--port-file", port_file, "--timeout", "60"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = gateway._wait_port(port_file, proc, timeout=60)
        tr = SocketTransport("127.0.0.1", port, "cli0")
        try:
            final, _ = run_volunteer(tr, "cli0", n_updates, policy=policy,
                                     problem=real_problem)
            blob = tr.call(FetchModel(n_updates)).blob
        finally:
            tr.close()
        out, _ = proc.communicate(timeout=60)
    finally:
        gateway._reap(proc)
    assert proc.returncode == 0, out
    assert final == n_updates
    assert same_bits(blob, ref)
    assert b"(done)" in out


def test_real_apply_snapshot_restore_resumes_to_the_reference(
        real_problem, references, tmp_path):
    """Snapshot a real-apply run mid-way (tensors through the port's
    serialize), boot a fresh gateway from it (the applier reseeds on the
    restored latest blob), finish: the model is ``sequential_async``'s."""
    policy = "staleness:2"
    n_updates, ref = references[policy]
    snap = str(tmp_path / "gw.snap")
    s = GatewayServer(real_problem, n_versions=REAL_VERSIONS, policy=policy,
                      real_apply=True, snapshot_path=snap, snapshot_every=1)
    s.start()
    try:
        tr = SocketTransport("127.0.0.1", s.port, "half0")
        try:
            half, _ = run_volunteer(tr, "half0", n_updates // 2,
                                    policy=policy, problem=real_problem)
        finally:
            tr.close()
    finally:
        s.close()
    assert half == n_updates // 2 and s.snapshots_written > 0
    revived = GatewayServer(real_problem, n_versions=REAL_VERSIONS,
                            policy=policy, real_apply=True,
                            restore_from=snap)
    assert 0 < revived.ds.latest_version < n_updates
    revived.start()
    try:
        tr = SocketTransport("127.0.0.1", revived.port, "rest0")
        try:
            final, _ = run_volunteer(tr, "rest0", n_updates, policy=policy,
                                     problem=real_problem)
            blob = tr.call(FetchModel(n_updates)).blob
        finally:
            tr.close()
    finally:
        revived.close()
    assert final == n_updates
    assert same_bits(blob, ref)


# ---------------------------------------------------------------------------
# snapshots and the op log (synthetic problem)
# ---------------------------------------------------------------------------

def test_gateway_snapshot_file_restore(tmp_path):
    snap = str(tmp_path / "gw.snap")
    problem = SyntheticProblem(n_versions=3, n_mb=3)
    server = GatewayServer(problem, n_versions=3, snapshot_path=snap,
                           snapshot_every=1)
    server.start()
    t = SocketTransport("127.0.0.1", server.port, "gw0")
    sess = VolunteerSession("gw0", t)
    for _ in range(2):
        sess.lease(0.0)
        out = sess.advance(0.0)
        assert isinstance(out, MapWork)
        sess.finish_map(None, 0, 0.0)
    t.close()
    assert server.snapshots_written > 0
    server.close()
    revived = GatewayServer(problem, n_versions=3, restore_from=snap,
                            visibility_timeout=0.4, sweep_interval=0.02)
    revived.start()
    try:
        assert revived.ds.latest_version < 3
        t2 = SocketTransport("127.0.0.1", revived.port, "gw1")
        final, _ = run_volunteer(t2, "gw1", 3)
        t2.close()
        assert final == 3 and revived.done.is_set()
    finally:
        revived.close()


def _durable_bytes(qs, ds) -> bytes:
    queues = durable_fingerprint(qs)
    for q in queues.values():
        q.pop("wakeups", None)
    dsnap = ds.snapshot()
    return encode_message({
        "queues": queues,
        "ds": {k: dsnap[k] for k in ("kind", "kv", "models", "latest")}})


@pytest.mark.parametrize("snapshot_every", [0, 4])
def test_oplog_replay_bitmatches_live_state(snapshot_every):
    problem = SyntheticProblem(n_versions=2, n_mb=3)
    with tempfile.TemporaryDirectory() as td:
        server = GatewayServer(problem, policy="sync", cluster_dir=td,
                               snapshot_every=snapshot_every)
        server.start()
        try:
            tr = SocketTransport("127.0.0.1", server.port, "replay0")
            final, tasks = run_volunteer(tr, "replay0", 2, policy="sync")
            tr.close()
            assert (final, tasks) == (2, 2 * 4)
            live = _durable_bytes(server.qs, server.ds)
        finally:
            server.close()
        rq, rd, meta = replay_oplog(os.path.join(td, "gw0.oplog"),
                                    policy="sync")
        assert meta is not None and meta["policy"] == "sync"
        assert _durable_bytes(rq, rd) == live
        assert rd.latest_version == 2


def _reopen_script(prefix, oplog_cls):
    """Appends across a reopen with tiny segments and NO base: the reopened
    log must append after the last segment's records, not into segment 0."""
    log = oplog_cls(prefix, segment_ops=1)
    log.append(b"a")
    log.append(b"b")                    # rolls to segment 1
    log = oplog_cls(prefix, segment_ops=1)
    log.append(b"c")
    return oplog_cls(prefix).load()


def test_oplog_resumes_segments_without_a_base(tmp_path):
    """The port's deliberate difference: with no base, a reopened ``OpLog``
    resumes the current (0th) epoch's segments. Under the reference's rule
    (resume only after a base) the reopened log appends into segment 0 and
    replays ``c`` before ``b``."""
    assert _reopen_script(str(tmp_path / "port.oplog"), OpLog) == \
        (None, [b"a", b"b", b"c"])
    assert _reopen_script(str(tmp_path / "ref.oplog"), jelastic.OpLog) == \
        (None, [b"a", b"c", b"b"])


def _check_script(tmp, script, segment_ops):
    prefix = os.path.join(tmp, "prop.oplog")
    log = OpLog(prefix, segment_ops=segment_ops)
    base, ops = None, []
    for kind, payload in script:
        if kind == "base":
            log.write_base(payload)
            base, ops = payload, []
        elif kind == "append":
            log.append(payload)
            ops.append(payload)
        else:                            # process restart
            log = OpLog(prefix, segment_ops=segment_ops)
    assert OpLog(prefix).load() == (base, ops)


try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    _step = st.one_of(
        st.tuples(st.just("append"), st.binary(min_size=0, max_size=40)),
        st.tuples(st.just("base"), st.binary(min_size=1, max_size=40)),
        st.tuples(st.just("reopen"), st.none()))

    @settings(max_examples=60, deadline=None, derandomize=True,
              database=None, suppress_health_check=[HealthCheck.too_slow])
    @given(script=st.lists(_step, min_size=1, max_size=20),
           segment_ops=st.integers(min_value=1, max_value=4))
    def test_oplog_property_hypothesis(script, segment_ops):
        """Any base/append/reopen script reloads to the newest base and
        every op after it, in order — appends before any base included."""
        with tempfile.TemporaryDirectory() as tmp:
            _check_script(tmp, script, segment_ops)


@pytest.mark.parametrize("seed", range(4))
def test_oplog_random_scripts_reload_in_order(seed):
    """The same property on seeded scripts, with or without hypothesis."""
    import random
    rng = random.Random(seed)
    script = [("reopen", None) if rng.random() < 0.25 else
              ("base", b"B%d" % i) if rng.random() < 0.15 else
              ("append", b"op%d" % i) for i in range(rng.randint(5, 30))]
    with tempfile.TemporaryDirectory() as tmp:
        _check_script(tmp, script, segment_ops=rng.randint(1, 4))


# ---------------------------------------------------------------------------
# the browser tier
# ---------------------------------------------------------------------------

def test_browser_client_refuses_barrier_policy():
    with pytest.raises(ValueError, match="barrierless"):
        BrowserClient("127.0.0.1", 1, "b0", policy="sync")


def test_browser_client_completes_a_run_with_zero_model_pushes():
    s = GatewayServer(_problem(), n_versions=N_VERSIONS, policy="staleness:2")
    s.start()
    try:
        client = BrowserClient("127.0.0.1", s.port, "b0",
                               policy="staleness:2")
        final, tasks = client.run(s.n_updates)
        sent = dict(client.transport.sent)
        client.close()
    finally:
        s.close()
    assert final == tasks == s.n_updates == N_VERSIONS * N_MB
    assert client.transport.dialect == "ws"
    assert sent.get("SubmitUpdate") == tasks
    assert "PublishModel" not in sent


def test_browser_client_enforces_thin_contract_at_runtime(monkeypatch):
    s = GatewayServer(_problem(), n_versions=N_VERSIONS, policy="staleness:2")
    s.start()
    try:
        client = BrowserClient("127.0.0.1", s.port, "b1",
                               policy="staleness:2")

        def fat_volunteer(transport, vid, n_updates, **kw):
            transport.sent["PublishModel"] = 1
            return 0, 0

        monkeypatch.setattr(browser_mod, "run_volunteer", fat_volunteer)
        with pytest.raises(RuntimeError, match="thin-client contract"):
            client.run(s.n_updates)
        client.close()
    finally:
        s.close()


def test_real_problem_is_the_shrunk_paper_problem(real_problem):
    tp = TrainParams(batch_size=32, examples_per_epoch=256, num_epochs=1,
                     sample_len=40, mini_batch_size=8,
                     mini_batches_to_accumulate=4)
    assert real_problem.tp == tp and real_problem.cfg.d_model == 8
    assert real_problem.device == torch.device("cpu")
    again = TrainingProblem.paper_problem(corpus=synthetic_corpus(20_000),
                                          tp=tp, d_model=8, device="cpu")
    assert same_bits(real_problem.params0, again.params0)
