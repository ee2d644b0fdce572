"""Gateway — the volunteer protocol over a real loopback socket, durably.

``python -m repro_torch.core.gateway`` hosts a QueueServer + DataServer behind
``protocol.ServerEndpoint`` on a TCP socket, so a genuinely
**out-of-process** volunteer can join a training run — the end-to-end proof
that the sans-IO redesign works: the same ``VolunteerSession`` that drives
the Coordinator's PyTorch compute and the Simulator's virtual time here
drives a blocking socket client, with zero protocol code of its own.

One port serves TWO framing dialects, selected per connection by sniffing
the first byte (``GatewayServer._open_channel``):

- **native** — length-prefixed frames (u32 BE + canonically encoded
  message), the repo's original loopback framing;
- **WebSocket** — RFC 6455 (``core/wsframing``), each protocol message as
  one masked binary WS message: the framing a real browser volunteer — the
  paper's whole design point — can actually produce. ``WsClientTransport``
  is the client half; ``repro_torch.core.browser`` is the thin browser-shaped
  volunteer on top of it.

Beyond the liveness proof, the gateway is a durable volunteer SERVICE:

- **Wall-clock leases** — the endpoint carries a ``WallClock`` (the
  ``LeaseClock`` implementation for real time), so the SERVER stamps every
  lease deadline, and a sweeper thread drives ``QueueServer.expire_all()``
  whenever a real deadline passes: a socket volunteer that is kill -9'd
  mid-task has its ticket requeued after ``--visibility-timeout`` seconds and
  the run finishes without it (MLitB's "failure is the common case" stance).
- **Snapshot/restore** — ``--snapshot-every K`` serializes the full
  QueueServer + DataServer live state (pending FIFOs, in-flight deadlines,
  banked signals, counters, model blobs) through the ``checkpoint.serialize``
  codecs to ``--snapshot-path`` after every K state-changing requests,
  atomically; ``--restore-from`` boots a fresh process from the latest
  snapshot. kill -9 the server, restart, and the run resumes: unacked work
  replays (at-least-once) and dead clients' leases expire via the sweeper.
  Deadlines are ``time.monotonic()`` values — boot-relative on Linux/macOS,
  so they stay meaningful across a server process restart.
- **Server-side applier** — for barrierless policies (``staleness:<s>``,
  ``local:<k>``) the endpoint hosts a ``ServerApplier``: volunteers push one
  ``SubmitUpdate`` (gradient/delta up) and the SERVER runs admission ->
  apply -> publish -> ack, so a thin client never fetches the admission-time
  model or pushes the updated blob (the DistML.js parameter-server shape;
  bytes-per-update measured in ``benchmarks/staleness.py``).

Pieces:

- ``GatewayServer`` — accept loop + per-connection reader threads; one global
  lock serializes endpoint dispatch (the in-process servers are
  single-threaded by design). A connection binds to a consumer id with
  ``Hello``; ``Wake``/``VersionReady`` notification frames are pushed down
  that consumer's connection.
- ``SocketTransport`` — the client half: ``call`` writes a request frame and
  reads until the reply frame arrives, stashing any notification frames that
  interleave; ``wait_notification`` blocks on the socket for the next push.
- ``run_volunteer`` — the engine-free driver: lease -> advance -> synthetic
  compute -> finish, blocking on notifications while ``Blocked``. Works over
  ANY transport; ``run_volunteer_resilient`` adds reconnect-on-crash so a
  volunteer survives a gateway restart.

Port of ``repro/core/gateway.py``. What differs from the reference:

- **Every socket read has a finite timeout.** Each socket the gateway
  creates or accepts carries ``SOCKET_POLL``; an idle wait (a server
  connection between requests, a peer link, a volunteer parked in
  ``wait_notification``, a reply still being computed) is a loop of such
  bounded reads that checks for close or stop between them, and a reply
  that takes longer than ``REPLY_TIMEOUT`` counts as a dead gateway. No
  read blocks on a socket set to ``settimeout(None)``.
- ``--real-apply`` runs the port's ``TrainingProblem`` and ``RealApplier``
  on ``--device`` (the card unless ``--device cpu``; no silent fallback).
  Each real map a volunteer computes runs the ``lstm_seq`` kernel once per
  layer on the card.

Usage:
  python -m repro_torch.core.gateway --serve --port 0 --port-file /tmp/gw.port
  python -m repro_torch.core.gateway --serve --visibility-timeout 2 \\
      --snapshot-every 1 --snapshot-path /tmp/gw.snap
  python -m repro_torch.core.gateway --volunteer --port 12345 --expect-final 4
  python -m repro_torch.core.gateway --smoke --device cpu
  python -m repro_torch.core.gateway --serve --real-apply --policy staleness:2
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.checkpoint import serialize
from repro_torch.core import wsframing
from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.elastic import MODEL_KEY, GatewayRing, OpLog
from repro_torch.core.initiator import enqueue_problem
from repro_torch.core.applier import make_real_applier
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.core.protocol import (Ack, Blocked, Bye, DropConsumer, ExpireAll,
                                       FetchModel, Forward, ForwardNotify,
                                       ForwardReply, GcModels, Hello, KickQueue,
                                       LatestReq, LatestVersion, LeaseGrant,
                                       LocalWork, MapWork, ModelBlob, Nack, NoTask,
                                       NOTIFICATION_TYPES, Ok, PublishModel,
                                       ReduceWork, ServerApplier, ServerEndpoint,
                                       SubmitUpdate, TaskDone, UpdateCommitted,
                                       VersionReady, VolunteerSession, Wake,
                                       WatchVersion, decode_message, encode_message)
from repro_torch.core.queue import (QueueServer, ShardedQueueServer, WallClock,
                                    colocate_results)
from repro_torch.core.simulator import SyntheticProblem
from repro_torch.core.transport import InProcessTransport, Transport

_LEN = struct.Struct(">I")

log = logging.getLogger("repro_torch.gateway")

# Frame cap shared with the WebSocket framer: a corrupt/hostile length
# prefix must close the connection with a protocol error, never drive a
# multi-GB allocation loop (same bound, both dialects).
MAX_FRAME = wsframing.MAX_FRAME

# A peer that goes silent MID-frame (header sent, body never arrives) is
# dead or hostile: after this many seconds with zero bytes of progress the
# connection is torn down — through ``endpoint.disconnect`` on the server,
# so the half-open client's waiters/subscriptions don't leak into the
# sweeper's lease bookkeeping. Silence BETWEEN frames is just idle.
FRAME_STALL_TIMEOUT = 10.0

# Bound on the dialect sniff + WS upgrade exchange for a fresh connection.
HANDSHAKE_TIMEOUT = 10.0

_RECV_CHUNK = 1 << 20                # never recv() more than 1 MiB at a time

# Every socket's standing timeout. A read that sees no byte for this long
# returns to its caller, which checks for close/stop and reads again: an
# idle connection costs one wakeup a second, and no thread ever sits in a
# read that only the peer can end.
SOCKET_POLL = 1.0

# A request whose reply has not begun within this many seconds (many
# SOCKET_POLL reads) means the gateway is wedged or gone: the client gives
# up with a ConnectionError, which ``run_volunteer_resilient`` answers with
# a reconnect.
REPLY_TIMEOUT = 300.0

# requests that cannot change durable state — skipped by the snapshot trigger
_READONLY = ("LatestReq", "DepthReq", "DrainedReq", "FetchModel", "Hello")

# the module's single wall-time authority: connect deadlines, smoke-leg
# timers, and compute pacing all read the same LeaseClock the server stamps
# leases with (REPRO-TIME)
_CLOCK = WallClock()


def _monitor():
    """The runtime lock/invariant monitor, iff ``ANALYSIS_INSTRUMENT=1``
    (see ``repro_torch.analysis.runtime``); None — zero overhead — otherwise.
    The env var rides ``os.environ.copy()`` into every spawned server and
    volunteer subprocess, so one instrumented ``--smoke`` covers the whole
    topology."""
    if not os.environ.get("ANALYSIS_INSTRUMENT"):
        return None
    from repro_torch.analysis.runtime import Analysis
    return Analysis.instrument()


def _make_lock(name: str, *, guard: bool = False):
    """Lock seam: a plain ``threading.Lock`` normally, a ``MonitoredLock``
    under instrumentation. ``guard=True`` marks a dispatch lock no blocking
    call may run under (LOCK-BLOCK)."""
    mon = _monitor()
    if mon is not None:
        return mon.make_lock(name, guard=guard)
    return threading.Lock()


@contextlib.contextmanager
def _sock_timeout(sock: socket.socket, timeout: float):
    """Scoped ``settimeout`` that ALWAYS restores the previous value.

    Every timed section of the framing layer goes through this: restoring
    on the happy path only (the old ``settimeout``/``settimeout(None)``
    dance) leaks a stale timeout into the next frame read when an
    exception escapes mid-section, and a surprise ``socket.timeout`` on a
    later read desyncs the whole stream. ``timeout`` must be finite: no
    section blocks without one."""
    if timeout is None:
        raise ValueError("_sock_timeout needs a finite timeout")
    try:
        prev = sock.gettimeout()
    except OSError:
        prev = SOCKET_POLL
    try:
        sock.settimeout(timeout)
    except OSError:
        pass                    # socket already closed under us (die()/close):
        #                         the next recv/send raises and the caller
        #                         treats the connection as over
    try:
        yield sock
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass


def _send_frame(sock: socket.socket, msg) -> int:
    data = encode_message(msg)
    sock.sendall(_LEN.pack(len(data)) + data)
    return _LEN.size + len(data)


def _recv_exact(sock: socket.socket, n: int, *,
                mid_frame: bool = False) -> Optional[bytes]:
    """Read exactly ``n`` bytes. None = connection over (closed/reset, or a
    mid-frame stall). A ``socket.timeout`` with NOTHING consumed and
    ``mid_frame=False`` propagates — that is a clean idle timeout the
    caller asked for (heartbeat cue) and the stream is still aligned.

    Once any byte of a frame has been consumed a timeout may NOT surface:
    the caller would treat the consumed bytes as never read and desync on
    the next frame. Instead keep reading while bytes make progress, and
    give up (dead peer -> None) only after ``FRAME_STALL_TIMEOUT`` of
    total silence."""
    mon = _monitor()
    if mon is not None:
        mon.note_blocking("socket-recv")
    buf = b""
    stall_deadline = None
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), _RECV_CHUNK))
        except socket.timeout:
            if not buf and not mid_frame:
                raise               # idle timeout: caller decides (heartbeat)
            if mid_frame:
                # the caller scoped FRAME_STALL_TIMEOUT onto the socket:
                # this timeout IS the stall window elapsing with no bytes
                return None
            if stall_deadline is None:
                stall_deadline = _CLOCK.now() + FRAME_STALL_TIMEOUT
            elif _CLOCK.now() >= stall_deadline:
                return None         # mid-frame stall: peer is dead
            continue                # mid-frame: the rest is in flight
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
        stall_deadline = None       # progress resets the stall window
    return buf


def _recv_frame(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    n = _LEN.unpack(head)[0]
    if n > MAX_FRAME:
        # corrupt or hostile length prefix — never allocate for it; the
        # caller sees None and closes the connection (server side through
        # endpoint.disconnect, client side as a ConnectionError)
        log.error("protocol error: %d-byte frame exceeds MAX_FRAME=%d "
                  "-- closing connection", n, MAX_FRAME)
        return None
    # the header is consumed: from here a timeout must not surface (the
    # stream would desync), so the body read runs under the stall window
    with _sock_timeout(sock, FRAME_STALL_TIMEOUT):
        body = _recv_exact(sock, n, mid_frame=True)
    return None if body is None else decode_message(body)


def _synthetic_apply(blob, result, version: int):
    """The gateway's synthetic applier: model blobs are version strings, so
    applying any admitted contribution to version v just names v+1 (the real
    engines hand ``ApplyWork`` to PyTorch; the gateway proves the
    protocol)."""
    return f"v{version + 1}"


# ---------------------------------------------------------------------------
# multi-gateway control plane: ownership facade + op-log replay
# ---------------------------------------------------------------------------

class _ClusterQueueView:
    """The endpoint's queue-server facade on a cluster gateway: local queues
    dispatch straight through; ticket acks/nacks/kicks for a queue owned by a
    PEER gateway are handed to ``relay`` instead (the model owner committing
    a SubmitUpdate acks a ticket whose queue lives elsewhere).

    The presence check matters: ``QueueServer.ack`` auto-declares unknown
    queues (``declare(qname).ack(tag)``), so blind delegation would grow
    phantom queues on the model owner — and again during op-log replay, where
    ``relay=None`` simply DROPS remote-queue ops (the owning gateway's own
    log carries them; at-least-once absorbs a relay lost to a crash)."""

    def __init__(self, local, relay=None):
        self._local = local
        self._relay = relay

    def __getattr__(self, name):
        return getattr(self._local, name)

    def ack(self, qname: str, tag: int) -> bool:
        if qname in self._local.queues:
            return self._local.ack(qname, tag)
        if self._relay is not None:
            self._relay(Ack(qname, tag))
        return True

    def nack(self, qname: str, tag: int, *, front: bool = True) -> bool:
        if qname in self._local.queues:
            return self._local.nack(qname, tag, front=front)
        if self._relay is not None:
            self._relay(Nack(qname, tag, front))
        return True

    def kick(self, qname: str) -> bool:
        if qname in self._local.queues:
            return self._local.kick(qname)
        if self._relay is not None:
            self._relay(KickQueue(qname))
        return False


class _ReplayClock:
    """LeaseClock for op-log replay: ``now`` is the recorded stamp of the op
    being replayed, so the reconstructed server re-lives its own history —
    lease deadlines land exactly where the live server put them."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


def replay_oplog(prefix: str, *, policy: PolicyLike = None,
                 visibility_timeout: float = float("inf")):
    """Reconstruct a gateway's durable state from its op log: restore the
    newest base, then re-dispatch every intact op record through a scratch
    endpoint whose clock replays each op's recorded timestamp. Returns
    ``(queue_server, data_server, meta)`` — ``meta`` carries the base's
    policy/n_updates cross-check fields (None when the log has no base yet).

    Ops that touch a queue owned by a DIFFERENT gateway (the model owner's
    relayed ticket acks) are dropped by the same ownership facade the live
    server dispatches through — the owning gateway's log carries them."""
    pol = make_policy(policy)
    base, ops = OpLog(prefix).load()
    rq = QueueServer(default_timeout=visibility_timeout)
    rd = DataServer()
    meta = None
    if base is not None:
        state = decode_message(base)
        # a fresh process replays the log: no live connections, so waiters
        # are dropped rather than carried (the snapshot-restore convention)
        rq.restore(state["qs"], waiters_from={})
        rd.restore(state["ds"])
        meta = {"policy": state.get("policy"),
                "n_updates": state.get("n_updates")}
    clk = _ReplayClock()
    applier = None if pol.barrier else ServerApplier(pol, _synthetic_apply)
    ep = ServerEndpoint(_ClusterQueueView(rq), rd, clock=clk, applier=applier)
    for rec in ops:
        r = decode_message(rec)
        clk.t = r["t"]
        ep.handle(r["m"])
    return rq, rd, meta


# ---------------------------------------------------------------------------
# per-connection channels: one port, two framing dialects
# ---------------------------------------------------------------------------

class _TcpChannel:
    """Native length-prefixed dialect (docs/protocol.md "Byte framing")."""

    dialect = "tcp"

    def __init__(self, conn: socket.socket):
        self.conn = conn

    def handshake(self) -> bool:
        return True                  # the native dialect has no preamble

    def send(self, msg) -> int:
        return _send_frame(self.conn, msg)

    def recv(self):
        """Next protocol message; None = connection over. Raises
        ``socket.timeout`` after ``SOCKET_POLL`` idle seconds between
        frames (the stream stays aligned; the caller reads again)."""
        return _recv_frame(self.conn)

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class _WsChannel:
    """RFC 6455 dialect: the same protocol messages, each carried as one
    binary WebSocket message (``wsframing``). The server never masks; the
    client (a browser) must."""

    dialect = "ws"

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.framer = wsframing.server_framer()
        self._events: Deque = deque()

    def handshake(self) -> bool:
        """Run the HTTP upgrade under the handshake timeout; True on 101."""
        hs = wsframing.ServerHandshake()
        try:
            with _sock_timeout(self.conn, HANDSHAKE_TIMEOUT):
                while True:
                    data = self.conn.recv(4096)
                    if not data:
                        return False
                    response = hs.feed(data)
                    if response is not None:
                        break
                self.conn.sendall(response)
        except socket.timeout:
            log.error("ws handshake stalled after %.0fs -- closing",
                      HANDSHAKE_TIMEOUT)
            return False
        except wsframing.WsProtocolError as e:
            log.error("ws handshake rejected: %s", e)
            try:
                self.conn.sendall(wsframing.bad_handshake_response(str(e)))
            except OSError:
                pass
            return False
        except OSError:
            return False
        if hs.leftover:              # first frame bytes glued to the upgrade
            try:
                self._events.extend(self.framer.feed(hs.leftover))
            except wsframing.WsProtocolError as e:
                log.error("ws protocol error in handshake leftover: %s", e)
                return False
        return True

    def send(self, msg) -> int:
        frame = self.framer.send_message(encode_message(msg))
        self.conn.sendall(frame)
        return len(frame)

    def _read_chunk(self) -> Optional[bytes]:
        try:
            if self.framer.mid_frame:
                # same rule as the native dialect: a timeout may not
                # surface mid-frame — it IS the stall window elapsing
                with _sock_timeout(self.conn, FRAME_STALL_TIMEOUT):
                    try:
                        data = self.conn.recv(_RECV_CHUNK)
                    except socket.timeout:
                        return None
            else:
                # idle between messages: the timeout surfaces, as in the
                # native dialect (the framer holds no partial frame)
                data = self.conn.recv(_RECV_CHUNK)
        except socket.timeout:
            raise
        except OSError:
            return None
        return data or None

    def recv(self):
        """Next protocol message; answers pings and the close handshake
        transparently. None = connection over; ``socket.timeout`` = idle
        between messages, as in ``_TcpChannel.recv``."""
        while True:
            while self._events:
                ev = self._events.popleft()
                if isinstance(ev, wsframing.Message):
                    return decode_message(ev.data)
                if isinstance(ev, wsframing.Ping):
                    try:
                        self.conn.sendall(self.framer.pong(ev.data))
                    except OSError:
                        return None
                elif isinstance(ev, wsframing.Closed):
                    # complete the close handshake (best effort), then the
                    # caller tears the connection down
                    code = ev.code if ev.code is not None \
                        else wsframing.CLOSE_NORMAL
                    try:
                        self.conn.sendall(self.framer.close(code))
                    except OSError:
                        pass
                    return None
                # Pong: keepalive reply, nothing to do
            data = self._read_chunk()
            if data is None:
                return None
            try:
                self._events.extend(self.framer.feed(data))
            except wsframing.WsProtocolError as e:
                log.error("ws protocol error from peer: %s -- closing", e)
                try:
                    self.conn.sendall(self.framer.close(e.code))
                except OSError:
                    pass
                return None

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# inter-gateway link
# ---------------------------------------------------------------------------

class _PeerLink:
    """Client half of one inter-gateway connection (origin side).

    One native-dialect socket serves three flows concurrently: ``forward``
    request/reply (correlated by ``Forward.seq`` — many may be in flight),
    ``forward_async`` fire-and-forget ticket relays, and owner->origin
    ``ForwardNotify`` pushes, which the reader thread hands back to the
    server for local delivery. The link registers on the peer as consumer
    ``gw:<origin gid>`` via Hello — which is exactly how the peer's endpoint
    addresses ForwardNotify frames at us."""

    _DEAD = object()                 # reply slot sentinel: link died waiting

    def __init__(self, server: "GatewayServer", gid: int, host: str,
                 port: int):
        self.server = server
        self.gid = gid
        self.closed = False
        self.sock = _connect_with_retry(host, port, 2.0)
        self._send_lock = _make_lock(f"gateway.peer{gid}._send_lock")
        self._pending_lock = _make_lock(f"gateway.peer{gid}._pending_lock")
        self._pending: Dict[int, list] = {}      # seq -> [Event, reply slot]
        self._seq = 0
        try:
            with self._send_lock:
                _send_frame(self.sock, Hello(f"gw:{server.gid}"))
        except OSError as e:
            self.close()
            raise ConnectionError(f"gateway {gid} hung up: {e}") from e
        threading.Thread(target=self._read_loop, daemon=True).start()

    def _read_loop(self) -> None:
        while True:
            try:
                msg = _recv_frame(self.sock)
            except socket.timeout:
                if self.closed:
                    break
                continue                 # idle link: read again
            if msg is None:
                break
            if isinstance(msg, ForwardReply):
                with self._pending_lock:
                    ent = self._pending.pop(msg.seq, None)
                if ent is not None:
                    ent[1] = msg.inner
                    ent[0].set()
                # unknown seq: a forward_async reply or a timed-out waiter's
                # late answer — both dropped by design
            elif isinstance(msg, ForwardNotify):
                self.server._deliver_forwarded(msg)
            # anything else (the Hello's Ok) needs no action
        self.closed = True
        with self._pending_lock:
            pend, self._pending = self._pending, {}
        for ent in pend.values():
            ent[0].set()             # slot stays _DEAD -> ConnectionError

    def forward(self, inner, timeout: float = 30.0):
        """Send ``Forward(inner)`` and block for the correlated reply."""
        if self.closed:
            raise ConnectionError(f"gateway {self.gid} link is down")
        ent = [threading.Event(), _PeerLink._DEAD]
        with self._pending_lock:
            self._seq += 1
            seq = self._seq
            self._pending[seq] = ent
        try:
            with self._send_lock:
                _send_frame(self.sock,
                            Forward(seq, str(self.server.gid), inner))
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(seq, None)
            raise ConnectionError(f"gateway {self.gid} hung up: {e}") from e
        if not ent[0].wait(timeout):
            with self._pending_lock:
                self._pending.pop(seq, None)
            raise ConnectionError(f"gateway {self.gid} forward timed out")
        if ent[1] is _PeerLink._DEAD:
            raise ConnectionError(f"gateway {self.gid} died mid-forward")
        return ent[1]

    def forward_async(self, inner) -> None:
        """Fire-and-forget Forward (ticket relays): the reply frame is
        dropped by the reader (unregistered seq). At-least-once semantics
        absorb a relay the peer never received — the lease re-expires."""
        if self.closed:
            raise ConnectionError(f"gateway {self.gid} link is down")
        with self._pending_lock:
            self._seq += 1
            seq = self._seq
        try:
            with self._send_lock:
                _send_frame(self.sock,
                            Forward(seq, str(self.server.gid), inner))
        except OSError as e:
            raise ConnectionError(f"gateway {self.gid} hung up: {e}") from e

    def close(self) -> None:
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class GatewayServer:
    """Loopback volunteer service: wall-clock leases + sweeper, optional
    periodic snapshots, optional server-side applier (barrierless policies).

    With ``gateways > 1`` the server is ONE member of a K-gateway control
    plane: a ``GatewayRing`` (consistent hashing over ``colocate_results``
    placement keys, ``MODEL_KEY`` for all DataServer state) decides which
    gateway owns each request; non-owned requests are forwarded over
    inter-gateway ``Forward`` frames. Durability is the per-gateway op log
    under ``cluster_dir`` (``--cluster-dir`` alone, with ``gateways == 1``,
    turns the op log on without the ring): every state-changing op is
    fsynced BEFORE its reply goes out, so a kill -9'd gateway's slice can be
    replayed by the deterministic adopter (smallest live gid) and the run
    completes at the reference final version.
    """

    def __init__(self, problem=None, *, host: str = "127.0.0.1", port: int = 0,
                 n_versions: Optional[int] = None, policy: PolicyLike = None,
                 n_shards: int = 1,
                 visibility_timeout: float = float("inf"),
                 sweep_interval: float = 0.05,
                 snapshot_path: Optional[str] = None, snapshot_every: int = 0,
                 restore_from: Optional[str] = None,
                 real_apply: bool = False,
                 gid: int = 0, gateways: int = 1,
                 cluster_dir: Optional[str] = None,
                 oplog_segment_ops: int = 256):
        self.policy = make_policy(policy)
        self.clock = WallClock()
        if problem is None:
            # even a restore needs the problem spec: the commit target is
            # policy arithmetic over (n_versions, n_mb), which the snapshot
            # records only as a cross-check, not as a reconstructible schedule
            raise ValueError("GatewayServer needs the problem spec (pass the "
                             "same --n-versions/--n-mb as the original serve "
                             "when restoring)")
        self.gid = int(gid)
        self.gateways = int(gateways)
        self.cluster_dir = cluster_dir
        self.ring = (GatewayRing(range(self.gateways))
                     if self.gateways > 1 else None)
        #: placement rule shared with ShardedQueueServer: map-results:vN
        #: colocates with the task queue, so ONE gateway owns a version's
        #: whole barrier (publish + drain never straddle processes)
        self._place = colocate_results
        if self.ring is not None:
            if cluster_dir is None:
                raise ValueError("gateways > 1 needs cluster_dir (op logs "
                                 "and peer port files live there)")
            if not 0 <= self.gid < self.gateways:
                raise ValueError(f"gid {gid} outside ring of {gateways}")
            if real_apply:
                raise ValueError("multi-gateway mode hosts the synthetic "
                                 "applier only (the real applier is "
                                 "single-gateway)")
            if n_shards > 1:
                raise ValueError("multi-gateway mode subsumes --shards: the "
                                 "ring partitions queues across processes")
            if snapshot_path is not None:
                raise ValueError("multi-gateway durability is the op log "
                                 "(cluster_dir); snapshot_path is the "
                                 "single-gateway snapshot file")
        self.qs = (QueueServer(default_timeout=visibility_timeout)
                   if n_shards <= 1
                   else ShardedQueueServer(n_shards,
                                           default_timeout=visibility_timeout))
        self.ds = DataServer()
        nv = n_versions if n_versions is not None else problem.n_versions
        self.n_versions = nv
        # the run's commit target: the policy decides how many model versions
        # `nv` BSP-equivalent rounds must publish (sync: nv; async: nv * n_mb)
        self.n_updates = self.policy.n_updates(problem, nv)
        if real_apply and self.policy.barrier:
            raise ValueError("real_apply needs a barrierless policy "
                             "(staleness:<s> or local:<k>)")
        if restore_from is not None:
            self.restore(restore_from)
        else:
            # real applies need the real (params, opt_state) blob as v0;
            # the synthetic applier runs on version-string tokens
            enqueue_problem(problem, self.qs, self.ds, n_versions=nv,
                            policy=self.policy, store_real_model=real_apply)
        applier = None
        if not self.policy.barrier:
            if real_apply:
                applier = make_real_applier(problem, self.policy)
                if restore_from is not None:
                    # the snapshot's latest blob is the applier's new truth
                    latest = self.ds.latest_version
                    applier.backend.reseed(self.ds.get_model(latest), latest)
            else:
                applier = ServerApplier(self.policy, _synthetic_apply)
        self.applier = applier
        # on a cluster member the endpoint dispatches through the ownership
        # facade: remote-queue ticket ops relay to their owner instead of
        # auto-declaring phantom queues locally
        eqs = self.qs if self.ring is None \
            else _ClusterQueueView(self.qs, self._relay_ticket)
        self.endpoint = ServerEndpoint(eqs, self.ds, self._notify,
                                       clock=self.clock, applier=applier)
        self.sweep_interval = sweep_interval
        self.snapshot_path = snapshot_path
        self.snapshot_every = snapshot_every
        self.snapshots_written = 0
        self._ops_since_snap = 0
        # dispatch lock (guard: no blocking call may run under it) + a
        # separate writer lock so snapshot fsyncs serialize among themselves
        # without ever stalling dispatch
        self._lock = _make_lock("gateway._lock", guard=True)
        self._snap_lock = _make_lock("gateway._snap_lock")
        # submit combining queue (leaf lock; order: _lock -> _submit_lock).
        # SubmitUpdates enqueue here; whichever connection thread wins the
        # dispatch lock drains them ALL as one endpoint.submit_batch — one
        # apply_batch_flat call on a real applier instead of one per update.
        self._submit_lock = _make_lock("gateway._submit_lock")
        self._submit_pending: list = []
        self._snap_seq = 0                       # encode order (under _lock)
        self._snap_written = 0                   # last seq on disk (_snap_lock)
        self._conns: Dict[str, object] = {}      # consumer -> channel
        self.done = threading.Event()
        self._closed = threading.Event()
        # -- cluster state --------------------------------------------------
        self._oplog: Optional[OpLog] = None
        self._op_buffer: list = []               # ("op"|"base", bytes) FIFO
        self._ops_since_base = 0
        self._fwd_outbox: list = []              # ticket relays awaiting send
        self._peers: Dict[int, _PeerLink] = {}
        self._peers_lock = _make_lock("gateway._peers_lock")
        # failover is serialized and may block (replay reads the dead
        # gateway's log from disk); order: _failover_lock -> _lock
        self._failover_lock = _make_lock("gateway._failover_lock")
        self._seen_version = 0                   # cluster-wide version echo
        if self.ring is not None:
            # this gateway serves only its ring slice: every queue the
            # shared enqueue created for a peer's slice is dropped here
            for name in list(self.qs.queues):
                if self.ring.owner_of(self._place(name)) != self.gid:
                    self.qs.detach(name)
        if cluster_dir is not None:
            os.makedirs(cluster_dir, exist_ok=True)
            self._oplog = OpLog(
                os.path.join(cluster_dir, f"gw{self.gid}.oplog"),
                segment_ops=oplog_segment_ops)
            self.endpoint.op_sink = self._log_op
            # boot base: the new epoch captures the (pruned, possibly
            # restored) starting state, so replaying a freshly-booted
            # gateway is well-defined and older epochs are subsumed
            self._oplog.write_base(self._encode_cluster_base())
        if self.ds.latest_version >= self.n_updates:
            self.done.set()                      # restored a finished run
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._sock.settimeout(SOCKET_POLL)
        self.port = self._sock.getsockname()[1]
        if cluster_dir is not None:
            # peers (and in-process clusters) discover us via the port file
            pf = os.path.join(cluster_dir, f"gw{self.gid}.port")
            tmp = pf + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(self.port))
            os.replace(tmp, pf)                  # atomic: readers never see ""

    # -- durability ------------------------------------------------------------
    def _encode_snapshot(self) -> Tuple[int, bytes]:
        """Serialize the full queue+data state (CPU only — caller holds the
        dispatch lock). The blob rides the PROTOCOL wire codec
        (``encode_message``), not raw ``serialize.dumps``, because queue
        bodies are wire dataclasses (``MapTask`` et al.) that serialize by
        registered name. Returns (seq, bytes): ``seq`` orders this state
        against other encodes so a slow writer can never clobber a newer
        snapshot with an older one."""
        assert self.snapshot_path is not None
        state = {"gateway": {"qs": self.qs.snapshot(),
                             "ds": self.ds.snapshot(),
                             "n_updates": self.n_updates,
                             "policy": self.policy.spec}}
        self._snap_seq += 1
        return self._snap_seq, encode_message(state,
                                              codec=serialize.DEFAULT_CODEC)

    def _write_snapshot(self, seq: int, data: bytes) -> int:
        """Atomic-write an encoded snapshot (tmp + fsync + rename) — called
        with the dispatch lock RELEASED: the fsync is the blocking call that
        must never stall dispatch (LOCK-BLOCK invariant). Returns bytes
        written, 0 if a newer snapshot already reached disk."""
        with self._snap_lock:
            if seq <= self._snap_written:
                return 0
            mon = _monitor()
            if mon is not None:
                mon.note_blocking("snapshot-fsync")
            n = serialize.atomic_write(self.snapshot_path, data)
            self._snap_written = seq
            self.snapshots_written += 1
            return n

    def snapshot(self) -> int:
        """Write the full queue+data state atomically; returns bytes
        written. Takes the dispatch lock itself — call it unlocked."""
        with self._lock:
            seq, data = self._encode_snapshot()
        return self._write_snapshot(seq, data)

    def restore(self, path: str) -> None:
        """Boot from durable state: an op-log prefix (base + replayed ops)
        when ``path`` names one, else a legacy full-snapshot file."""
        if OpLog.exists(path):
            rq, rd, meta = replay_oplog(
                path, policy=self.policy,
                visibility_timeout=self.qs.default_timeout)
            if meta is not None:
                if meta["policy"] != self.policy.spec:
                    raise ValueError(
                        f"op log was served under policy={meta['policy']!r}, "
                        f"this server is {self.policy.spec!r} — pass the "
                        f"original --policy")
                if meta["n_updates"] != self.n_updates:
                    raise ValueError(
                        f"op log's commit target is {meta['n_updates']}, "
                        f"this server computes {self.n_updates} — pass the "
                        f"original --n-versions/--n-mb")
            if isinstance(self.qs, ShardedQueueServer):
                # op logs are written by unsharded cluster members; restore
                # to the matching kind (the legacy branch's coercion move)
                self.qs = QueueServer(default_timeout=self.qs.default_timeout)
            self.qs.restore(rq.snapshot(), waiters_from={})
            self.ds.restore(rd.snapshot())
            return
        state = decode_message(serialize.read_bytes(path))["gateway"]
        # the snapshot records the run's semantics as a cross-check: booting
        # it under different CLI flags must fail HERE, not as a confusing
        # protocol cascade once volunteers reconnect
        if state["policy"] != self.policy.spec:
            raise ValueError(f"snapshot was served under policy="
                             f"{state['policy']!r}, this server is "
                             f"{self.policy.spec!r} — pass the original "
                             f"--policy")
        if state["n_updates"] != self.n_updates:
            raise ValueError(f"snapshot's commit target is "
                             f"{state['n_updates']}, this server computes "
                             f"{self.n_updates} — pass the original "
                             f"--n-versions/--n-mb")
        if state["qs"].get("kind") == "ShardedQueueServer" and \
                not isinstance(self.qs, ShardedQueueServer):
            self.qs = ShardedQueueServer(1, default_timeout=float("inf"))
        elif state["qs"].get("kind") == "QueueServer" and \
                isinstance(self.qs, ShardedQueueServer):
            self.qs = QueueServer()
        self.qs.restore(state["qs"])
        self.ds.restore(state["ds"])

    def _maybe_snapshot(self, msg) -> Optional[Tuple[int, bytes]]:
        """Called under the dispatch lock. When a snapshot is due, ENCODES
        the state (pure CPU) and returns the pending ``(seq, bytes)`` for
        the caller to write after releasing the lock; None otherwise."""
        if self.snapshot_every <= 0 or self.snapshot_path is None:
            return None
        if type(msg).__name__ in _READONLY:
            return None
        self._ops_since_snap += 1
        if self._ops_since_snap < self.snapshot_every:
            return None
        self._ops_since_snap = 0
        return self._encode_snapshot()

    # -- op log (cluster durability) -------------------------------------------
    def _encode_cluster_base(self) -> bytes:
        """Full durable state as an op-log base record (the protocol wire
        codec, because queue bodies are wire dataclasses)."""
        return encode_message({"qs": self.qs.snapshot(),
                               "ds": self.ds.snapshot(),
                               "policy": self.policy.spec,
                               "n_updates": self.n_updates},
                              codec=serialize.DEFAULT_CODEC)

    def _log_op(self, m) -> None:
        """Endpoint op sink — runs under the dispatch lock (pure CPU): the
        op is encoded with its authority timestamp and buffered; the
        dispatching thread flushes the buffer to disk BEFORE sending the
        reply, so every acknowledged op is recoverable by replay. Every
        ``snapshot_every`` ops a fresh base is queued behind the ops that
        precede it, rolling the log's epoch at the flush."""
        self._op_buffer.append(
            ("op", encode_message({"t": self.clock.now(), "m": m})))
        if self.snapshot_every > 0:
            self._ops_since_base += 1
            if self._ops_since_base >= self.snapshot_every:
                self._ops_since_base = 0
                self._op_buffer.append(("base", self._encode_cluster_base()))

    def _flush_oplog(self) -> None:
        """Drain the op buffer to disk in order — called with the dispatch
        lock RELEASED (fsync is blocking; LOCK-BLOCK). ``_snap_lock``
        serializes writers so two drains can never interleave their
        batches; the dispatch lock is retaken only for the buffer swap."""
        if self._oplog is None or self._closed.is_set():
            return
        with self._snap_lock:
            with self._lock:
                batch, self._op_buffer = self._op_buffer, []
            if not batch:
                return
            mon = _monitor()
            if mon is not None:
                mon.note_blocking("oplog-fsync")
            for kind, data in batch:
                if kind == "base":
                    self._oplog.write_base(data)
                else:
                    self._oplog.append(data)

    @property
    def observed_version(self) -> int:
        """Latest model version this gateway can vouch for: its own
        DataServer (when it is the model owner) or versions echoed in
        forwarded replies and notifications (when a peer is)."""
        return max(self.ds.latest_version, self._seen_version)

    def _observe_version(self, msg) -> None:
        """Track the cluster-wide latest version flowing through this
        gateway — the model owner may be a peer, so the local DataServer
        can be arbitrarily stale. Reaching the commit target sets ``done``
        exactly like a local commit would."""
        v = -1
        if isinstance(msg, (LatestVersion, UpdateCommitted, VersionReady)):
            v = msg.version
        elif isinstance(msg, ModelBlob) and msg.present:
            v = msg.version
        elif isinstance(msg, LeaseGrant):
            v = msg.latest
        if v > self._seen_version:
            self._seen_version = v
        if self.observed_version >= self.n_updates:
            self.done.set()

    # -- lease sweeper ---------------------------------------------------------
    def _sweep_loop(self) -> None:
        """Visibility-timeout enforcement on REAL deadlines: wake when the
        earliest lease deadline passes and requeue everything expired (the
        requeue notifications push Wake frames to waiting volunteers). This
        is the clock owner the in-process engines emulate with virtual time."""
        while not self._closed.is_set():
            pending = None
            with self._lock:
                now = self.clock.now()
                if self._oplog is not None:
                    # expiry through the endpoint so the op log records it:
                    # replay must expire exactly what the live server did
                    # (ExpireAll.now is applied verbatim). Dispatch only
                    # when a real deadline has passed, so the log never
                    # fills with no-op sweeps at the polling cadence.
                    dl0 = self.qs.next_deadline()
                    if dl0 is not None and dl0 <= now:
                        self.endpoint.handle(ExpireAll(now))
                else:
                    expired = self.qs.expire_all(now)
                    if expired and self.snapshot_every > 0 \
                            and self.snapshot_path is not None:
                        # expiry is a durable state change; encode under the
                        # lock, fsync after releasing it
                        pending = self._encode_snapshot()
                dl = self.qs.next_deadline()
            if pending is not None:
                self._write_snapshot(*pending)
            self._flush_oplog()
            self._drain_outbox()
            wait = self.sweep_interval if dl is None else \
                max(0.0, min(dl - self.clock.now(), self.sweep_interval))
            self._closed.wait(wait if wait > 0 else 0.001)

    # -- wire ------------------------------------------------------------------
    def _notify(self, consumer: str, msg) -> None:
        # called inside endpoint.handle, under self._lock. The send is
        # bounded: a client that stops draining its socket would otherwise
        # block here with the global lock held and stall the whole server —
        # treat a wedged buffer like a disconnect and drop the registration.
        channel = self._conns.get(consumer)
        delivered = False
        if channel is not None:
            try:
                with _sock_timeout(channel.conn, 10.0):
                    channel.send(msg)
                delivered = True
            except OSError:
                self._conns.pop(consumer, None)
        if not delivered and isinstance(msg, Wake):
            # a queue wake is one-shot: consumed by an unreachable consumer,
            # the event would be lost to everyone. Hand it to the next waiter
            # (or bank it), like the engines' dead-volunteer kick path —
            # through the endpoint, the same move a live volunteer's
            # KickQueue request makes (REPRO-LAYER).
            self.endpoint.handle(KickQueue(msg.queue))

    def _open_channel(self, conn: socket.socket):
        """Sniff the dialect from the first byte and run any handshake.

        A WebSocket connection opens with an HTTP ``GET `` (0x47); a
        native-dialect connection opens with a u32 BE length < MAX_FRAME,
        whose first byte is <= 0x01 — one peeked byte disambiguates.
        Returns a ready channel, or None (connection already closed)."""
        try:
            with _sock_timeout(conn, HANDSHAKE_TIMEOUT):
                first = conn.recv(1, socket.MSG_PEEK)
        except (socket.timeout, OSError):
            first = b""
        if not first:
            try:
                conn.close()
            except OSError:
                pass
            return None
        channel = _WsChannel(conn) if wsframing.is_ws_preamble(first) \
            else _TcpChannel(conn)
        if not channel.handshake():
            channel.close()
            return None
        return channel

    # -- cluster routing + failover --------------------------------------------
    def _route_key(self, msg) -> Optional[str]:
        """Ring routing key for one request; None = dispatch locally (Hello
        binds the connection; Bye/DropConsumer broadcast; ExpireAll is
        server-internal)."""
        if isinstance(msg, (FetchModel, PublishModel, GcModels, WatchVersion,
                            LatestReq, SubmitUpdate)):
            return MODEL_KEY
        q = getattr(msg, "queue", None)
        if q is not None:
            return self._place(q)
        return None

    def _owner_for(self, key: str, timeout: float = 30.0) -> int:
        """Resolve the current owner of ``key``, waiting out a failover
        window (owner dead, adoption not yet recorded)."""
        deadline = _CLOCK.now() + timeout
        while True:
            try:
                return self.ring.owner_of(key)
            except LookupError:
                if _CLOCK.now() >= deadline:
                    raise
                time.sleep(0.02)

    def _await_ownership(self, key: Optional[str],
                         timeout: float = 30.0) -> None:
        """Hold a forwarded request until this gateway owns ``key``'s slice.
        The window where this actually waits is failover: peers route to
        the deterministic adopter BEFORE it finishes replaying the dead
        gateway's op log; the request proceeds the moment the merge
        commits the adoption."""
        if key is None or self.ring is None:
            return
        deadline = _CLOCK.now() + timeout
        while not self._closed.is_set():
            try:
                if self.ring.owner_of(key) == self.gid:
                    return
            except LookupError:
                pass                 # failover window: nobody owns it yet
            if _CLOCK.now() >= deadline:
                raise RuntimeError(
                    f"gateway {self.gid}: forwarded request for slice "
                    f"{key!r} but ownership never arrived")
            time.sleep(0.02)

    def _peer_port(self, g: int, wait: float = 20.0) -> Optional[int]:
        pf = os.path.join(self.cluster_dir, f"gw{g}.port")
        deadline = _CLOCK.now() + wait
        while True:
            try:
                with open(pf) as f:
                    return int(f.read())
            except (OSError, ValueError):
                # missing at boot = not up YET (no liveness verdict); the
                # caller decides how long a missing file is tolerable
                if _CLOCK.now() >= deadline:
                    return None
                time.sleep(0.05)

    def _peer(self, g: int) -> _PeerLink:
        """The (cached) link to gateway ``g``; reconnects a dead link once —
        a closed socket may just be a restarted peer."""
        with self._peers_lock:
            link = self._peers.get(g)
        if link is not None and not link.closed:
            return link
        port = self._peer_port(g)
        if port is None:
            raise ConnectionError(f"gateway {g} never published a port file")
        fresh = _PeerLink(self, g, "127.0.0.1", port)
        with self._peers_lock:
            cur = self._peers.get(g)
            if cur is not None and not cur.closed and cur is not link:
                fresh.close()        # lost the reconnect race; use theirs
                return cur
            self._peers[g] = fresh
        return fresh

    def _peer_died(self, g: int) -> None:
        """A send/connect to ``g`` failed: drop its link and run failover."""
        with self._peers_lock:
            link = self._peers.get(g)
            if link is not None and link.closed:
                self._peers.pop(g, None)
        self._on_peer_death(g)

    def _on_peer_death(self, dead: int) -> None:
        """Failover: mark ``dead`` dead on the ring; the deterministic
        adopter (smallest live gid) replays the dead gateway's op log and
        merges its slice, every other survivor just records the redirect.
        Serialized and idempotent — reentry for an already-dead gid is a
        no-op, so racing detectors (pinger, forward errors) are safe."""
        with self._failover_lock:
            if self.ring is None or dead == self.gid or \
                    dead not in self.ring.live():
                return
            try:
                dead_owned_model = self.ring.owner_of(MODEL_KEY) == dead
            except LookupError:
                dead_owned_model = False
            self.ring.kill(dead)
            adopter = self.ring.default_adopter(dead)
            if adopter != self.gid:
                # optimistic redirect: the adopter gates forwarded requests
                # on its own merge, so routing ahead of it is safe
                self.ring.adopt(dead, adopter)
                log.warning("gateway %d: peer %d died; slice redirects to "
                            "adopter %d", self.gid, dead, adopter)
                return
            prefix = os.path.join(self.cluster_dir, f"gw{dead}.oplog")
            rq, rd, _ = replay_oplog(
                prefix, policy=self.policy,
                visibility_timeout=self.qs.default_timeout)
            n_queues = len(rq.queues)
            with self._lock:
                for name in list(rq.queues):
                    moved = rq.detach(name)
                    if name in self.qs.queues:
                        # both sides only transiently (a relay declared it
                        # here): keep OUR live waiters, their durable body
                        local = self.qs.detach(name)
                        moved.adopt_waiters(local)
                    self.qs.attach(moved)
                if dead_owned_model:
                    # in-place restore: the endpoint aliases self.ds
                    self.ds.restore(rd.snapshot())
                self.ring.adopt(dead, self.gid)
                # the merged state becomes a fresh base: OUR log now carries
                # the adopted slice, so a SECOND failover replays from here
                self._op_buffer.append(
                    ("base", self._encode_cluster_base()))
                if self.observed_version >= self.n_updates:
                    self.done.set()
            self._flush_oplog()
            log.warning("gateway %d: adopted slice of dead gateway %d "
                        "(%d queues, model_owner=%s)", self.gid, dead,
                        n_queues, dead_owned_model)

    def _forward_retry(self, key: str, msg, timeout: float = 30.0):
        """Dispatch ``msg`` at the current owner of ``key``, retrying across
        a failover (the owner may die mid-forward, or become US). Retried
        ops may double-apply — at-least-once, absorbed the same way
        re-leased tickets are."""
        deadline = _CLOCK.now() + timeout
        while True:
            owner = self._owner_for(key)
            if owner == self.gid:
                with self._lock:
                    reply = self.endpoint.handle(msg)
                    if self.ds.latest_version >= self.n_updates:
                        self.done.set()
                self._flush_oplog()
                self._drain_outbox()
                return reply
            try:
                return self._peer(owner).forward(msg)
            except ConnectionError:
                self._peer_died(owner)
                if _CLOCK.now() >= deadline:
                    raise
                time.sleep(0.02)

    def _route_cluster(self, msg, channel) -> bool:
        """Cluster routing for one client request. True = fully handled
        (forwarded or broadcast, reply sent); False = this gateway owns the
        slice, fall through to local dispatch."""
        if isinstance(msg, (Bye, DropConsumer)):
            # consumer-scoped cleanup must reach EVERY gateway: the
            # consumer's leases and waiters may span several owners' slices
            with self._lock:
                reply = self.endpoint.handle(msg)
            total = reply.value if isinstance(reply.value, int) else 0
            for g in self.ring.live():
                if g == self.gid:
                    continue
                try:
                    r = self._peer(g).forward(msg)
                    if isinstance(r, Ok) and isinstance(r.value, int):
                        total += r.value
                except ConnectionError:
                    self._peer_died(g)
            self._flush_oplog()
            with self._lock:
                channel.send(Ok(total))
            return True
        key = self._route_key(msg)
        if key is None or self._owner_for(key) == self.gid:
            return False
        reply = self._forward_retry(key, msg)
        self._observe_version(reply)
        with self._lock:
            channel.send(reply)
        return True

    def _relay_ticket(self, msg) -> None:
        """Ownership-facade hook: an ack/nack/kick for a PEER's queue raised
        mid-dispatch (the model owner committing a SubmitUpdate acks a
        ticket whose queue lives elsewhere). Runs UNDER the dispatch lock,
        so it only enqueues; the dispatching thread relays after release
        (at-least-once absorbs a relay lost to a crash)."""
        self._fwd_outbox.append(msg)

    def _drain_outbox(self) -> None:
        """Send buffered ticket relays to their owners — called with the
        dispatch lock released. Undeliverable relays requeue for the next
        drain (sweeper cadence bounds the delay)."""
        if self.ring is None or not self._fwd_outbox:
            return
        with self._lock:
            batch, self._fwd_outbox = self._fwd_outbox, []
        requeue = []
        for m in batch:
            try:
                owner = self.ring.owner_of(self._place(m.queue))
            except LookupError:
                requeue.append(m)    # failover window: retry next drain
                continue
            if owner == self.gid:    # adopted mid-flight: now local
                with self._lock:
                    self.endpoint.handle(m)
                continue
            try:
                self._peer(owner).forward_async(m)
            except ConnectionError:
                self._peer_died(owner)
                requeue.append(m)
            except RuntimeError:
                requeue.append(m)    # shutting down; next drain decides
        if requeue:
            with self._lock:
                self._fwd_outbox.extend(requeue)

    def _deliver_forwarded(self, fn: ForwardNotify) -> None:
        """A peer pushed a notification owed to one of OUR consumers
        (their endpoint fired a watch/wake registered via Forward)."""
        self._observe_version(fn.inner)
        with self._lock:
            self._notify(fn.consumer, fn.inner)

    def _failover_loop(self) -> None:
        """Peer liveness + end-of-run observation, at sweeper-ish cadence.
        Each round pings every live peer over its link (a forwarded Hello
        is the cheapest request that proves the peer's dispatch loop is
        alive); a failure on a peer that HAS published its port file means
        the process died -> failover. The model owner's latest version is
        probed too, so a gateway serving only forwarded traffic still
        observes the run finishing."""
        while not self._closed.is_set():
            for g in self.ring.live():
                if g == self.gid or self._closed.is_set():
                    continue
                if self._peer_port(g, wait=0.0) is None:
                    continue         # not up yet: no link, no verdict
                try:
                    self._peer(g).forward(Hello(f"gw:{self.gid}"),
                                          timeout=5.0)
                except ConnectionError:
                    self._peer_died(g)
            try:
                owner = self.ring.owner_of(MODEL_KEY)
                if owner == self.gid:
                    self._observe_version(
                        LatestVersion(self.ds.latest_version))
                else:
                    self._observe_version(
                        self._peer(owner).forward(LatestReq(), timeout=5.0))
            except (LookupError, ConnectionError):
                pass                 # failover window / dead link: next round
            self._drain_outbox()
            self._closed.wait(0.3)

    def die(self) -> None:
        """In-process stand-in for kill -9 (benchmarks/tests): stop serving
        and DROP the buffered-but-unflushed ops — exactly the state the
        real signal loses. The on-disk op log is left as the crash left
        it."""
        self._closed.set()
        with self._lock:
            self._op_buffer = []
            conns, self._conns = dict(self._conns), {}
        try:
            self._sock.close()
        except OSError:
            pass
        with self._peers_lock:
            links, self._peers = dict(self._peers), {}
        for link in links.values():
            link.close()
        for ch in conns.values():
            ch.close()

    def _send_submit_reply(self, entry, reply) -> None:
        """Send one drained submit reply (under the dispatch lock),
        wrapping it as ``ForwardReply`` when the submit arrived forwarded
        from a peer gateway."""
        _, channel, _, wrap = entry
        out = reply if wrap is None else ForwardReply(wrap, reply)
        try:
            channel.send(out)
        except OSError:
            # peer died mid-drain: its update is already committed/nacked
            # server-side; drop the dead conn registration (the _notify
            # convention) and let ITS thread's recv observe the close
            for c, ch in list(self._conns.items()):
                if ch is channel:
                    self._conns.pop(c, None)

    def _submit_drain(self, msg, channel,
                      wrap: Optional[int] = None) -> None:
        """Combining-lock commit: enqueue this ``SubmitUpdate``, then whoever
        wins the dispatch lock drains EVERY pending submit through one
        ``endpoint.submit_batch`` call (one ``apply_batch_flat`` on a real
        applier) and sends every drained reply — under the lock, like
        ordinary dispatch, so reply frames never interleave with pushed
        notifications. A thread whose entry was drained by another finds its
        event already set and just returns to ``recv``. With the op log on,
        replies go out only AFTER the drained ops are fsynced (durability
        before acknowledgement); ``wrap`` carries the ``Forward.seq`` of a
        submit that arrived forwarded from a peer gateway."""
        entry = (msg, channel, threading.Event(), wrap)
        with self._submit_lock:
            self._submit_pending.append(entry)
        pendings: list = []
        batch: list = []
        sends: list = []
        try:
            with self._lock:
                with self._submit_lock:
                    batch, self._submit_pending = self._submit_pending, []
                if batch:
                    replies = self.endpoint.submit_batch(
                        [e[0] for e in batch])
                    if self._oplog is not None:
                        sends = list(zip(batch, replies))
                    else:
                        for e, reply in zip(batch, replies):
                            self._send_submit_reply(e, reply)
                    for e in batch:
                        p = self._maybe_snapshot(e[0])
                        if p is not None:
                            pendings.append(p)
                    if self.ds.latest_version >= self.n_updates:
                        self.done.set()
            if sends:
                self._flush_oplog()
                with self._lock:
                    for e, reply in sends:
                        self._send_submit_reply(e, reply)
        finally:
            for e in batch:
                e[2].set()
        for p in pendings:
            self._write_snapshot(*p)
        self._drain_outbox()
        entry[2].wait()

    def _serve_conn(self, conn: socket.socket) -> None:
        channel = self._open_channel(conn)
        if channel is None:
            return
        consumer = None
        try:
            while True:
                try:
                    msg = channel.recv()
                except socket.timeout:
                    if self._closed.is_set():
                        break
                    continue             # idle connection: read again
                if msg is None:
                    break
                if isinstance(msg, Forward) and \
                        isinstance(msg.inner, SubmitUpdate) and \
                        self.applier is not None:
                    # a peer forwarded a submit to us (the model owner):
                    # same combining drain, reply wrapped by its seq
                    self._await_ownership(MODEL_KEY)
                    self._submit_drain(msg.inner, channel, wrap=msg.seq)
                    continue
                if isinstance(msg, SubmitUpdate) and \
                        self.applier is not None:
                    if self.ring is not None and \
                            self._owner_for(MODEL_KEY) != self.gid:
                        reply = self._forward_retry(MODEL_KEY, msg)
                        self._observe_version(reply)
                        with self._lock:
                            channel.send(reply)
                        continue
                    self._submit_drain(msg, channel)
                    continue
                if self.ring is not None:
                    if isinstance(msg, Forward):
                        # dispatch the envelope locally: endpoint.handle
                        # unwraps, records remote consumers, wraps the reply
                        self._await_ownership(self._route_key(msg.inner))
                    elif self._route_cluster(msg, channel):
                        continue
                with self._lock:
                    if isinstance(msg, Hello):
                        consumer = msg.consumer
                        self._conns[consumer] = channel
                    reply = self.endpoint.handle(msg)
                    if self._oplog is None:
                        channel.send(reply)
                    pending = self._maybe_snapshot(msg)
                    if self.ds.latest_version >= self.n_updates:
                        self.done.set()
                if self._oplog is not None:
                    # durability before acknowledgement: the op reaches
                    # disk before the client ever sees its reply
                    self._flush_oplog()
                    with self._lock:
                        channel.send(reply)
                if pending is not None:
                    self._write_snapshot(*pending)
                self._drain_outbox()
        finally:
            with self._lock:
                if consumer is not None \
                        and self._conns.get(consumer) is channel:
                    del self._conns[consumer]
                    # EVERY teardown path lands here — clean Bye, kill -9,
                    # a corrupt length prefix, or a mid-frame stall — and a
                    # disconnected consumer can never serve a wake: drop
                    # its queue waiters so they stop consuming one-shot
                    # events other volunteers need. Its LEASES stay — that
                    # recovery is deliberately the sweeper's (it may
                    # reconnect and heartbeat; only real death expires them).
                    self.endpoint.disconnect(consumer)
            channel.close()

    def serve_forever(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue                 # no caller this poll: check close
            except OSError:
                return
            conn.settimeout(SOCKET_POLL)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def start(self) -> threading.Thread:
        threading.Thread(target=self._sweep_loop, daemon=True).start()
        if self.ring is not None:
            threading.Thread(target=self._failover_loop, daemon=True).start()
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self._closed.set()
        self._sock.close()
        with self._peers_lock:
            links, self._peers = dict(self._peers), {}
        for link in links.values():
            link.close()


# ---------------------------------------------------------------------------
# client transport
# ---------------------------------------------------------------------------

def _connect_with_retry(host: str, port: int,
                        connect_timeout: float) -> socket.socket:
    deadline = _CLOCK.now() + connect_timeout
    last_err = None
    while True:                      # the server may still be binding
        try:
            sock = socket.create_connection((host, port), timeout=30)
            # the connect timeout must not linger: every later read polls
            # at SOCKET_POLL and checks for close between polls
            sock.settimeout(SOCKET_POLL)
            return sock
        except OSError as e:
            last_err = e
            if _CLOCK.now() >= deadline:
                raise ConnectionError(
                    f"gateway at {host}:{port} unreachable: {last_err}")
            time.sleep(0.05)


class _FramedClientTransport(Transport):
    """Blocking request/reply over a gateway socket; pushed notification
    frames are stashed (or blocked for) rather than delivered by callback.
    Subclasses supply the framing dialect via ``_setup``/``_send_msg``/
    ``_recv_msg``; everything above the frame boundary — the reply loop,
    the notification inbox, the request histogram — is dialect-blind.

    ``_recv_msg`` contract: return the next protocol message; return None
    when the connection is over (close, reset, torn frame, protocol
    error); raise ``socket.timeout`` ONLY for a clean idle timeout with
    the stream still aligned on a frame boundary. The socket polls at
    ``SOCKET_POLL``: every wait above the frame boundary is a loop of
    such reads that stops once this transport is closed."""

    timed_waits = True               # wait_notification accepts a timeout
    dialect = "?"

    def __init__(self, host: str, port: int, consumer: str,
                 connect_timeout: float = 10.0):
        self.sock = _connect_with_retry(host, port, connect_timeout)
        self.inbox: Deque = deque()
        self.consumer = consumer
        self.bytes_moved = 0
        self.sent: Dict[str, int] = {}   # request-type histogram (observable:
        #                                  the applier path sends no PublishModel)
        try:
            self._setup()
            self.call(Hello(consumer))
        except (OSError, ConnectionError):
            self.sock.close()
            raise

    def _setup(self) -> None:
        """Dialect handshake, run once before the Hello."""

    def _send_msg(self, msg) -> int:
        raise NotImplementedError

    def _recv_msg(self):
        raise NotImplementedError

    def set_deliver(self, deliver) -> None:
        """A socket transport is a BLOCKING client port: notifications are
        consumed via ``wait_notification``/``inbox``, never pushed through a
        callback — so the virtual-clock engines (which need synchronous
        delivery) cannot run over it. Fail loudly instead of deadlocking."""
        raise RuntimeError(
            f"{type(self).__name__} has no callback delivery; drive it "
            "with a blocking client loop (gateway.run_volunteer), not an "
            "engine")

    def _closed(self) -> bool:
        return self.sock.fileno() == -1

    def _poll_msg(self, limit: Optional[float] = REPLY_TIMEOUT):
        """``_recv_msg`` over as many ``SOCKET_POLL`` reads as it takes:
        ``socket.timeout`` only once ``limit`` seconds (None: no limit)
        have passed with no frame; ConnectionError once the transport is
        closed."""
        deadline = None if limit is None else _CLOCK.now() + limit
        while True:
            try:
                return self._recv_msg()
            except socket.timeout:
                if self._closed():
                    raise ConnectionError("transport closed") from None
                if deadline is not None and _CLOCK.now() >= deadline:
                    raise

    def call(self, msg):
        name = type(msg).__name__
        self.sent[name] = self.sent.get(name, 0) + 1
        self.bytes_moved += self._send_msg(msg)
        while True:
            try:
                reply = self._poll_msg()
            except socket.timeout:
                raise ConnectionError(
                    f"gateway sent no reply to {name} in "
                    f"{REPLY_TIMEOUT:.0f}s") from None
            if reply is None:
                raise ConnectionError("gateway closed the connection")
            if isinstance(reply, NOTIFICATION_TYPES):
                self.inbox.append(reply)
                continue
            return reply

    def wait_notification(self, timeout: Optional[float] = None):
        """Block until the server pushes a Wake/VersionReady frame. With a
        ``timeout``, return None when nothing arrives in time — the caller's
        cue to heartbeat its lease and re-check state. Without one, wait in
        ``SOCKET_POLL`` reads until a frame arrives or the transport is
        closed."""
        if self.inbox:
            return self.inbox.popleft()
        try:
            if timeout is not None:
                with _sock_timeout(self.sock, timeout):
                    msg = self._recv_msg()
            else:
                msg = self._poll_msg(limit=None)
        except socket.timeout:
            return None
        if msg is None:
            raise ConnectionError("gateway closed while waiting")
        if not isinstance(msg, NOTIFICATION_TYPES):
            raise RuntimeError(f"unexpected frame while idle: {msg}")
        return msg

    def close(self) -> None:
        self.sock.close()


class SocketTransport(_FramedClientTransport):
    """The native length-prefixed dialect (docs/protocol.md)."""

    dialect = "tcp"

    def _send_msg(self, msg) -> int:
        return _send_frame(self.sock, msg)

    def _recv_msg(self):
        return _recv_frame(self.sock)


class WsClientTransport(_FramedClientTransport):
    """The RFC 6455 dialect — what a browser's WebSocket object speaks.

    Each protocol message rides as one masked binary WS message; pings
    from the server are answered transparently; a Close frame or any
    framing violation ends the connection cleanly (None from
    ``_recv_msg`` -> ConnectionError upstream, same as the TCP dialect).
    """

    dialect = "ws"

    def _setup(self) -> None:
        self.framer = wsframing.client_framer()
        self._events: Deque = deque()
        request, key = wsframing.client_handshake_request(
            f"{self.sock.getpeername()[0]}:{self.sock.getpeername()[1]}")
        handshake = wsframing.ClientHandshake(key)
        try:
            with _sock_timeout(self.sock, HANDSHAKE_TIMEOUT):
                self.sock.sendall(request)
                while not handshake.done:
                    data = self.sock.recv(4096)
                    if not data:
                        raise ConnectionError(
                            "gateway closed during ws handshake")
                    handshake.feed(data)
        except socket.timeout:
            raise ConnectionError("ws handshake timed out") from None
        except wsframing.WsProtocolError as e:
            raise ConnectionError(f"ws handshake failed: {e}") from e
        if handshake.leftover:
            self._events.extend(self.framer.feed(handshake.leftover))

    def _send_msg(self, msg) -> int:
        frame = self.framer.send_message(encode_message(msg))
        self.sock.sendall(frame)
        return len(frame)

    def _recv_msg(self):
        while True:
            while self._events:
                ev = self._events.popleft()
                if isinstance(ev, wsframing.Message):
                    return decode_message(ev.data)
                if isinstance(ev, wsframing.Ping):
                    self.sock.sendall(self.framer.pong(ev.data))
                elif isinstance(ev, wsframing.Closed):
                    return None
                # Pong: ignore
            try:
                if self.framer.mid_frame:
                    # a timeout may not surface mid-frame (stream desync);
                    # scope the stall window exactly like the TCP dialect
                    with _sock_timeout(self.sock, FRAME_STALL_TIMEOUT):
                        try:
                            data = self.sock.recv(_RECV_CHUNK)
                        except socket.timeout:
                            return None     # stalled mid-frame: peer is dead
                else:
                    data = self.sock.recv(_RECV_CHUNK)  # may raise (idle)
            except socket.timeout:
                raise
            except OSError:
                return None
            if not data:
                return None
            try:
                self._events.extend(self.framer.feed(data))
            except wsframing.WsProtocolError as e:
                log.error("ws protocol error from gateway: %s -- closing", e)
                return None

    def close(self) -> None:
        try:
            self.sock.sendall(self.framer.close())
        except OSError:
            pass
        self.sock.close()


_DIALECTS = {"tcp": SocketTransport, "ws": WsClientTransport}


# ---------------------------------------------------------------------------
# the engine-free volunteer
# ---------------------------------------------------------------------------

def _wait(transport: Transport, inbox: Deque,
          timeout: Optional[float] = None, *, holding: bool = False) -> bool:
    """Wait for the next notification. Returns False on a timed-out wait
    (the caller should heartbeat its lease and re-check state). ``holding``
    says whether the caller still holds a leased ticket — an UNTIMED wait
    while holding is the PARKED-HOLDER invariant the runtime monitor checks
    (PR 5's step-aside deadlock: if that ticket is the last progressable
    task, nothing can ever wake the parked holder)."""
    if inbox:
        inbox.popleft()
        return True
    waiter = getattr(transport, "wait_notification", None)
    if waiter is None:
        raise RuntimeError(
            "volunteer blocked on a transport that cannot wait — with no "
            "other actors this is a protocol deadlock")
    timed = timeout is not None and getattr(transport, "timed_waits", False)
    mon = _monitor()
    if mon is not None:
        mon.note_park("volunteer-wait", holding=holding, timed=timed)
    if timed:
        return waiter(timeout) is not None
    waiter()
    return True


def run_volunteer(transport: Transport, vid: str, n_updates: int, *,
                  policy: PolicyLike = None, task_delay: float = 0.0,
                  heartbeat_every: float = 0.5,
                  tally: Optional[list] = None,
                  problem: Optional[TrainingProblem] = None
                  ) -> Tuple[int, int]:
    """Drive one volunteer to run completion over any transport. Compute is
    synthetic (gradient payloads None, model blobs version strings);
    ``task_delay`` sleeps that long per compute — the window the chaos legs
    use to kill a process mid-task. Barrierless policies commit through the
    server-side applier (one ``SubmitUpdate``, no model push). On transports
    with timed waits, every wait wakes at least each ``heartbeat_every``
    seconds to renew the held lease (``ExtendLease``) and re-check state —
    so a LIVE volunteer parked on the reduce barrier never loses its ticket
    to the wall-clock sweeper, while a dead one's expires on schedule.
    ``tally`` (a one-element list) is incremented per completed task IN
    PLACE, so a caller surviving this function's ConnectionError still sees
    the partial count. Returns (final_version, tasks_done)."""
    pol = make_policy(policy)
    sess = VolunteerSession(vid, transport, policy=pol)
    inbox: Deque = getattr(transport, "inbox", None)
    if inbox is None:
        inbox = deque()
        transport.set_deliver(lambda c, m: inbox.append(m))
    # end-of-run nudge: a volunteer idling on the task queue when ANOTHER
    # volunteer publishes the final version would otherwise wait forever —
    # the VersionReady push for the final version breaks that wait
    sess.subscribe(Blocked(version=n_updates))
    tasks_done = 0

    def bump():
        nonlocal tasks_done
        tasks_done += 1
        if tally is not None:
            tally[0] += 1

    def compute_delay():
        # simulate slow compute in heartbeat-sized slices, renewing the held
        # lease between them — a LIVE volunteer must keep its ticket through
        # a compute longer than the visibility timeout (only kill -9 stops
        # the renewals, which is exactly when the sweeper SHOULD requeue)
        end = _CLOCK.now() + task_delay
        while True:
            rem = end - _CLOCK.now()
            if rem <= 0:
                return
            time.sleep(min(rem, heartbeat_every))
            sess.heartbeat()

    while True:
        if sess.task is None:
            # termination is only checked while idle — while a task is held,
            # advance()'s own LatestReq covers staleness, so the socket path
            # pays one version poll per task, not one per protocol move
            if sess.latest() >= n_updates:
                break
            if isinstance(sess.lease(0.0), NoTask):
                sess.subscribe_idle()
                _wait(transport, inbox, heartbeat_every)
                continue
        out = sess.advance(0.0)
        if isinstance(out, Blocked):
            sess.subscribe(out)
            woke = _wait(transport, inbox, heartbeat_every,
                         holding=sess.task is not None)
            # renew on EVERY wakeup, not just timeouts: a dense stream of
            # (spurious) wakes must not starve the renewal of a held lease
            sess.heartbeat()
            if not woke:
                if sess.latest() >= n_updates:
                    break            # run finished while we were parked; the
                    #                  held ticket requeues via bye() below
                # deadlock breaker: a holder still blocked after a full wait
                # window steps aside while OTHER tasks are leasable —
                # requeue to the BACK (order-safe: a version-blocked map
                # cannot run before its version commits, and a reduce's
                # barrier state lives in the results queue, not the ticket)
                # and take the front task instead. The queue becomes a slow
                # rotation that always finds the one progressable task —
                # e.g. the expiry-recovered map an open barrier is missing —
                # where a fleet of parked holders would deadlock.
                if sess.task is not None and sess.queue_depth() > 0:
                    sess.release(front=False)
            continue
        if isinstance(out, TaskDone):
            continue
        if task_delay > 0:
            compute_delay()
        if isinstance(out, MapWork):
            if pol.barrier:
                if not sess.finish_map(None, 0, 0.0).stale:
                    bump()
            else:
                if problem is not None:
                    # real compute: gradient of this stream slot at the
                    # fetched latest model — pushed to the server's real
                    # applier through the same SubmitUpdate
                    t = out.task
                    g, loss = problem.map_compute(out.model[0], t.version,
                                                  t.mb_index)
                    res = sess.grad_result(g, problem.grad_bytes, loss)
                else:
                    res = sess.grad_result(None, 0, 0.0)
                if not sess.submit_update(res).stale:
                    bump()
        elif isinstance(out, LocalWork):
            if problem is not None:
                t = out.task
                p0, s0 = out.model
                delta, loss = problem.local_compute(p0, s0, t.start, t.k)
                res = sess.delta_result(delta, problem.model_bytes, loss)
            else:
                res = sess.delta_result(None, 0, 0.0)
            if not sess.submit_update(res).stale:
                bump()
        elif isinstance(out, ReduceWork):
            sess.finish_reduce(f"v{out.task.version + 1}")
            bump()
    final = sess.latest()
    sess.bye()
    return final, tasks_done


def run_volunteer_resilient(host: str, port: int, vid: str, n_updates: int, *,
                            policy: PolicyLike = None, task_delay: float = 0.0,
                            max_reconnects: int = 20, dialect: str = "tcp",
                            problem: Optional[TrainingProblem] = None,
                            fallback_ports: Tuple[int, ...] = (),
                            ) -> Tuple[int, int, int]:
    """``run_volunteer`` that survives gateway crashes: on a connection error
    it reconnects (fresh transport + session, same consumer id) and resumes.
    A lease the dead attempt held is recovered by the server's wall-clock
    sweeper, so no work is lost — only possibly repeated (at-least-once).
    ``dialect`` picks the framing ("tcp" native, "ws" RFC 6455).
    ``fallback_ports`` are alternative gateways (a multi-gateway cluster)
    tried round-robin on each reconnect, so a volunteer whose HOME gateway
    is kill -9'd rejoins the run through a surviving peer.
    Returns (final_version, tasks_done_total, reconnects)."""
    transport_cls = _DIALECTS[dialect]
    ports = [port, *fallback_ports]
    # a lone gateway may restart on its port (wait generously); a cluster
    # volunteer should fail fast and rotate to the next surviving gateway
    connect_timeout = 15.0 if len(ports) == 1 else 3.0
    tally = [0]
    reconnects = -1
    while True:
        reconnects += 1
        if reconnects > max_reconnects:
            raise ConnectionError(
                f"{vid}: gave up after {max_reconnects} reconnects")
        try:
            transport = transport_cls(host, ports[reconnects % len(ports)],
                                      vid, connect_timeout=connect_timeout)
        except ConnectionError:
            continue
        try:
            final, _ = run_volunteer(transport, vid, n_updates,
                                     policy=policy, task_delay=task_delay,
                                     tally=tally, problem=problem)
            return final, tally[0], reconnects
        except ConnectionError:
            # server died mid-run; partial progress is already durable
            # server-side (acked tasks) or recoverable (leases expire)
            continue
        finally:
            try:
                transport.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _real_problem(seed: int = 0, device=None) -> TrainingProblem:
    """Seed-deterministic shrunk REAL problem for ``--real-apply`` runs: the
    paper model family at d_model=8 on the hermetic synthetic corpus, on
    ``device`` (the card unless "cpu"). Every term is seeded (corpus,
    schedule hashes, init generator), so a volunteer process building this
    independently computes gradients the server's applier chains
    bit-exactly on the same device."""
    from repro_torch.configs.paper_lstm import TrainParams
    from repro_torch.data.text import synthetic_corpus
    tp = TrainParams(batch_size=32, examples_per_epoch=256, num_epochs=1,
                     sample_len=40, mini_batch_size=8,
                     mini_batches_to_accumulate=4)
    return TrainingProblem.paper_problem(corpus=synthetic_corpus(20_000),
                                         tp=tp, seed=seed, d_model=8,
                                         device=device)


def _problem(args):
    if getattr(args, "real_apply", False):
        return _real_problem(device=args.device)
    return SyntheticProblem(n_versions=args.n_versions, n_mb=args.n_mb)


def _target(args) -> int:
    return make_policy(args.policy).n_updates(_problem(args), args.n_versions)


def _serve(args) -> int:
    server = GatewayServer(
        _problem(args), port=args.port, n_versions=args.n_versions,
        policy=args.policy, n_shards=args.shards,
        visibility_timeout=args.visibility_timeout,
        snapshot_path=args.snapshot_path, snapshot_every=args.snapshot_every,
        restore_from=args.restore_from, real_apply=args.real_apply,
        gid=args.gid, gateways=args.gateways, cluster_dir=args.cluster_dir)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)         # atomic: readers never see ""
    who = f"gateway gw{args.gid}/{args.gateways}" if args.gateways > 1 \
        else "gateway"
    print(f"{who}: serving {args.n_versions} versions x "
          f"{args.n_mb}+1 tasks (policy={server.policy.spec}, "
          f"target={server.n_updates}, "
          f"vt={args.visibility_timeout}) on 127.0.0.1:{server.port}"
          + (f" [restored from {args.restore_from}]" if args.restore_from
             else ""), flush=True)
    server.start()
    server.done.wait(timeout=args.timeout)
    # linger until connected volunteers finish their goodbyes (Bye + close);
    # generous, because a volunteer parked in a timed wait notices the end
    # of the run on its next wakeup, not instantly. Inter-gateway links
    # ("gw:" consumers) are not volunteers — peers exit on their own clock.
    deadline = _CLOCK.now() + 20.0
    while any(not c.startswith("gw:") for c in server._conns) \
            and _CLOCK.now() < deadline:
        time.sleep(0.02)
    ok = server.observed_version >= server.n_updates
    applier_stats = ""
    if args.real_apply and server.applier is not None:
        ap = server.applier
        applier_stats = (f" applied={ap.applied} rejected={ap.rejected} "
                         f"batches={ap.batches} "
                         f"batched_updates={ap.batched_updates}")
    print(f"{who}: final_version={server.observed_version} "
          f"snapshots={server.snapshots_written} "
          f"({'done' if ok else 'TIMEOUT'})" + applier_stats, flush=True)
    server.close()
    return 0 if ok else 1


def _volunteer(args) -> int:
    n_updates = _target(args)
    fallback = tuple(int(p) for p in args.ports.split(",") if p) \
        if args.ports else ()
    final, tasks, reconnects = run_volunteer_resilient(
        "127.0.0.1", args.port, args.vid, n_updates, policy=args.policy,
        task_delay=args.task_delay, dialect=args.dialect,
        problem=_problem(args) if args.real_apply else None,
        fallback_ports=fallback)
    print(f"volunteer {args.vid} [{args.dialect}]: final_version={final} "
          f"tasks={tasks} reconnects={reconnects}", flush=True)
    if args.expect_final is not None and final != args.expect_final:
        print(f"FAIL: expected final_version={args.expect_final}")
        return 1
    return 0


def _spawn_server(args, port_file: str, *, port: int = 0,
                  extra: Tuple[str, ...] = ()) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.gateway", "--serve",
         "--port", str(port), "--port-file", port_file,
         "--n-versions", str(args.n_versions), "--n-mb", str(args.n_mb),
         *_device_args(args), *extra],
        env=os.environ.copy())


def _device_args(args) -> Tuple[str, ...]:
    """``--device`` for a spawned gateway process, as this one was given."""
    return ("--device", args.device) if args.device else ()


def _reap(*procs: Optional[subprocess.Popen]) -> None:
    """Kill every child still running and wait (bounded) for it to go."""
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                log.error("child %d survived kill -9", p.pid)


def _wait_port(port_file: str, proc: subprocess.Popen,
               timeout: float = 20.0) -> int:
    deadline = _CLOCK.now() + timeout
    while not os.path.exists(port_file):
        if _CLOCK.now() > deadline or proc.poll() is not None:
            raise RuntimeError("gateway server did not come up")
        time.sleep(0.05)
    with open(port_file) as f:
        return int(f.read())


def _smoke_transport_equivalence(args) -> None:
    """Leg 1 — the identical volunteer loop over (a) direct calls and (b) a
    real socket to a separate gateway PROCESS must agree."""
    server = GatewayServer(_problem(args), n_versions=args.n_versions)
    ref_final, ref_tasks = run_volunteer(
        InProcessTransport(server.endpoint), "ref", args.n_versions)
    server.close()
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        proc = _spawn_server(args, port_file)
        try:
            port = _wait_port(port_file, proc)
            transport = SocketTransport("127.0.0.1", port, "gw0")
            final, tasks = run_volunteer(transport, "gw0", args.n_versions)
            transport.close()
            rc = proc.wait(timeout=10)
        finally:
            _reap(proc)
    n_tasks = args.n_versions * (args.n_mb + 1)
    assert final == ref_final == args.n_versions, (final, ref_final)
    assert tasks == ref_tasks == n_tasks, (tasks, ref_tasks, n_tasks)
    assert rc == 0, f"gateway server exited {rc}"
    print(f"# OK gateway smoke [transport]: out-of-process volunteer over "
          f"the socket matched in-process — final_version={final}, "
          f"tasks={tasks}")


def _smoke_lease_sweeper(args) -> None:
    """Leg 2 — kill -9 a real volunteer PROCESS mid-task: its lease must
    expire on the wall clock (sweeper thread), the ticket requeue, and the
    surviving volunteers finish the whole run. Two survivors, because the
    recovered map task needs an IDLE taker if the other survivor is already
    holding the reduce barrier."""
    vt = 1.0
    n_tasks = args.n_versions * (args.n_mb + 1)
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        proc = _spawn_server(args, port_file,
                             extra=("--visibility-timeout", str(vt)))
        victim = None
        try:
            port = _wait_port(port_file, proc)
            # the victim sleeps 30 s inside every compute, so once it LEASES
            # it is holding that lease when killed (and can never finish)
            victim = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.gateway", "--volunteer",
                 "--port", str(port), "--vid", "victim",
                 "--n-versions", str(args.n_versions),
                 "--n-mb", str(args.n_mb), "--task-delay", "30"],
                env=os.environ.copy())
            # wait until the victim has genuinely leased: the task queue's
            # depth drops below the full schedule (DepthReq is read-only)
            from repro_torch.core.protocol import DepthReq
            from repro_torch.core.tasks import INITIAL_QUEUE
            monitor = SocketTransport("127.0.0.1", port, "monitor")
            deadline = _CLOCK.now() + 30.0
            while monitor.call(DepthReq(INITIAL_QUEUE)).value >= n_tasks:
                assert _CLOCK.now() < deadline, "victim never leased"
                time.sleep(0.05)
            monitor.close()
            victim.send_signal(signal.SIGKILL)
            victim.wait(timeout=10)
            t0 = _CLOCK.now()
            results: Dict[str, Tuple[int, int]] = {}

            def survive(vid: str) -> None:
                tr = SocketTransport("127.0.0.1", port, vid)
                results[vid] = run_volunteer(tr, vid, args.n_versions)
                tr.close()

            threads = [threading.Thread(target=survive, args=(f"s{i}",),
                                        daemon=True) for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
                assert not th.is_alive(), "survivor deadlocked"
            wall = _CLOCK.now() - t0
            rc = proc.wait(timeout=15)
        finally:
            _reap(victim, proc)
    finals = [results[v][0] for v in sorted(results)]
    tasks = sum(results[v][1] for v in sorted(results))
    assert finals == [args.n_versions] * 2, f"run did not finish: {finals}"
    assert tasks >= n_tasks, f"tasks lost: {tasks} < {n_tasks}"
    assert rc == 0, f"gateway server exited {rc}"
    print(f"# OK gateway smoke [lease-sweeper]: victim volunteer kill -9'd "
          f"mid-task; wall-clock sweeper requeued its lease (vt={vt}s) and "
          f"2 survivors finished the run ({tasks} tasks) in {wall:.1f}s")


def _smoke_crash_recovery(args) -> None:
    """Leg 3 — kill -9 the SERVER mid-run, restart from the latest snapshot:
    the volunteer reconnects and the run completes with the same final
    version as the uninterrupted single-process reference (tasks may repeat:
    at-least-once)."""
    # uninterrupted reference (in process, same problem)
    server = GatewayServer(_problem(args), n_versions=args.n_versions)
    ref_final, ref_tasks = run_volunteer(
        InProcessTransport(server.endpoint), "ref", args.n_versions)
    server.close()
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        snap = os.path.join(td, "gw.snap")
        durable = ("--visibility-timeout", "1.0",
                   "--snapshot-every", "1", "--snapshot-path", snap)
        proc = _spawn_server(args, port_file, extra=durable)
        out: Dict[str, Tuple[int, int, int]] = {}
        try:
            port = _wait_port(port_file, proc)

            def drive():
                out["v"] = run_volunteer_resilient(
                    "127.0.0.1", port, "gw0", args.n_versions,
                    task_delay=0.06)

            vt = threading.Thread(target=drive, daemon=True)
            vt.start()
            time.sleep(0.8)                      # mid-run (15 tasks x ~60ms+)
            proc.send_signal(signal.SIGKILL)     # no goodbye, no final flush
            proc.wait(timeout=10)
            assert os.path.exists(snap), "server died before any snapshot"
            # restart on the SAME port from the latest snapshot
            proc = _spawn_server(args, port_file, port=port,
                                 extra=durable + ("--restore-from", snap))
            vt.join(timeout=60)
            assert not vt.is_alive(), "volunteer never finished after restart"
            rc = proc.wait(timeout=15)
        finally:
            _reap(proc)
    final, tasks, reconnects = out["v"]
    assert final == ref_final == args.n_versions, (final, ref_final)
    assert tasks >= ref_tasks, f"lost work: {tasks} < {ref_tasks}"
    assert reconnects >= 1, "volunteer never observed the crash"
    assert rc == 0, f"restarted gateway exited {rc}"
    print(f"# OK gateway smoke [crash-recovery]: server kill -9'd mid-run, "
          f"restarted from snapshot, run resumed and matched the "
          f"uninterrupted final version v{final} "
          f"(tasks {tasks} >= {ref_tasks} ref; {reconnects} reconnect)")


def _smoke_server_applier(args) -> None:
    """Leg 4 — barrierless policy over the socket: the server-side applier
    commits every admitted gradient, so the volunteer's wire histogram shows
    ZERO model pushes and zero admission fetches — the bytes-per-update win
    ``benchmarks/staleness.py`` quantifies."""
    policy = "staleness:2"
    n_updates = make_policy(policy).n_updates(_problem(args), args.n_versions)
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        proc = _spawn_server(args, port_file, extra=("--policy", policy))
        try:
            port = _wait_port(port_file, proc)
            transport = SocketTransport("127.0.0.1", port, "thin0")
            final, tasks = run_volunteer(transport, "thin0", n_updates,
                                         policy=policy)
            sent = dict(transport.sent)
            transport.close()
            rc = proc.wait(timeout=10)
        finally:
            _reap(proc)
    assert final == n_updates, (final, n_updates)
    assert sent.get("SubmitUpdate", 0) == tasks > 0, sent
    assert "PublishModel" not in sent, f"thin client pushed a model: {sent}"
    assert rc == 0, f"gateway server exited {rc}"
    print(f"# OK gateway smoke [server-applier]: {policy} over the socket — "
          f"{tasks} updates committed via SubmitUpdate, volunteer sent "
          f"0 PublishModel frames (server applied every gradient)")


# seconds of simulated compute a task in the legs where two volunteer
# processes must share one run: a process takes seconds to start, a
# synthetic run of 28 tasks well under one
_SHARED_RUN_DELAY = 0.1


def _smoke_ws_dialect(args) -> None:
    """Leg 5 — one port, two framing dialects: a WebSocket-framed volunteer
    PROCESS and a native-TCP volunteer PROCESS join the SAME gateway run and
    must both observe the identical (bit-identical) final model version.
    Each volunteer spends ``_SHARED_RUN_DELAY`` a task, so the first to
    connect cannot finish the whole run (and the gateway exit) before the
    second process has started."""
    n_tasks = args.n_versions * (args.n_mb + 1)
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        proc = _spawn_server(args, port_file)
        volunteers = []
        try:
            port = _wait_port(port_file, proc)
            for vid, dialect in (("ws0", "ws"), ("tcp0", "tcp")):
                volunteers.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.core.gateway",
                     "--volunteer", "--port", str(port), "--vid", vid,
                     "--dialect", dialect,
                     "--n-versions", str(args.n_versions),
                     "--n-mb", str(args.n_mb),
                     "--task-delay", str(_SHARED_RUN_DELAY),
                     "--expect-final", str(args.n_versions)],
                    env=os.environ.copy()))
            rcs = [v.wait(timeout=90) for v in volunteers]
            rc = proc.wait(timeout=15)
        finally:
            _reap(*volunteers, proc)
    assert rcs == [0, 0], f"volunteer processes exited {rcs}"
    assert rc == 0, f"gateway server exited {rc}"
    print(f"# OK gateway smoke [ws-dialect]: a WebSocket volunteer and a "
          f"TCP volunteer shared one gateway port and finished the same "
          f"{n_tasks}-task run at the identical final version "
          f"v{args.n_versions}")


def _smoke_browser_thin(args) -> None:
    """Leg 6 — the browser tier end to end: a ``repro_torch.core.browser`` thin
    client PROCESS (WebSocket framing, lease/fetch-latest/SubmitUpdate only)
    and a TCP volunteer finish a barrierless run; the browser client asserts
    ZERO PublishModel frames itself (MLitB's thin-client contract). Both
    pace their tasks as in the ws-dialect leg."""
    policy = "staleness:2"
    n_updates = make_policy(policy).n_updates(_problem(args), args.n_versions)
    with tempfile.TemporaryDirectory() as td:
        port_file = os.path.join(td, "gw.port")
        proc = _spawn_server(args, port_file, extra=("--policy", policy))
        browser = tcp = None
        try:
            port = _wait_port(port_file, proc)
            browser = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.browser",
                 "--port", str(port), "--vid", "browser0",
                 "--policy", policy,
                 "--n-versions", str(args.n_versions),
                 "--n-mb", str(args.n_mb),
                 "--task-delay", str(_SHARED_RUN_DELAY),
                 "--expect-final", str(n_updates)],
                env=os.environ.copy())
            tcp = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.gateway", "--volunteer",
                 "--port", str(port), "--vid", "tcp1", "--policy", policy,
                 "--n-versions", str(args.n_versions),
                 "--n-mb", str(args.n_mb),
                 "--task-delay", str(_SHARED_RUN_DELAY),
                 "--expect-final", str(n_updates)],
                env=os.environ.copy())
            rcs = [browser.wait(timeout=90), tcp.wait(timeout=90)]
            rc = proc.wait(timeout=15)
        finally:
            _reap(browser, tcp, proc)
    assert rcs == [0, 0], f"volunteer processes exited {rcs}"
    assert rc == 0, f"gateway server exited {rc}"
    print(f"# OK gateway smoke [browser-thin]: browser thin client over "
          f"WebSocket + TCP volunteer finished the {policy} run at "
          f"v{n_updates}; browser pushed zero PublishModel frames")


def _smoke_real_applier(args) -> None:
    """Leg 7 — the REAL PyTorch applier over the socket: (a) one real-compute
    volunteer against a ``--real-apply`` server PROCESS must land on a final
    model BIT-IDENTICAL to ``sequential_async`` (fetched back over the wire);
    (b) three concurrent real-compute volunteers must finish the run with
    contiguous versions — the combining-lock drain path under real races."""
    from repro_torch.core.mapreduce import sequential_async
    policy = "staleness:2"
    problem = _real_problem(device=args.device)
    n_versions = 2                       # 2 * n_mb(4) = 8 updates
    n_updates = make_policy(policy).n_updates(problem, n_versions)
    extra = ("--policy", policy, "--real-apply")

    def serve_run(vids):
        with tempfile.TemporaryDirectory() as td:
            port_file = os.path.join(td, "gw.port")
            proc = _spawn_server(
                args, port_file,
                extra=extra + ("--n-versions", str(n_versions)))
            try:
                port = _wait_port(port_file, proc)
                results: Dict[str, Tuple[int, int]] = {}

                def drive(vid: str) -> None:
                    tr = SocketTransport("127.0.0.1", port, vid)
                    results[vid] = run_volunteer(tr, vid, n_updates,
                                                 policy=policy,
                                                 problem=problem)
                    tr.close()

                threads = [threading.Thread(target=drive, args=(v,),
                                            daemon=True) for v in vids[1:]]
                for th in threads:
                    th.start()
                # the first vid runs on THIS thread and fetches the final
                # model over the wire before saying goodbye
                tr = SocketTransport("127.0.0.1", port, vids[0])
                results[vids[0]] = run_volunteer(tr, vids[0], n_updates,
                                                 policy=policy,
                                                 problem=problem)
                for th in threads:
                    th.join(timeout=120)
                    assert not th.is_alive(), "real volunteer deadlocked"
                final_blob = tr.call(FetchModel(n_updates)).blob
                tr.close()
                rc = proc.wait(timeout=15)
            finally:
                _reap(proc)
        assert rc == 0, f"gateway server exited {rc}"
        finals = [results[v][0] for v in sorted(results)]
        assert finals == [n_updates] * len(vids), finals
        return final_blob

    # (a) one volunteer: commit order is serialized, so the wire-fetched
    # final model must BIT-match the sequential reference
    blob = serve_run(["r0"])
    ref_p, ref_s, _ = sequential_async(problem, n_updates=n_updates)
    assert same_bits(blob, (ref_p, ref_s)), \
        "real-apply final model != sequential_async bits"
    # (b) three racing volunteers: liveness + a contiguous final version
    serve_run(["r0", "r1", "r2"])
    print(f"# OK gateway smoke [real-applier]: --real-apply served real "
          f"applies over the socket — 1-volunteer run bit-matched "
          f"sequential_async at v{n_updates}; 3 racing volunteers finished "
          f"the drained run")


def same_bits(a, b) -> bool:
    """Two model trees equal bit for bit, leaf by leaf (a model fetched over
    the wire has numpy leaves; one computed here has tensors, maybe on the
    card)."""
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x, y = (tree.to_device(v, "cpu") for v in (x, y))
        if x.shape != y.shape or x.dtype != y.dtype or \
                not torch.equal(x, y):
            return False
    return True


def _smoke_cluster(args) -> int:
    """``--smoke-cluster`` — the multi-gateway control plane under kill -9:
    three gateway PROCESSES share one consistent-hash ring; the MODEL
    owner is SIGKILLed mid-run; the deterministic adopter replays its op
    log, volunteers fail over to surviving ports, and the run completes at
    the reference final version (the chaos contract's wall-clock twin)."""
    k = 3
    target = _target(args)
    ring = GatewayRing(range(k))
    victim = ring.owner_of(MODEL_KEY)    # hardest slice: model state adopts
    with tempfile.TemporaryDirectory() as td:
        procs = []
        for gid in range(k):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.gateway", "--serve",
                 "--gid", str(gid), "--gateways", str(k),
                 "--cluster-dir", td,
                 "--n-versions", str(args.n_versions),
                 "--n-mb", str(args.n_mb), "--policy", args.policy,
                 "--visibility-timeout", "2.0", "--snapshot-every", "8",
                 "--timeout", "120"],
                env=os.environ.copy()))
        try:
            ports = []
            for gid in range(k):
                ports.append(_wait_port(os.path.join(td, f"gw{gid}.port"),
                                        procs[gid]))
            results: Dict[int, Tuple[int, int, int]] = {}

            def drive(i: int, home: int) -> None:
                order = [ports[home]] + [p for j, p in enumerate(ports)
                                         if j != home]
                results[i] = run_volunteer_resilient(
                    "127.0.0.1", order[0], f"cv{i}", target,
                    policy=args.policy, task_delay=0.15,
                    fallback_ports=tuple(order[1:]))

            # one volunteer homed on the victim (exercises port failover),
            # one on a survivor (exercises re-forwarding after adoption)
            homes = [victim, (victim + 1) % k]
            threads = [threading.Thread(target=drive, args=(i, h),
                                        daemon=True)
                       for i, h in enumerate(homes)]
            t0 = _CLOCK.now()
            for th in threads:
                th.start()
            time.sleep(1.0)                      # mid-run (28 tasks x 150ms)
            assert procs[victim].poll() is None, "victim exited early"
            procs[victim].send_signal(signal.SIGKILL)
            procs[victim].wait(timeout=10)
            for th in threads:
                th.join(timeout=110)
                assert not th.is_alive(), "cluster volunteer deadlocked"
            wall = _CLOCK.now() - t0
            rcs = [procs[g].wait(timeout=60) for g in range(k)
                   if g != victim]
        finally:
            _reap(*procs)
    finals = [results[i][0] for i in sorted(results)]
    reconnects = sum(results[i][2] for i in results)
    assert finals == [target] * 2, f"cluster run did not converge: {finals}"
    assert rcs == [0] * (k - 1), f"surviving gateways exited {rcs}"
    assert reconnects >= 1, "no volunteer ever observed the kill"
    print(f"# OK gateway smoke [cluster]: 3-gateway ring, model owner "
          f"gw{victim} kill -9'd mid-run; adopter replayed its op log and "
          f"every volunteer finished at v{target} "
          f"({reconnects} reconnects) in {wall:.1f}s")
    return 0


def _smoke(args) -> int:
    _smoke_transport_equivalence(args)
    _smoke_lease_sweeper(args)
    _smoke_crash_recovery(args)
    _smoke_server_applier(args)
    _smoke_ws_dialect(args)
    _smoke_browser_thin(args)
    _smoke_real_applier(args)
    print("# OK gateway smoke: all 7 legs green (transport equivalence, "
          "wall-clock lease sweeper, kill -9 crash recovery, server-side "
          "applier, ws dialect, browser thin client, real applier)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--serve", action="store_true")
    mode.add_argument("--volunteer", action="store_true")
    mode.add_argument("--smoke", action="store_true")
    mode.add_argument("--smoke-cluster", action="store_true",
                      help="multi-gateway leg: 3-process ring, model owner "
                           "kill -9'd mid-run, op-log failover completes it")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--gid", type=int, default=0,
                    help="serve: this gateway's id on the cluster ring")
    ap.add_argument("--gateways", type=int, default=1,
                    help="serve: ring size; >1 enables the multi-gateway "
                         "control plane (needs --cluster-dir)")
    ap.add_argument("--cluster-dir", default=None,
                    help="per-gateway op logs + port files; set with "
                         "--gateways 1 to get op-log durability alone")
    ap.add_argument("--ports", default=None,
                    help="volunteer: comma-separated fallback gateway ports "
                         "tried round-robin on reconnect")
    ap.add_argument("--port-file", default=None)
    ap.add_argument("--vid", default="gw0")
    ap.add_argument("--dialect", choices=sorted(_DIALECTS), default="tcp",
                    help="volunteer framing: native length-prefixed TCP or "
                         "RFC 6455 WebSocket (one server port serves both)")
    ap.add_argument("--n-versions", type=int, default=4)
    ap.add_argument("--n-mb", type=int, default=6)
    ap.add_argument("--policy", default="sync",
                    help="sync | staleness:<s> | local:<k> (barrierless "
                         "policies enable the server-side applier)")
    ap.add_argument("--real-apply", action="store_true",
                    help="serve: host the REAL PyTorch applier (batched "
                         "drains, measured blob sizes) on the seed-"
                         "deterministic shrunk paper problem; volunteer: "
                         "compute real gradients for the same problem")
    ap.add_argument("--device", default=None,
                    help="with --real-apply: where the problem computes "
                         "(default: the card; 'cpu' to run without one)")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--visibility-timeout", type=float, default=float("inf"),
                    help="wall-clock lease seconds before the sweeper "
                         "requeues an unacked task (default: infinite)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot after every K state-changing requests "
                         "(0 = never)")
    ap.add_argument("--snapshot-path", default=None)
    ap.add_argument("--restore-from", default=None,
                    help="boot from a snapshot instead of a fresh enqueue")
    ap.add_argument("--task-delay", type=float, default=0.0,
                    help="volunteer: sleep per compute (chaos kill window)")
    ap.add_argument("--expect-final", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    if args.serve:
        rc = _serve(args)
    elif args.volunteer:
        rc = _volunteer(args)
    elif args.smoke_cluster:
        rc = _smoke_cluster(args)
    else:
        rc = _smoke(args)
    mon = _monitor()
    if mon is not None:
        # instrumented runs fail on any recorded lock/invariant violation,
        # even if the protocol run itself succeeded
        rc = max(rc, mon.report())
    return rc


if __name__ == "__main__":
    sys.exit(main())
