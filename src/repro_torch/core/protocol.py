"""Sans-IO volunteer protocol: typed wire messages + the volunteer state machine.

The paper's volunteers talk to the queue/data servers over a network (browser
-> RabbitMQ/Redis); our engines used to hand-roll that conversation as direct
Python calls, each with a private copy of the protocol rules. This module makes
the protocol itself the product, the way Pando's pull/push message contract and
DistML.js's serializable command API do:

- **Messages** — every server interaction is a typed, immutable message
  (``LeaseReq``/``LeaseGrant``, ``Ack``, ``Nack``, ``PublishResult``,
  ``FetchModel``/``ModelBlob``, ``PublishModel``, ``WatchVersion``,
  ``SubscribeQueue`` and the async ``Wake``/``VersionReady`` notifications,
  ``Bye``...) with canonical byte serialization via
  ``checkpoint.serialize`` (msgpack + codec header byte), so any message —
  including a ``GradResult`` carrying a real gradient pytree — round-trips
  bytes losslessly.

- **ServerEndpoint** — the server half: dispatches one request message onto a
  ``QueueServer``/``DataServer`` pair and returns the reply message.
  Subscriptions are registered here; their fires are delivered as ``Wake`` /
  ``VersionReady`` notification messages through a ``notify(consumer, msg)``
  sink (the transport's downstream half). An optional ``LeaseClock`` makes
  the server the lease-time authority (the gateway's wall clock, an engine's
  virtual clock), and an optional ``ServerApplier`` serves the barrierless
  ``SubmitUpdate`` fast path: admission -> apply -> publish -> ack in one
  dispatch, so thin volunteers never fetch the admission-time model or push
  the updated blob.

- **VolunteerSession** — the sans-IO client state machine owning every
  protocol rule the engines used to duplicate: lease from the task queue ->
  (map) fetch model version, compute, publish gradient -> ack, or (reduce)
  check the barrier, drain + dedup the results queue, publish model v+1 ->
  ack — including the at-least-once edges (obsolete-duplicate ack without
  compute, incomplete-barrier nack + re-wait, dead-volunteer abort). The
  session performs **no IO and no compute**: server effects go through a
  ``Transport`` (``repro_torch.core.transport``) one message at a time, and compute
  is handed back to the engine as ``MapWork``/``ReduceWork`` outcomes — the
  Coordinator answers them with real PyTorch gradients, the Simulator with virtual
  time, and ``repro_torch.core.gateway``'s out-of-process volunteer with synthetic
  blobs over a socket. Waiting is likewise the engine's policy: the session
  says *what* to wait for (a ``Blocked`` outcome); the engine decides push
  (``subscribe``) vs poll.

  The protocol *shape* is set by the session's ``AggregationPolicy``
  (``repro_torch.core.aggregation``): barrier policies run the conversation above;
  barrierless ones (BoundedStaleness async SGD, LocalSteps averaging) run
  fetch-latest -> compute (``MapWork``/``LocalWork``) -> ``finish_update``
  admission on the version-stamped result -> ``commit_update`` — a too-stale
  result is discarded and its ticket nacked for a fresh recompute.

Port of ``repro/core/protocol.py``, whole: the messages and the endpoint are
framework-neutral. A tensor leaf crosses the wire as a host copy
(``checkpoint/serialize.py``); the ``ServerApplier``'s real backend is
``repro_torch.core.applier``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint import serialize
from repro_torch.core.aggregation import AggregationPolicy, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.tasks import (DeltaResult, GradResult, INITIAL_QUEUE,
                                    WIRE_TYPES, results_queue)

# ---------------------------------------------------------------------------
# wire registry + byte codec
# ---------------------------------------------------------------------------

_WIRE_TYPES: Dict[str, type] = {c.__name__: c for c in WIRE_TYPES}

_TAG = "__wire__"
_TUP = "__tuple__"


def wire(cls):
    """Register a dataclass as wire-encodable (by class name). Names are the
    wire schema, so a collision would silently re-route every byte stream —
    fail at import time instead."""
    if cls.__name__ in _WIRE_TYPES:       # not an assert: must survive -O
        raise ValueError(f"wire type name collision: {cls.__name__}")
    _WIRE_TYPES[cls.__name__] = cls
    return cls


def _to_obj(x):
    if dataclasses.is_dataclass(x) and type(x).__name__ in _WIRE_TYPES:
        return {_TAG: type(x).__name__,
                "f": {f.name: _to_obj(getattr(x, f.name))
                      for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {k: _to_obj(v) for k, v in x.items()}
    if isinstance(x, tuple):
        # msgpack would coerce tuples to lists; tag them so pytree structure
        # (e.g. a (params, opt_state) blob) survives the wire exactly.
        # Namedtuples decode as plain tuples.
        return {_TUP: [_to_obj(v) for v in x]}
    if isinstance(x, list):
        return [_to_obj(v) for v in x]
    return x


def _from_obj(x):
    if isinstance(x, dict):
        if _TAG in x:
            cls = _WIRE_TYPES[x[_TAG]]
            return cls(**{k: _from_obj(v) for k, v in x["f"].items()})
        if _TUP in x:
            return tuple(_from_obj(v) for v in x[_TUP])
        return {k: _from_obj(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_from_obj(v) for v in x]
    return x


def encode_message(msg, *, codec: Optional[str] = None) -> bytes:
    """Message -> canonical bytes. Uncompressed by default (protocol messages
    are small and latency-bound); pass codec="zlib"/"zstd" to compress bulky
    payloads (model blobs, dense gradients) through the serialize codecs."""
    return serialize.dumps(_to_obj(msg), compress=codec is not None,
                           codec=codec)


def decode_message(data: bytes):
    return _from_obj(serialize.loads(data))


def wire_size(msg, *, codec: Optional[str] = None) -> int:
    """Encoded size of a message — the cost-model observable."""
    return len(encode_message(msg, codec=codec))


# ---------------------------------------------------------------------------
# messages: requests
# ---------------------------------------------------------------------------

@wire
@dataclass(frozen=True)
class Hello:
    """Bind this connection to a consumer id (gateway registration)."""
    consumer: str


@wire
@dataclass(frozen=True)
class LeaseReq:
    queue: str
    consumer: str
    now: float
    timeout: Optional[float] = None


@wire
@dataclass(frozen=True)
class Ack:
    queue: str
    tag: int


@wire
@dataclass(frozen=True)
class Nack:
    """Voluntary give-back (dependency not ready); requeues at the front."""
    queue: str
    tag: int
    front: bool = True


@wire
@dataclass(frozen=True)
class ExtendLease:
    """Lease renewal (heartbeat): re-stamp the held tag's visibility deadline
    to now + timeout. A live consumer whose compute — or whose barrier wait —
    outlasts the visibility timeout sends this periodically so only DEAD
    consumers' leases expire. With a server clock installed ``now`` is
    ignored, like ``LeaseReq``. ``consumer`` is the receipt check: if the
    lease meanwhile expired and was re-granted to someone else, the renewal
    is refused (Ok(False)) instead of hijacking the new holder's lease."""
    queue: str
    tag: int
    now: float = 0.0
    timeout: Optional[float] = None
    consumer: str = ""


@wire
@dataclass(frozen=True)
class PublishResult:
    """Publish a GradResult onto a results queue."""
    queue: str
    result: Any


@wire
@dataclass(frozen=True)
class FetchModel:
    version: int
    nbytes: int = 0


@wire
@dataclass(frozen=True)
class PublishModel:
    version: int
    blob: Any
    nbytes: int = 0


@wire
@dataclass(frozen=True)
class GcModels:
    keep_last: int = 2


@wire
@dataclass(frozen=True)
class WatchVersion:
    version: int
    consumer: str


@wire
@dataclass(frozen=True)
class SubscribeQueue:
    queue: str
    consumer: str
    kind: str = "any"


@wire
@dataclass(frozen=True)
class KickQueue:
    """Hand a consumed wake back to the next waiter (woken consumer died)."""
    queue: str


@wire
@dataclass(frozen=True)
class DropConsumer:
    consumer: str


@wire
@dataclass(frozen=True)
class DepthReq:
    queue: str


@wire
@dataclass(frozen=True)
class DrainedReq:
    queue: str


@wire
@dataclass(frozen=True)
class LatestReq:
    pass


@wire
@dataclass(frozen=True)
class SubmitUpdate:
    """Barrierless fast path: hand the server a version-stamped result
    (``GradResult``/``DeltaResult``) and let IT run admission -> apply ->
    commit -> ack, so the volunteer never fetches the admission-time model or
    pushes the updated blob. Requires the endpoint to host a
    ``ServerApplier``; ``queue``/``tag`` name the ticket to ack (admitted) or
    nack to the front (too stale)."""
    queue: str
    tag: int
    result: Any


@wire
@dataclass(frozen=True)
class Bye:
    """Volunteer leaves: unsubscribe everywhere + requeue held leases."""
    consumer: str


@wire
@dataclass(frozen=True)
class ExpireAll:
    """Server-authority lease sweep as a PROTOCOL message: requeue every
    lease whose visibility deadline is <= ``now``. ``now`` is stamped by the
    caller that owns time (the gateway's sweeper thread, an engine's virtual
    clock) and is applied verbatim — never re-stamped by the endpoint clock —
    because the op log records this message and failover replay must expire
    exactly the leases the live server expired, at exactly the recorded
    times."""
    now: float


@wire
@dataclass(frozen=True)
class Forward:
    """Inter-gateway routing envelope: gateway ``origin`` did not own the
    ring slice for ``inner``'s routing key, so it forwards the request to the
    owner verbatim. The owner dispatches ``inner`` as if the client were
    local and returns its reply in a ``ForwardReply`` with the same ``seq``
    (the origin runs many forwards concurrently over one peer link).
    Forwards never nest — the origin resolves the final owner before
    sending — and the envelope itself is never op-logged: the dispatched
    ``inner`` is, so failover replay is identical whether traffic arrived
    locally or forwarded."""
    seq: int
    origin: str
    inner: Any


# ---------------------------------------------------------------------------
# messages: replies
# ---------------------------------------------------------------------------

@wire
@dataclass(frozen=True)
class LeaseGrant:
    tag: int
    body: Any
    latest: int = -1          # staleness metadata: the model version current
                              # at grant time (lets a client judge/skip work
                              # without a LatestReq round-trip)


@wire
@dataclass(frozen=True)
class LeaseEmpty:
    pass


@wire
@dataclass(frozen=True)
class Ok:
    """Generic acknowledgement reply; ``value`` carries the op's scalar result
    (ack/nack success, depth, drained, drop count...)."""
    value: Any = None


@wire
@dataclass(frozen=True)
class ModelBlob:
    version: int
    present: bool
    blob: Any = None


@wire
@dataclass(frozen=True)
class LatestVersion:
    version: int


@wire
@dataclass(frozen=True)
class UpdateCommitted:
    """``SubmitUpdate`` reply: the result passed admission; the server
    applied it and published model ``version``, and the ticket is acked."""
    version: int


@wire
@dataclass(frozen=True)
class UpdateRejected:
    """``SubmitUpdate`` reply: too stale at ``latest``; the payload was
    discarded and the ticket nacked to the queue front for a recompute."""
    latest: int


@wire
@dataclass(frozen=True)
class ForwardReply:
    """The owner's reply to a ``Forward``, correlated by ``seq``; ``inner``
    is the reply the dispatched request produced."""
    seq: int
    inner: Any


# ---------------------------------------------------------------------------
# messages: async notifications (server -> client)
# ---------------------------------------------------------------------------

@wire
@dataclass(frozen=True)
class Wake:
    """A queue subscription fired (publish, or requeue for kind="any")."""
    queue: str
    kind: str = "any"


@wire
@dataclass(frozen=True)
class VersionReady:
    """A watched model version committed."""
    version: int


@wire
@dataclass(frozen=True)
class ForwardNotify:
    """A notification (``Wake``/``VersionReady``) owed to consumer
    ``consumer`` whose connection lives on ANOTHER gateway: the slice owner
    wraps the fire and sends it to the consumer's home gateway, which unwraps
    and delivers ``inner`` down the consumer's local connection."""
    consumer: str
    inner: Any


NOTIFICATION_TYPES = (Wake, VersionReady, ForwardNotify)

REQUEST_TYPES = (Hello, LeaseReq, Ack, Nack, ExtendLease, PublishResult,
                 FetchModel, PublishModel, GcModels, WatchVersion,
                 SubscribeQueue, KickQueue, DropConsumer, DepthReq,
                 DrainedReq, LatestReq, SubmitUpdate, Bye, ExpireAll,
                 Forward)

REPLY_TYPES = (LeaseGrant, LeaseEmpty, Ok, ModelBlob, LatestVersion,
               UpdateCommitted, UpdateRejected, ForwardReply)

#: requests that read server state without mutating it — safe to dispatch
#: outside the gateway's guard lock, and never worth op-logging
READONLY_TYPES = (LatestReq, DepthReq, DrainedReq, FetchModel, Hello)

#: requests the op log records (state-changing, connection-independent).
#: ``SubscribeQueue``/``WatchVersion`` are deliberately absent: waiters are
#: session-bound (snapshots exclude them for the same reason) and replaying
#: one would register a phantom waiter against a dead connection.
#: ``SubmitUpdate`` is logged too, but at the ``submit_batch`` layer so a
#: batched drain logs its updates in exact application order. ``Forward``
#: envelopes are never logged — their dispatched ``inner`` is.
OPLOG_TYPES = (LeaseReq, Ack, Nack, ExtendLease, PublishResult, PublishModel,
               GcModels, KickQueue, DropConsumer, Bye, ExpireAll)


# ---------------------------------------------------------------------------
# server half
# ---------------------------------------------------------------------------

@dataclass
class ServerApplier:
    """Server-side async applier (the DistML.js shape: thin clients push
    contributions; the parameter server applies them). Hosted by a
    ``ServerEndpoint``, it serves ``SubmitUpdate`` for barrierless policies:
    admission by ``policy.admit``, then ``apply(model_blob, result, version)``
    produces the next blob, which the endpoint publishes as ``version + 1``
    and acks the ticket — one round-trip where the client-applied path costs
    three (admission LatestReq + model fetch + model push)."""

    policy: Any
    apply: Callable[[Any, Any, int], Any]
    model_nbytes: int = 0
    gc_keep: Optional[int] = None
    applied: int = 0
    rejected: int = 0
    # measured wire size: when set, every publish re-measures the encoded
    # blob instead of trusting the constructor constant (which lies as soon
    # as the blob is a real serialized model rather than a synthetic token)
    measure: Optional[Callable[[Any], int]] = None
    # batched fast path: (blob, results, base_version) -> [blob_1..blob_B],
    # the successive post-update blobs for a homogeneous admitted run —
    # installed by appliers that can chain B updates in one call
    apply_batch: Optional[Callable[[Any, List[Any], int], List[Any]]] = None
    batches: int = 0           # drains that applied >= 2 updates in one go
    batched_updates: int = 0   # updates that rode such drains

    def nbytes_for(self, blob) -> int:
        """Wire-accounting size of a freshly produced blob: measured when a
        ``measure`` hook is installed, else the constructor constant."""
        if self.measure is not None:
            self.model_nbytes = int(self.measure(blob))
        return self.model_nbytes


class ServerEndpoint:
    """Dispatch one request message onto (QueueServer, DataServer) and return
    the reply message. Subscription/watch fires leave as ``Wake`` /
    ``VersionReady`` notifications through ``notify(consumer, msg)`` — which a
    transport routes back to the owning engine (possibly over bytes, possibly
    through injected faults).

    ``clock`` (a ``queue.LeaseClock``) makes the SERVER the lease-time
    authority: when set, every ``LeaseReq`` is stamped with ``clock.now()``
    instead of the client-supplied ``now`` — a remote client's idea of time
    never reaches the deadline table. Engines install a ``VirtualClock`` over
    their own event time; the gateway installs a ``WallClock`` plus a sweeper
    thread that drives ``expire_all`` on real deadlines.

    ``applier`` (a ``ServerApplier``) enables the ``SubmitUpdate`` fast path
    for barrierless policies."""

    def __init__(self, qs, ds: DataServer,
                 notify: Optional[Callable[[str, Any], None]] = None, *,
                 clock=None, applier: Optional[ServerApplier] = None):
        self.qs = qs
        self.ds = ds
        self.clock = clock
        self.applier = applier
        # op log sink: when set (the gateway installs one), every successfully
        # dispatched state-changing request (``OPLOG_TYPES`` + each
        # ``SubmitUpdate`` in batch order) is handed to it AFTER dispatch, so
        # a failover replay of the recorded stream reconstructs this
        # endpoint's durable state exactly
        self.op_sink: Optional[Callable[[Any], None]] = None
        # consumers whose connection lives on another gateway (registered by
        # a forwarded SubscribeQueue/WatchVersion): consumer -> origin gid;
        # their notification fires leave as ForwardNotify to the home gateway
        self._remote_consumers: Dict[str, str] = {}
        self._notify = notify if notify is not None else (lambda c, m: None)
        # live (consumer, version) watches: lossy/timed clients re-subscribe
        # defensively, and the queue side dedupes waiters per consumer — this
        # is the matching dedupe for version watches, so a re-watch while the
        # previous registration is live is a no-op instead of stacking
        # duplicate watcher callbacks and duplicate VersionReady frames
        self._watch_keys: set = set()

    def set_notify(self, notify: Callable[[str, Any], None]) -> None:
        self._notify = notify

    def watch_view(self) -> Tuple[Tuple[str, int], ...]:
        """Live ``(consumer, version)`` watches, sorted. Introspection hook
        for ``repro_torch.analysis.mc`` (no-lost-wake invariant + state
        fingerprint); the watcher callbacks themselves stay private."""
        return tuple(sorted(self._watch_keys))

    def disconnect(self, consumer: str) -> int:
        """Server-side cleanup for a consumer whose CONNECTION died (not a
        ``Bye``: that is the volunteer leaving voluntarily, and it also
        requeues held leases). Drops the consumer's queue waiters so they
        stop consuming one-shot wakes nobody can deliver; leases stay —
        lease recovery is deliberately the sweeper's (the volunteer may
        reconnect and heartbeat; only real death expires them)."""
        self._remote_consumers.pop(consumer, None)
        return self.qs.unsubscribe(consumer)

    def _deliver(self, consumer: str, msg) -> None:
        """Route one notification fire: locally-connected consumers get the
        message as-is; a consumer registered through a ``Forward`` gets it
        wrapped in ``ForwardNotify`` addressed to its home gateway's peer
        link (consumer id ``gw:<origin>``)."""
        origin = self._remote_consumers.get(consumer)
        if origin is None:
            self._notify(consumer, msg)
        else:
            self._notify(f"gw:{origin}", ForwardNotify(consumer, msg))

    def now(self, client_now: float = 0.0) -> float:
        """Lease-authority time: the installed clock, else the client's."""
        return client_now if self.clock is None else self.clock.now()

    def _submit_update(self, m: SubmitUpdate):
        return self.submit_batch([m])[0]

    def submit_batch(self, msgs: List[SubmitUpdate]) -> List[Any]:
        """Drained ``SubmitUpdate`` batch — the server-apply fast path.

        Admission is precomputed Python-side in arrival order: within a drain
        the published version advances by exactly one per admitted update, so
        element i is admitted against (and a rejection reports) the version it
        would have observed under one-at-a-time handling. The admitted run is
        then applied — in ONE batched apply per homogeneous segment when the
        applier installs ``apply_batch`` — and every intermediate version is
        published, with measured nbytes, and acked in arrival order.

        Replies are bit-identical to sequential ``handle`` calls per client;
        batching is invisible on the wire. The only internal difference is
        that ``gc_keep`` pruning runs once at drain end instead of after each
        publish — the surviving version set is the same either way, and no
        client observes mid-drain state (the endpoint is held by one drainer).
        An empty or all-rejected drain publishes nothing."""
        ap = self.applier
        if ap is None:
            raise TypeError("SubmitUpdate needs a ServerApplier on the "
                            "endpoint (server-side apply is not enabled)")
        if self.op_sink is not None:
            # arrival order IS application order (admission is precomputed in
            # arrival order), so replaying these one-at-a-time reproduces the
            # drain's state exactly — the batching is invisible to the log
            # just as it is on the wire
            for m in msgs:
                self.op_sink(m)
        replies: List[Any] = [None] * len(msgs)
        base = self.ds.latest_version
        v = base
        admitted: List[Tuple[int, SubmitUpdate]] = []
        for i, m in enumerate(msgs):
            if ap.policy.admit(m.result.computed_at, v):
                admitted.append((i, m))
                v += 1
            else:
                ap.rejected += 1
                self.qs.nack(m.queue, m.tag, front=True)
                replies[i] = UpdateRejected(v)
        if not admitted:
            return replies
        blob = self.ds.get_model(base)
        blobs: List[Any] = []
        pos = 0
        while pos < len(admitted):
            # homogeneous segment: apply_batch chains one result kind only
            # (GradResult vs DeltaResult take different apply paths)
            kind = type(admitted[pos][1].result)
            end = pos + 1
            while end < len(admitted) and \
                    type(admitted[end][1].result) is kind:
                end += 1
            seg = [m.result for _, m in admitted[pos:end]]
            if len(seg) >= 2 and ap.apply_batch is not None:
                out = ap.apply_batch(blob, seg, base + pos)
                ap.batches += 1
                ap.batched_updates += len(seg)
            else:
                out = []
                for j, r in enumerate(seg):
                    blob = ap.apply(blob, r, base + pos + j)
                    out.append(blob)
            blobs.extend(out)
            blob = out[-1]
            pos = end
        for k, ((i, m), b) in enumerate(zip(admitted, blobs)):
            self.ds.publish_model(base + k + 1, b, nbytes=ap.nbytes_for(b))
            self.qs.ack(m.queue, m.tag)
            ap.applied += 1
            replies[i] = UpdateCommitted(base + k + 1)
        if ap.gc_keep is not None:
            self.ds.gc_models(keep_last=ap.gc_keep)
        return replies

    def handle(self, m):
        """Dispatch one request and return its reply, feeding the op log.

        ``Forward`` unwraps here: the envelope records the origin gateway for
        any session-binding inner (so notification fires route home), then
        the inner request dispatches through this same method — op-logging
        included — and the reply goes back wrapped with the envelope's seq.
        """
        if isinstance(m, Forward):
            inner = m.inner
            if isinstance(inner, (SubscribeQueue, WatchVersion)):
                self._remote_consumers[inner.consumer] = m.origin
            return ForwardReply(m.seq, self.handle(inner))
        reply = self._dispatch(m)
        # logged only after a successful dispatch: a request that raised
        # must not survive into the replay stream
        if self.op_sink is not None and isinstance(m, OPLOG_TYPES):
            self.op_sink(m)
        return reply

    def _dispatch(self, m):
        if isinstance(m, LeaseReq):
            got = self.qs.lease(m.queue, m.consumer, self.now(m.now),
                                m.timeout)
            if got is None:
                return LeaseEmpty()
            return LeaseGrant(got[0], got[1], self.ds.latest_version)
        if isinstance(m, Ack):
            return Ok(self.qs.ack(m.queue, m.tag))
        if isinstance(m, Nack):
            return Ok(self.qs.nack(m.queue, m.tag, front=m.front))
        if isinstance(m, ExtendLease):
            return Ok(self.qs.extend(m.queue, m.tag, self.now(m.now),
                                     m.timeout, m.consumer or None))
        if isinstance(m, PublishResult):
            return Ok(self.qs.publish(m.queue, m.result))
        if isinstance(m, FetchModel):
            blob = self.ds.get_model(m.version, nbytes=m.nbytes)
            if blob is not None and hasattr(blob, "materialize"):
                # a batched real applier publishes lazy blobs; a fetch is
                # exactly the moment the pytree form is actually needed
                blob = blob.materialize()
            return ModelBlob(m.version, blob is not None, blob)
        if isinstance(m, PublishModel):
            return Ok(self.ds.publish_model(m.version, m.blob,
                                            nbytes=m.nbytes))
        if isinstance(m, GcModels):
            self.ds.gc_models(keep_last=m.keep_last)
            return Ok()
        if isinstance(m, WatchVersion):
            key = (m.consumer, m.version)
            if key in self._watch_keys:
                return Ok(False)
            self._watch_keys.add(key)

            def fire(key=key, consumer=m.consumer, version=m.version):
                self._watch_keys.discard(key)
                self._deliver(consumer, VersionReady(version))

            self.ds.watch_version(m.version, fire)
            return Ok(True)
        if isinstance(m, SubscribeQueue):
            self.qs.subscribe(
                m.queue, m.consumer,
                lambda: self._deliver(m.consumer, Wake(m.queue, m.kind)),
                kind=m.kind)
            return Ok()
        if isinstance(m, KickQueue):
            self.qs.kick(m.queue)
            return Ok()
        if isinstance(m, DropConsumer):
            self._remote_consumers.pop(m.consumer, None)
            return Ok(self.qs.drop_consumer(m.consumer))
        if isinstance(m, DepthReq):
            return Ok(self.qs.depth(m.queue))
        if isinstance(m, DrainedReq):
            return Ok(self.qs.drained([m.queue]))
        if isinstance(m, LatestReq):
            return LatestVersion(self.ds.latest_version)
        if isinstance(m, SubmitUpdate):
            return self._submit_update(m)
        if isinstance(m, Bye):
            self._remote_consumers.pop(m.consumer, None)
            self.qs.unsubscribe(m.consumer)
            return Ok(self.qs.drop_consumer(m.consumer))
        if isinstance(m, ExpireAll):
            # m.now applied verbatim (see ExpireAll): replay authority
            return Ok(self.qs.expire_all(m.now))
        if isinstance(m, Hello):
            return Ok(m.consumer)
        raise TypeError(f"unknown protocol message {type(m).__name__}")


# ---------------------------------------------------------------------------
# client half: session outcomes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NoTask:
    """The task queue is empty; wait for a publish/requeue (or stop if the
    queue is drained and the run is ending)."""


@dataclass(frozen=True)
class TaskLeased:
    task: Any


@dataclass(frozen=True)
class Blocked:
    """What to wait for. Exactly one of (queue, version) is set; the engine
    chooses the mechanism — ``session.subscribe(blocked)`` for push, or its
    own reschedule for poll."""
    queue: Optional[str] = None
    kind: str = "any"
    version: Optional[int] = None


@dataclass(frozen=True)
class MapWork:
    """Model fetched: the engine must produce this map task's gradient (real
    or simulated). Under a barrier policy call ``finish_map``; under a
    barrierless one ``base_version`` is the latest version the model was
    fetched at — stamp it into a ``GradResult`` and call ``finish_update``."""
    task: Any
    model: Any
    base_version: int = -1


@dataclass(frozen=True)
class LocalWork:
    """Latest model fetched (barrierless LocalSteps): the engine must run the
    task's ``k`` local optimizer steps from this model and hand the delta to
    ``finish_update`` as a ``DeltaResult``."""
    task: Any
    model: Any
    base_version: int = -1


@dataclass(frozen=True)
class ApplyWork:
    """A barrierless result passed admission: the engine must apply
    ``result``'s payload to ``model`` (the blob current at version
    ``version``) and call ``commit_update`` with the new blob, which
    publishes model ``version + 1``."""
    task: Any
    model: Any
    version: int
    result: Any


@dataclass(frozen=True)
class ReduceWork:
    """Barrier met, results drained + deduped: the engine must produce model
    version+1 (real or simulated) and call ``finish_reduce``."""
    task: Any
    results: Dict[int, Any]           # mb_index -> gradient payload


@dataclass(frozen=True)
class TaskDone:
    task: Any
    stale: bool = False               # acked an obsolete duplicate, no work


@dataclass(frozen=True)
class UpdateDone:
    """Outcome of ``submit_update`` (server-applied barrierless commit):
    ``version`` is the model version the server published (-1 when the result
    was rejected as stale — the ticket is already nacked server-side)."""
    task: Any
    stale: bool
    version: int = -1


@dataclass(frozen=True)
class Busy:
    """A compute was already handed out (``MapWork``/``ReduceWork``) and not
    finished: the wake that triggered this advance is spurious (duplicate or
    delayed delivery) and must be dropped, not acted on."""
    task: Any


class VolunteerSession:
    """One volunteer's sans-IO protocol state machine.

    Drive it with ``lease`` -> ``advance`` -> (``finish_map`` |
    ``finish_reduce``); every server effect is a message through ``port.call``.
    The session owns the protocol rules; the engine owns time, compute, and
    the waiting mechanism.
    """

    def __init__(self, vid: str, port, *, model_nbytes: int = 0,
                 policy: Optional[AggregationPolicy] = None):
        self.vid = vid
        self.port = port
        self.model_nbytes = model_nbytes  # accounting hint for FetchModel
        self.policy = make_policy(policy) # aggregation/consistency semantics
        self.tag: Optional[int] = None
        self.task: Any = None
        self.lease_latest: int = -1       # LeaseGrant staleness metadata
        self._rtags: list = []            # leased results-queue tags (reduce)
        self._handed = False              # compute handed out, not yet finished
        self._base: int = -1              # barrierless: version compute is on
        self._apply_version: int = -1     # barrierless: version apply is on

    # -- plumbing -----------------------------------------------------------
    def _call(self, msg):
        return self.port.call(msg)

    def latest(self) -> int:
        return self._call(LatestReq()).version

    def _clear(self):
        self.tag = self.task = None
        self._rtags = []
        self._handed = False
        self._base = self._apply_version = -1

    # -- introspection (repro_torch.analysis.mc) ----------------------------------
    @property
    def holding(self) -> bool:
        """True while a leased ticket is held (heartbeat/release are legal)."""
        return self.tag is not None

    @property
    def computing(self) -> bool:
        """True while compute is handed out and not yet finished."""
        return self._handed

    def state_view(self) -> Dict[str, Any]:
        """The session's protocol-visible state as plain data, for the model
        checker's state fingerprint. ``load_view`` is the inverse; together
        they let an explorer branch a session without deep-copying the
        transport it is bound to."""
        return {"tag": self.tag, "task": self.task,
                "lease_latest": self.lease_latest,
                "rtags": list(self._rtags), "handed": self._handed,
                "base": self._base, "apply_version": self._apply_version}

    def load_view(self, view: Dict[str, Any]) -> None:
        """Restore state captured by ``state_view`` (model-checker replay)."""
        self.tag = view["tag"]
        self.task = view["task"]
        self.lease_latest = view["lease_latest"]
        self._rtags = list(view["rtags"])
        self._handed = view["handed"]
        self._base = view["base"]
        self._apply_version = view["apply_version"]

    # -- protocol: lease ----------------------------------------------------
    def lease(self, now: float):
        """Try to lease the next task from the task queue."""
        assert self.task is None, f"{self.vid}: lease while holding a task"
        r = self._call(LeaseReq(INITIAL_QUEUE, self.vid, now))
        if isinstance(r, LeaseEmpty):
            return NoTask()
        self.tag, self.task = r.tag, r.body
        self.lease_latest = r.latest
        return TaskLeased(self.task)

    # -- protocol: advance a held task up to its compute --------------------
    def advance(self, now: float):
        """Move the held task forward until it blocks, completes as a stale
        duplicate, or is ready for engine compute. Re-entrant: call again
        after a wake (or poll tick) while it returns ``Blocked``."""
        t = self.task
        assert t is not None, f"{self.vid}: advance with no task"
        if self._handed:                  # spurious wake mid-compute
            return Busy(t)
        if not self.policy.barrier:
            return self._advance_update(t)
        # staleness-metadata fast path: latest is monotone, so a task the
        # policy already refused at GRANT time can never become admissible —
        # the LatestReq round-trip is skipped for it
        latest = self.lease_latest
        if self.policy.admit(t.version, latest):
            latest = self.latest()
        if not self.policy.admit(t.version, latest):
            # obsolete duplicate (requeued after someone else's result was
            # reduced) — ack without compute: at-least-once + idempotent
            self._call(Ack(INITIAL_QUEUE, self.tag))
            done = TaskDone(t, stale=True)
            self._clear()
            return done
        if t.kind == "map":
            r = self._call(FetchModel(t.version, self.model_nbytes))
            if not r.present:
                return Blocked(version=t.version)
            self._handed = True
            return MapWork(t, r.blob)
        return self._advance_reduce(now, t)

    def _advance_reduce(self, now: float, t):
        rq = results_queue(t.version)
        if self._call(DepthReq(rq)).value < t.n_mb:
            # barrier not reached: wait for the next result publish (requeues
            # — including our own nacks below — must not wake the barrier)
            return Blocked(queue=rq, kind="publish")
        tags, results = [], {}
        while True:
            r = self._call(LeaseReq(rq, self.vid, now))
            if isinstance(r, LeaseEmpty):
                break
            tags.append(r.tag)
            results.setdefault(r.body.mb_index, r.body.payload)  # dedup by mb
        if len(results) < t.n_mb:
            for tg in tags:
                self._call(Nack(rq, tg, front=True))
            return Blocked(queue=rq, kind="publish")
        self._rtags = tags
        self._handed = True
        return ReduceWork(t, results)

    # -- protocol: barrierless (BoundedStaleness / LocalSteps) ---------------
    def _advance_update(self, t):
        """Barrierless policies never wait on a model version: fetch the
        LATEST model (always present) and hand the compute to the engine.
        Staleness is judged when the result comes back (``finish_update``)."""
        latest = self.latest()
        r = self._call(FetchModel(latest, self.model_nbytes))
        assert r.present, f"{self.vid}: latest model v{latest} not fetchable"
        self._handed = True
        self._base = latest
        if t.kind == "local":
            return LocalWork(t, r.blob, latest)
        return MapWork(t, r.blob, latest)

    def grad_result(self, payload, nbytes: int, loss: float) -> GradResult:
        """Version-stamped async gradient for ``finish_update``."""
        t = self.task
        return GradResult(t.version, t.mb_index, payload, nbytes, loss,
                          self.vid, computed_at=self._base)

    def delta_result(self, payload, nbytes: int, loss: float) -> DeltaResult:
        """Version-stamped local-steps delta for ``finish_update``."""
        t = self.task
        return DeltaResult(t.slot, self._base, payload, nbytes, loss,
                           self.vid, n_steps=t.k,
                           weight=getattr(self.policy, "weight", 1.0))

    def finish_update(self, result):
        """Admission edge for a barrierless result (a ``GradResult`` or
        ``DeltaResult``, version-stamped with ``computed_at``). Too stale ->
        the payload is discarded and the ticket nacked to the queue front for
        a fresh-version recompute. Admitted -> the current model blob is
        fetched and handed back as ``ApplyWork``; the engine applies the
        payload and calls ``commit_update``."""
        t = self.task
        latest = self.latest()
        if not self.policy.admit(result.computed_at, latest):
            self._call(Nack(INITIAL_QUEUE, self.tag, front=True))
            done = TaskDone(t, stale=True)
            self._clear()
            return done
        r = self._call(FetchModel(latest, self.model_nbytes))
        self._apply_version = latest
        return ApplyWork(t, r.blob, latest, result)

    def commit_update(self, blob, nbytes: int = 0,
                      gc_keep: Optional[int] = None):
        """Publish the applied model as version ``apply_version + 1`` and ack
        the ticket. Must be called in the same engine event as
        ``finish_update`` (the admission fetch and this publish are one
        atomic commit under the engines' single-threaded clocks)."""
        t = self.task
        self._call(PublishModel(self._apply_version + 1, blob, nbytes))
        if gc_keep is not None:
            self._call(GcModels(gc_keep))
        self._call(Ack(INITIAL_QUEUE, self.tag))
        done = TaskDone(t)
        self._clear()
        return done

    def submit_update(self, result) -> UpdateDone:
        """Server-applied barrierless commit: one ``SubmitUpdate`` round-trip
        replaces the client-applied ``finish_update`` -> ``commit_update``
        pair — the server runs admission, applies the payload to the current
        model, publishes, and acks/nacks the ticket itself, so the volunteer
        pays a result push instead of a model push. Requires the endpoint to
        host a ``ServerApplier``."""
        t = self.task
        r = self._call(SubmitUpdate(INITIAL_QUEUE, self.tag, result))
        self._clear()
        if isinstance(r, UpdateRejected):
            return UpdateDone(t, stale=True)
        return UpdateDone(t, stale=False, version=r.version)

    # -- protocol: completions ----------------------------------------------
    def finish_map(self, payload, nbytes: int, loss: float):
        """Publish the gradient and ack the map task (re-checking admission:
        in virtual-time engines the version may have advanced mid-compute)."""
        t = self.task
        if not self.policy.admit(t.version, self.latest()):
            self._call(Ack(INITIAL_QUEUE, self.tag))
            done = TaskDone(t, stale=True)
            self._clear()
            return done
        self._call(PublishResult(
            results_queue(t.version),
            GradResult(t.version, t.mb_index, payload, nbytes, loss,
                       self.vid, computed_at=t.version)))
        self._call(Ack(INITIAL_QUEUE, self.tag))
        done = TaskDone(t)
        self._clear()
        return done

    def fetch_model(self, nbytes: int = 0):
        """Fetch the held (reduce) task's model blob — engine compute input."""
        return self._call(FetchModel(self.task.version, nbytes)).blob

    def result_message(self, payload, nbytes: int, loss: float) -> PublishResult:
        """The PublishResult ``finish_map`` would send — lets a measuring
        engine price the push before committing to it."""
        t = self.task
        return PublishResult(
            results_queue(t.version),
            GradResult(t.version, t.mb_index, payload, nbytes, loss, self.vid,
                       computed_at=t.version))

    def model_message(self, blob, nbytes: int = 0) -> PublishModel:
        """The PublishModel ``finish_reduce`` would send (pricing, as above)."""
        return PublishModel(self.task.version + 1, blob, nbytes)

    def finish_reduce(self, blob, nbytes: int = 0,
                      gc_keep: Optional[int] = None):
        """Publish model version+1, then ack the drained results and the
        reduce task. Duplicate publishes are absorbed by the DataServer."""
        t = self.task
        self._call(PublishModel(t.version + 1, blob, nbytes))
        if gc_keep is not None:
            self._call(GcModels(gc_keep))
        rq = results_queue(t.version)
        for tg in self._rtags:
            self._call(Ack(rq, tg))
        self._call(Ack(INITIAL_QUEUE, self.tag))
        done = TaskDone(t)
        self._clear()
        return done

    def release(self, *, front: bool = False) -> bool:
        """Voluntarily give the held ticket back (nack) and go idle. The
        liveness escape hatch for a version-blocked map: stepping aside to
        the BACK of the queue is order-safe (the task cannot run before its
        model version commits anyway) and frees this volunteer to take the
        front task — which may be the very map the open reduce barrier is
        missing. Safe on an already-expired lease (the nack is a no-op)."""
        ok = self._call(Nack(INITIAL_QUEUE, self.tag, front=front)).value
        self._clear()
        return ok

    def queue_depth(self) -> int:
        """Pending tasks on the task queue (is there other leasable work?)."""
        return self._call(DepthReq(INITIAL_QUEUE)).value

    # -- protocol: lease renewal ---------------------------------------------
    def heartbeat(self, now: float = 0.0) -> bool:
        """Renew the held ticket's visibility deadline (see ``ExtendLease``).
        Call periodically from long computes or long barrier waits so the
        sweeper only ever expires DEAD volunteers. Returns False when the
        renewal lost the race (the lease already expired and requeued)."""
        if self.tag is None:
            return False
        return self._call(ExtendLease(INITIAL_QUEUE, self.tag, now,
                                      consumer=self.vid)).value

    # -- protocol: waits ----------------------------------------------------
    def subscribe(self, blocked: Blocked) -> None:
        """Push-mode wait: register for exactly the wake ``blocked`` names."""
        if blocked.version is not None:
            self._call(WatchVersion(blocked.version, self.vid))
        else:
            self._call(SubscribeQueue(blocked.queue, self.vid, blocked.kind))

    def subscribe_idle(self) -> None:
        """Idle wait: wake on the next task-queue publish or requeue."""
        self._call(SubscribeQueue(INITIAL_QUEUE, self.vid, "any"))

    def queue_drained(self) -> bool:
        return self._call(DrainedReq(INITIAL_QUEUE)).value

    # -- protocol: departure -------------------------------------------------
    def abort(self, *, kick_if_empty: bool = False) -> int:
        """The volunteer died mid-protocol: requeue everything it held —
        DropConsumer covers the task lease AND any drained results-queue
        leases in one sweep. A consumed wake it can no longer serve is passed
        on (``kick_if_empty``) so no event is lost. Returns the number of
        requeued leases."""
        n = self._call(DropConsumer(self.vid)).value
        if n == 0 and kick_if_empty:
            self._call(KickQueue(INITIAL_QUEUE))
        self._clear()
        return n

    def bye(self) -> int:
        """Clean departure: unsubscribe everywhere + requeue held leases."""
        n = self._call(Bye(self.vid)).value
        self._clear()
        return n
