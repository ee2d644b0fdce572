"""QueueServer — AMQP-style named queues with at-least-once delivery.

Mirrors the semantics JSDoop gets from RabbitMQ (paper §IV.D/§IV.F step 5):

- ``publish`` appends a message.
- ``lease`` hands a message to a consumer WITHOUT removing it: the message moves
  to the in-flight table with a visibility deadline ("the Initiator can set a
  maximum time to solve a task").
- ``ack`` removes it permanently ("tasks are not removed from the queue until an
  ACK is received").
- ``expire``/``drop_consumer`` requeue in-flight messages whose deadline passed
  or whose consumer disconnected ("if a volunteer disconnects while solving a
  task, the task is added back to the queue").
- ``subscribe`` registers a one-shot waiter: the next publish or requeue wakes
  exactly one registered waiter (FIFO), replacing client-side polling. This is
  the push/notify coordination Pando and DistML.js use to scale volunteer
  computing beyond a handful of browsers.

Time is explicit (virtual): both the real coordinator (logical step clock) and
the discrete-event simulator (seconds) drive the same implementation.

``ShardedQueueServer`` federates K ``QueueServer`` instances behind the same
API, routing queue names with consistent hashing — the paper's §IV observation
that "it is possible to use several QueueServers in which each one stores a
different type of task", made concrete as a load-balanced hash ring. The
federation is *elastic*: ``add_shard()`` / ``remove_shard(i)`` recompute the
ring and migrate the full live state of every remapped queue (pending FIFO,
in-flight table + deadlines, banked signals, registered waiters, counters), so
a rebalance is invisible to consumers except that ~1/K of queue names change
owner. Cross-queue side-effect order (expiry requeues, consumer drops) is
defined by (deadline, queue-name) / queue-name, NOT by shard layout, so a
sharded run is bit-identical to a single-server run — asserted by the chaos
metamorphic suite (``repro_torch.core.chaos``).
"""
from __future__ import annotations

import bisect
import hashlib
import heapq
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


class LeaseClock:
    """Time source for visibility deadlines.

    The queue semantics are clock-agnostic: ``lease(now)`` stamps a deadline
    and ``expire_all(now)`` enforces it, for whatever ``now`` means. The
    engines own virtual clocks (the Simulator's event time, the Coordinator's
    logical step count); a real deployment owns wall time. ``LeaseClock``
    names that choice so a server endpoint — and the gateway's sweeper thread
    — can ask "what time is it for lease purposes?" without knowing which
    regime it runs under.
    """

    def now(self) -> float:
        raise NotImplementedError


class WallClock(LeaseClock):
    """Real deployments: visibility deadlines are wall-clock seconds
    (monotonic, so a system clock step cannot mass-expire leases)."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock(LeaseClock):
    """Engines: deadlines live on the engine's own virtual/logical clock.
    Wraps a zero-arg callable (e.g. ``lambda: sim._now``) so the clock always
    reads the engine's current instant, never a stale copy."""

    def __init__(self, read: Callable[[], float]):
        self._read = read

    def now(self) -> float:
        return self._read()


@dataclass
class _InFlight:
    body: Any
    consumer: str
    deadline: float
    requeues: int


class Queue:
    def __init__(self, name: str, default_timeout: float = float("inf")):
        self.name = name
        self.default_timeout = default_timeout
        self._pending: deque = deque()            # (tag, body)
        self._in_flight: Dict[int, _InFlight] = {}
        self._next_tag = 0                        # plain int: snapshotable
        # owning QueueServer's deadline index hook (set by declare/attach):
        # called with (qname, deadline) whenever a finite deadline is created,
        # so the server can skip expiry scans until something can have expired.
        self._server_note: Optional[Callable[[str, float], None]] = None
        # expiry index: (deadline, tag) min-heap; entries go stale when a tag is
        # acked or re-leased — validated lazily against the in-flight table.
        self._deadlines: List[Tuple[float, int]] = []
        # one-shot waiters. "any" wakes on publish OR requeue (a task became
        # leasable); "publish" wakes on publish only (new data arrived — the
        # reduce-barrier watcher, which must not be woken by its own nacks).
        # At most ONE live waiter per consumer per kind: a re-subscribe while
        # the previous waiter is still registered is a no-op (the client
        # cannot tell a live waiter from a consumed-and-lost wake, so lossy
        # transports re-subscribe defensively — without the dedupe those
        # retries would stack duplicate waiters that steal other consumers'
        # wakes). The name sets shadow the deques for O(1) membership.
        self._waiters: deque = deque()            # (consumer, callback)
        self._pub_waiters: deque = deque()
        self._waiter_names: set = set()
        self._pub_waiter_names: set = set()
        self._signal = False                      # event arrived with no waiter
        self._pub_signal = False
        self.published = 0
        self.acked = 0
        self.requeued = 0
        self.wakeups = 0

    # -- producer ------------------------------------------------------------
    def publish(self, body: Any) -> int:
        tag = self._next_tag
        self._next_tag += 1
        self._pending.append((tag, body))
        self.published += 1
        self._notify(publish=True)
        return tag

    # -- consumer ------------------------------------------------------------
    def lease(self, consumer: str, now: float,
              timeout: Optional[float] = None) -> Optional[Tuple[int, Any]]:
        if not self._pending:
            return None
        tag, body = self._pending.popleft()
        t = self.default_timeout if timeout is None else timeout
        deadline = now + t
        self._in_flight[tag] = _InFlight(body, consumer, deadline, 0)
        if math.isfinite(deadline):
            heapq.heappush(self._deadlines, (deadline, tag))
            if self._server_note is not None:
                self._server_note(self.name, deadline)
        return tag, body

    def ack(self, tag: int) -> bool:
        if tag in self._in_flight:
            del self._in_flight[tag]
            self.acked += 1
            return True
        return False

    def nack(self, tag: int, *, front: bool = True) -> bool:
        """Voluntary give-back (e.g. dependency not ready)."""
        inf = self._in_flight.pop(tag, None)
        if inf is None:
            return False
        if front:
            self._pending.appendleft((tag, inf.body))
        else:
            self._pending.append((tag, inf.body))
        self.requeued += 1
        self._notify(publish=False)
        return True

    def extend(self, tag: int, now: float,
               timeout: Optional[float] = None,
               consumer: Optional[str] = None) -> bool:
        """Lease renewal (SQS ChangeMessageVisibility): a live consumer whose
        work — or whose legitimate protocol WAIT, e.g. holding the reduce
        barrier — outlasts the visibility timeout re-stamps its deadline to
        ``now + timeout`` instead of losing the lease. Returns False if the
        tag is no longer held (already expired/requeued — the renewal lost),
        or — receipt-handle semantics — if ``consumer`` is given and the tag
        was meanwhile re-leased to SOMEONE ELSE (a zombie's heartbeat must
        not renew, and must be told it lost, another consumer's lease)."""
        inf = self._in_flight.get(tag)
        if inf is None:
            return False
        if consumer is not None and inf.consumer != consumer:
            return False
        t = self.default_timeout if timeout is None else timeout
        inf.deadline = now + t
        if math.isfinite(inf.deadline):
            heapq.heappush(self._deadlines, (inf.deadline, tag))
            if self._server_note is not None:
                self._server_note(self.name, inf.deadline)
        return True

    # -- subscriptions ---------------------------------------------------------
    def subscribe(self, consumer: str, callback: Callable[[], None], *,
                  kind: str = "any") -> None:
        """Register a one-shot waiter. The next publish (or, for kind="any",
        requeue) wakes exactly ONE waiter in FIFO order. If an event already
        arrived while nobody was waiting, the callback fires immediately —
        a spurious wake at worst; waiters re-check queue state on wake, so the
        check-then-subscribe pattern is lossless under this single-threaded
        virtual clock."""
        if kind not in ("any", "publish"):
            raise ValueError(f"unknown subscription kind {kind!r}")
        if kind == "publish":
            if self._pub_signal:
                self._pub_signal = False
                self.wakeups += 1
                callback()
            elif consumer not in self._pub_waiter_names:
                self._pub_waiters.append((consumer, callback))
                self._pub_waiter_names.add(consumer)
            return
        if self._signal:
            self._signal = False
            self.wakeups += 1
            callback()
        elif consumer not in self._waiter_names:
            self._waiters.append((consumer, callback))
            self._waiter_names.add(consumer)

    def unsubscribe(self, consumer: str) -> int:
        """Remove every waiter registered by this consumer (volunteer left)."""
        n = len(self._waiters) + len(self._pub_waiters)
        self._waiters = deque((c, cb) for c, cb in self._waiters
                              if c != consumer)
        self._pub_waiters = deque((c, cb) for c, cb in self._pub_waiters
                                  if c != consumer)
        self._waiter_names.discard(consumer)
        self._pub_waiter_names.discard(consumer)
        return n - len(self._waiters) - len(self._pub_waiters)

    def kick(self) -> None:
        """Hand a consumed wake to the next waiter — used when a woken consumer
        turns out to have left and cannot serve the event it was woken for."""
        self._notify(publish=False)

    def _notify(self, *, publish: bool) -> None:
        if self._waiters:
            c, cb = self._waiters.popleft()
            self._waiter_names.discard(c)
            self.wakeups += 1
            cb()
        else:
            self._signal = True
        if publish:
            if self._pub_waiters:
                c, cb = self._pub_waiters.popleft()
                self._pub_waiter_names.discard(c)
                self.wakeups += 1
                cb()
            else:
                self._pub_signal = True

    # -- fault tolerance -------------------------------------------------------
    def expire(self, now: float) -> int:
        """Requeue every in-flight message whose visibility deadline passed.
        Amortized O(expired) via the deadline heap (stale entries skipped)."""
        n = 0
        while self._deadlines and self._deadlines[0][0] <= now:
            _, tag = heapq.heappop(self._deadlines)
            inf = self._in_flight.get(tag)
            if inf is not None and inf.deadline <= now:
                self.nack(tag, front=True)
                n += 1
        return n

    def next_deadline(self) -> Optional[float]:
        """Earliest live visibility deadline, or None."""
        while self._deadlines:
            dl, tag = self._deadlines[0]
            inf = self._in_flight.get(tag)
            if inf is not None and inf.deadline == dl:
                return dl
            heapq.heappop(self._deadlines)
        return None

    def drop_consumer(self, consumer: str) -> int:
        """A volunteer closed the browser: requeue everything it held."""
        held = [t for t, inf in self._in_flight.items() if inf.consumer == consumer]
        for t in held:
            self.nack(t, front=True)
        return len(held)

    # -- introspection ---------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        return len(self._in_flight)

    @property
    def drained(self) -> bool:
        return not self._pending and not self._in_flight

    @property
    def waiters(self) -> int:
        return len(self._waiters) + len(self._pub_waiters)

    def peek_all(self) -> List[Any]:
        return [b for _, b in self._pending]

    def waiter_view(self) -> Dict[str, Tuple[str, ...]]:
        """Registered waiter consumers in FIFO order, per kind. Introspection
        hook for ``repro_torch.analysis.mc`` (no-lost-wake invariant, state
        fingerprint, waiter re-registration on restore); the one-shot
        callbacks themselves stay private."""
        return {"any": tuple(c for c, _ in self._waiters),
                "publish": tuple(c for c, _ in self._pub_waiters)}

    def check_invariants(self) -> None:
        """Structural invariants that must hold at every quiescent point.

        - a tag is pending XOR in flight (never both, never duplicated),
        - every finite-deadline in-flight message has a live entry in the
          deadline heap (stale heap entries are allowed — they are lazily
          discarded — but a deadline the heap does not cover would never
          expire),
        - conservation: every publish is accounted for — acked, still
          pending, or in flight; nothing is lost to nothing.
        """
        pending_tags = [t for t, _ in self._pending]
        assert len(pending_tags) == len(set(pending_tags)), \
            f"{self.name}: duplicate tag in pending"
        overlap = set(pending_tags) & set(self._in_flight)
        assert not overlap, f"{self.name}: tags both pending and in flight: {overlap}"
        heap_entries = set(self._deadlines)
        for tag, inf in self._in_flight.items():
            if math.isfinite(inf.deadline):
                assert (inf.deadline, tag) in heap_entries, \
                    f"{self.name}: in-flight tag {tag} deadline " \
                    f"{inf.deadline} missing from deadline heap"
        assert self.published == self.acked + self.depth + self.in_flight, \
            f"{self.name}: conservation violated: published={self.published} " \
            f"!= acked={self.acked} + depth={self.depth} + " \
            f"in_flight={self.in_flight}"
        assert self._waiter_names == {c for c, _ in self._waiters}, \
            f"{self.name}: waiter name set out of sync"
        assert self._pub_waiter_names == {c for c, _ in self._pub_waiters}, \
            f"{self.name}: publish-waiter name set out of sync"

    # -- durability ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Full serializable live state: pending FIFO (order + tags), the
        in-flight table with deadlines and requeue counts, banked signals,
        the tag counter, and all counters. Registered WAITERS are deliberately
        excluded — they are live callbacks bound to connections/sessions that
        do not survive a process, so a restored server starts with none and
        clients re-subscribe (which the protocol already requires of lossy
        transports)."""
        return {
            "name": self.name,
            "default_timeout": self.default_timeout,
            "pending": [[tag, body] for tag, body in self._pending],
            "in_flight": [[tag, inf.body, inf.consumer, inf.deadline,
                           inf.requeues]
                          for tag, inf in sorted(self._in_flight.items())],
            "next_tag": self._next_tag,
            "signal": self._signal,
            "pub_signal": self._pub_signal,
            "published": self.published,
            "acked": self.acked,
            "requeued": self.requeued,
            "wakeups": self.wakeups,
        }

    @classmethod
    def from_snapshot(cls, state: Dict[str, Any]) -> "Queue":
        q = cls(state["name"], state["default_timeout"])
        q._pending = deque((tag, body) for tag, body in state["pending"])
        for tag, body, consumer, deadline, requeues in state["in_flight"]:
            q._in_flight[tag] = _InFlight(body, consumer, deadline, requeues)
            if math.isfinite(deadline):
                q._deadlines.append((deadline, tag))
        heapq.heapify(q._deadlines)
        q._next_tag = state["next_tag"]
        q._signal = bool(state["signal"])
        q._pub_signal = bool(state["pub_signal"])
        q.published = state["published"]
        q.acked = state["acked"]
        q.requeued = state["requeued"]
        q.wakeups = state["wakeups"]
        return q

    def adopt_waiters(self, src: "Queue") -> None:
        """Carry another queue object's live waiter registrations into this
        one (in-place restore: the snapshot cannot hold callbacks, but the
        process may still hold the subscribers)."""
        self._waiters = src._waiters
        self._pub_waiters = src._pub_waiters
        self._waiter_names = src._waiter_names
        self._pub_waiter_names = src._pub_waiter_names

    def adopt_session_state(self, src: "Queue") -> None:
        """Adopt ALL of another queue object's session-coupled wake state:
        waiter registrations plus the banked signal flags. An op-log replay
        reconstructs the durable half of a queue but not its wake state —
        subscriptions are never logged (they are connection-bound), so a
        replayed queue over-banks signals that a live subscriber already
        consumed. A gateway adopting a slice takes the wake state from the
        LIVE session side (volunteers that are still connected), exactly as
        ``restore(waiters_from=...)`` does for waiters."""
        self.adopt_waiters(src)
        self._signal = src._signal
        self._pub_signal = src._pub_signal


class QueueServer:
    """Named queues. Multiple QueueServers are modelled by multiple instances
    (the paper's load-balancing story — see ShardedQueueServer); the API is
    identical."""

    def __init__(self, default_timeout: float = float("inf")):
        self.default_timeout = default_timeout
        self.queues: Dict[str, Queue] = {}
        # server-level deadline index: (deadline, qname), lazily pruned — lets
        # next_deadline()/expire_all() cost O(log) instead of O(all queues).
        self._dl_heap: List[Tuple[float, str]] = []

    def _note_deadline(self, qname: str, deadline: float) -> None:
        heapq.heappush(self._dl_heap, (deadline, qname))

    def declare(self, name: str, timeout: Optional[float] = None) -> Queue:
        if name not in self.queues:
            q = Queue(name, self.default_timeout if timeout is None else timeout)
            q._server_note = self._note_deadline
            self.queues[name] = q
        return self.queues[name]

    # -- live-state migration (elastic federation) -----------------------------
    def detach(self, name: str) -> Queue:
        """Remove a queue — with its FULL live state — for migration to
        another server. Stale entries for it in this server's deadline index
        are pruned lazily."""
        q = self.queues.pop(name)
        q._server_note = None
        return q

    def attach(self, q: Queue) -> None:
        """Adopt a migrated queue: index its live in-flight deadlines in this
        server's deadline heap (and compact the queue's own heap, dropping
        entries that went stale at the source). Pending FIFO order, the
        in-flight table, banked signals, registered waiters, the tag counter
        and all counters ride along inside the Queue — no callback fires, so
        migration is invisible to consumers."""
        assert q.name not in self.queues, f"queue {q.name!r} already attached"
        q._deadlines = [(inf.deadline, tag)
                        for tag, inf in q._in_flight.items()
                        if math.isfinite(inf.deadline)]
        heapq.heapify(q._deadlines)
        for dl, _ in q._deadlines:
            heapq.heappush(self._dl_heap, (dl, q.name))
        q._server_note = self._note_deadline
        self.queues[q.name] = q

    # -- durability ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Serializable state of every queue, in name order (deterministic
        bytes for identical state). See ``Queue.snapshot`` for what rides
        along and why waiters do not."""
        return {"kind": "QueueServer",
                "default_timeout": self.default_timeout,
                "queues": [self.queues[n].snapshot()
                           for n in sorted(self.queues)]}

    def restore(self, state: Dict[str, Any], *,
                waiters_from: Optional[Dict[str, Queue]] = None) -> None:
        """Replace this server's entire state with a snapshot, in place (the
        object identity survives, so endpoints/transports keep working).

        ``waiters_from`` maps queue names to live Queue objects whose waiter
        registrations should be adopted by the restored queues — defaults to
        this server's own current queues, which makes a same-process
        snapshot -> restore round-trip invisible to subscribed consumers.
        After a process crash there are no live waiters to adopt and restored
        queues start with none; reconnecting clients re-subscribe, and any
        lease the dead clients held expires via the visibility sweeper."""
        if state.get("kind") != "QueueServer":
            raise ValueError(f"not a QueueServer snapshot: {state.get('kind')!r}")
        old = self.queues if waiters_from is None else waiters_from
        self.default_timeout = state["default_timeout"]
        self.queues = {}
        self._dl_heap = []
        for qstate in state["queues"]:
            q = Queue.from_snapshot(qstate)
            if q.name in old:
                q.adopt_waiters(old[q.name])
            q._server_note = self._note_deadline
            for dl, _ in q._deadlines:
                heapq.heappush(self._dl_heap, (dl, q.name))
            self.queues[q.name] = q

    def publish(self, qname: str, body: Any) -> int:
        return self.declare(qname).publish(body)

    def lease(self, qname: str, consumer: str, now: float,
              timeout: Optional[float] = None):
        return self.declare(qname).lease(consumer, now, timeout)

    def ack(self, qname: str, tag: int) -> bool:
        return self.declare(qname).ack(tag)

    def nack(self, qname: str, tag: int, *, front: bool = True) -> bool:
        return self.declare(qname).nack(tag, front=front)

    def extend(self, qname: str, tag: int, now: float,
               timeout: Optional[float] = None,
               consumer: Optional[str] = None) -> bool:
        return self.declare(qname).extend(tag, now, timeout, consumer)

    def subscribe(self, qname: str, consumer: str,
                  callback: Callable[[], None], *, kind: str = "any") -> None:
        self.declare(qname).subscribe(consumer, callback, kind=kind)

    def unsubscribe(self, consumer: str) -> int:
        return sum(q.unsubscribe(consumer) for q in self.queues.values())

    def kick(self, qname: str) -> None:
        self.declare(qname).kick()

    def _peek_deadline(self) -> Optional[Tuple[float, str]]:
        """Earliest live (deadline, qname), lazily pruning stale index entries
        (acked / re-leased / migrated-away queues)."""
        while self._dl_heap:
            dl, qn = self._dl_heap[0]
            q = self.queues.get(qn)
            if q is not None and q.next_deadline() == dl:
                return dl, qn
            heapq.heappop(self._dl_heap)
        return None

    def expire_all(self, now: float) -> int:
        """Requeue every expired in-flight message, queue by queue in
        (deadline, qname) order — O(expired), and an order that is a pure
        function of queue state (never of shard layout)."""
        n = 0
        while True:
            head = self._peek_deadline()
            if head is None or head[0] > now:
                break
            n += self.queues[head[1]].expire(now)
        return n

    def next_deadline(self) -> Optional[float]:
        head = self._peek_deadline()
        return None if head is None else head[0]

    def drop_consumer(self, consumer: str) -> int:
        # qname order, so requeue notifications fire in an order independent
        # of queue-creation (and, federated, shard) layout
        return sum(self.queues[n].drop_consumer(consumer)
                   for n in sorted(self.queues))

    def drained(self, names: Optional[Iterable[str]] = None) -> bool:
        qs = (self.queues[n] for n in names if n in self.queues) if names \
            else self.queues.values()
        return all(q.drained for q in qs)

    def depth(self, qname: str) -> int:
        return self.declare(qname).depth

    def waiter_views(self) -> Dict[str, Dict[str, Tuple[str, ...]]]:
        """Per-queue ``waiter_view``s, sorted by queue name (model checker)."""
        return {n: self.queues[n].waiter_view() for n in sorted(self.queues)}

    @property
    def total_requeued(self) -> int:
        return sum(q.requeued for q in self.queues.values())

    @property
    def total_wakeups(self) -> int:
        return sum(q.wakeups for q in self.queues.values())


def _stable_hash(key: str) -> int:
    """Process-independent 64-bit hash (Python's str hash is salted)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


def colocate_results(qname: str) -> str:
    """Placement rule for ``ShardedQueueServer(placement=...)``: route every
    ``map-results:v*`` queue to the shard owning the task queue, so a reduce
    barrier (drain + ack the results queue, ack the task) touches exactly ONE
    shard instead of two. Placement only picks the owner — queue semantics
    (and the chaos bit-match contract) are placement-invariant."""
    from repro_torch.core.tasks import INITIAL_QUEUE, RESULTS_PREFIX
    return INITIAL_QUEUE if qname.startswith(RESULTS_PREFIX) else qname


class ShardedQueueServer:
    """K federated QueueServer instances behind the QueueServer API.

    Queue names route to shards via a consistent-hash ring with virtual nodes,
    so (a) load spreads evenly over the federation and (b) adding/removing a
    shard remaps only ~1/K of the queue names — the standard scaling story for
    the paper's "several QueueServers" deployment. Every per-queue operation is
    a pure delegation to the owning shard, so federation is semantics-invisible
    (asserted by tests: a sharded run bit-matches a single-server run).

    The federation is elastic: ``add_shard()`` / ``remove_shard(i)`` change
    ring membership at runtime and migrate the full live state of every
    remapped queue to its new owner (see ``QueueServer.detach/attach``). Shards
    carry stable ids independent of their list position, so a membership
    change only adds/removes that member's virtual nodes — every other vnode
    keeps its ring position, which is what bounds the remap to ~1/K of names.
    Both methods return the migrated queue names (the rebalance observable).
    """

    def __init__(self, n_shards: int, default_timeout: float = float("inf"),
                 *, vnodes: int = 64,
                 placement: Optional[Callable[[str], str]] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.default_timeout = default_timeout
        self._vnodes = vnodes
        # placement maps a queue name to the KEY the ring hashes (e.g.
        # ``colocate_results`` rides result queues with their task queue);
        # identity by default. Routing stays a pure function of the name.
        self._place: Callable[[str], str] = placement or (lambda name: name)
        self.shards: List[QueueServer] = []
        self._sids: List[int] = []            # stable id per shard (ring key)
        self._next_sid = 0
        self._ring: List[Tuple[int, int]] = []  # sorted (hash, sid)
        self._ring_keys: List[int] = []
        self._ring_vals: List[int] = []         # shard INDEX per ring slot
        for _ in range(n_shards):
            self.add_shard()

    def _reindex(self) -> None:
        index_of = {sid: i for i, sid in enumerate(self._sids)}
        self._ring_keys = [h for h, _ in self._ring]
        self._ring_vals = [index_of[sid] for _, sid in self._ring]

    def add_shard(self) -> List[str]:
        """Join a new (empty) shard and migrate the ~1/K of live queues whose
        ring successor is now one of its virtual nodes. Returns the migrated
        queue names."""
        sid = self._next_sid
        self._next_sid += 1
        self.shards.append(QueueServer(self.default_timeout))
        self._sids.append(sid)
        for r in range(self._vnodes):
            bisect.insort(self._ring, (_stable_hash(f"qshard-{sid}#{r}"), sid))
        self._reindex()
        migrated: List[str] = []
        for si, shard in enumerate(self.shards[:-1]):
            for name in sorted(n for n in shard.queues
                               if self.shard_of(n) != si):
                self.shards[self.shard_of(name)].attach(shard.detach(name))
                migrated.append(name)
        return migrated

    def remove_shard(self, index: int) -> List[str]:
        """Leave: retire the shard at ``index``, migrating ALL of its live
        queues (≈1/K of the federation) to their new ring successors — zero
        messages lost, waiters and banked signals included. Returns the
        migrated queue names."""
        if len(self.shards) <= 1:
            raise ValueError("cannot remove the last shard")
        sid = self._sids.pop(index)
        src = self.shards.pop(index)
        self._ring = [(h, s) for h, s in self._ring if s != sid]
        self._reindex()
        migrated: List[str] = []
        for name in sorted(src.queues):
            self.shards[self.shard_of(name)].attach(src.detach(name))
            migrated.append(name)
        return migrated

    # -- durability ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Per-shard snapshots plus the ring membership (stable shard ids and
        the id counter), so a restore reproduces the exact queue->shard
        placement — including ids burned by shards that have since left."""
        return {"kind": "ShardedQueueServer",
                "default_timeout": self.default_timeout,
                "vnodes": self._vnodes,
                "next_sid": self._next_sid,
                "sids": list(self._sids),
                "shards": [s.snapshot() for s in self.shards]}

    def restore(self, state: Dict[str, Any]) -> None:
        """Rebuild the ring and every shard's state in place. The placement
        rule is code, not state — the restoring server keeps its own (it must
        be constructed with the same rule, like the same codebase). Live
        waiters are adopted by queue NAME across the whole federation, so a
        same-process round-trip stays invisible even though queue->shard
        ownership is reconstructed rather than copied."""
        if state.get("kind") != "ShardedQueueServer":
            raise ValueError(
                f"not a ShardedQueueServer snapshot: {state.get('kind')!r}")
        if state["vnodes"] != self._vnodes:
            raise ValueError(f"vnodes mismatch: snapshot {state['vnodes']}, "
                             f"server {self._vnodes}")
        live = dict(self.queues)              # merged name -> Queue view
        self.default_timeout = state["default_timeout"]
        self._next_sid = state["next_sid"]
        self._sids = list(state["sids"])
        self._ring = []
        for sid in self._sids:
            for r in range(self._vnodes):
                bisect.insort(self._ring,
                              (_stable_hash(f"qshard-{sid}#{r}"), sid))
        self._reindex()
        self.shards = [QueueServer(self.default_timeout)
                       for _ in self._sids]
        for shard, sstate in zip(self.shards, state["shards"]):
            shard.restore(sstate, waiters_from=live)

    def shard_of(self, qname: str) -> int:
        """Index of the shard owning this queue name (clockwise successor of
        its placement key)."""
        h = _stable_hash(self._place(qname))
        i = bisect.bisect_right(self._ring_keys, h) % len(self._ring_keys)
        return self._ring_vals[i]

    def route(self, qname: str) -> QueueServer:
        return self.shards[self.shard_of(qname)]

    # -- per-queue ops: delegate to the owning shard ---------------------------
    def declare(self, name: str, timeout: Optional[float] = None) -> Queue:
        return self.route(name).declare(name, timeout)

    def publish(self, qname: str, body: Any) -> int:
        return self.route(qname).publish(qname, body)

    def lease(self, qname: str, consumer: str, now: float,
              timeout: Optional[float] = None):
        return self.route(qname).lease(qname, consumer, now, timeout)

    def ack(self, qname: str, tag: int) -> bool:
        return self.route(qname).ack(qname, tag)

    def nack(self, qname: str, tag: int, *, front: bool = True) -> bool:
        return self.route(qname).nack(qname, tag, front=front)

    def extend(self, qname: str, tag: int, now: float,
               timeout: Optional[float] = None,
               consumer: Optional[str] = None) -> bool:
        return self.route(qname).extend(qname, tag, now, timeout, consumer)

    def subscribe(self, qname: str, consumer: str,
                  callback: Callable[[], None], *, kind: str = "any") -> None:
        self.route(qname).subscribe(qname, consumer, callback, kind=kind)

    def kick(self, qname: str) -> None:
        self.route(qname).kick(qname)

    def depth(self, qname: str) -> int:
        return self.route(qname).depth(qname)

    # -- federation-wide ops ---------------------------------------------------
    def unsubscribe(self, consumer: str) -> int:
        return sum(s.unsubscribe(consumer) for s in self.shards)

    def expire_all(self, now: float) -> int:
        """Merge per-shard deadline indexes so expiry requeues fire in global
        (deadline, qname) order — identical to a single server holding the
        same queues, whatever the shard layout."""
        n = 0
        while True:
            best: Optional[Tuple[float, str]] = None
            best_shard: Optional[QueueServer] = None
            for s in self.shards:
                head = s._peek_deadline()
                if head is not None and head[0] <= now and \
                        (best is None or head < best):
                    best, best_shard = head, s
            if best is None:
                break
            n += best_shard.queues[best[1]].expire(now)
        return n

    def next_deadline(self) -> Optional[float]:
        dls = [d for d in (s.next_deadline() for s in self.shards)
               if d is not None]
        return min(dls) if dls else None

    def drop_consumer(self, consumer: str) -> int:
        # global qname order — matches the single-server requeue order
        named = sorted(((n, s) for s in self.shards for n in s.queues),
                       key=lambda t: t[0])
        return sum(s.queues[n].drop_consumer(consumer) for n, s in named)

    def drained(self, names: Optional[Iterable[str]] = None) -> bool:
        if names:
            return all(self.route(n).drained([n]) for n in names)
        return all(s.drained() for s in self.shards)

    @property
    def queues(self) -> Dict[str, Queue]:
        """Merged read-only view over all shards (names are unique: each queue
        lives on exactly one shard)."""
        merged: Dict[str, Queue] = {}
        for s in self.shards:
            merged.update(s.queues)
        return merged

    @property
    def total_requeued(self) -> int:
        return sum(s.total_requeued for s in self.shards)

    @property
    def total_wakeups(self) -> int:
        return sum(s.total_wakeups for s in self.shards)

    def shard_loads(self) -> List[int]:
        """Queues per shard — the load-balance observable."""
        return [len(s.queues) for s in self.shards]
