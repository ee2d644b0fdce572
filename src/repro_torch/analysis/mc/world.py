"""The model checker's concrete world: real protocol objects, one state.

An ``MCWorld`` wires N real ``VolunteerSession`` objects to a real
``ServerEndpoint`` (``QueueServer`` + ``DataServer``) over an
``InProcessTransport`` — no mocks; the shipped ``protocol.py`` IS the model —
and exposes the three verbs an explicit-state explorer needs:

- ``enabled_actions()`` — every action legal in this state, deterministic
  order. One action = one engine event (one session API call and the atomic
  protocol sequence inside it), matching the granularity at which the real
  engines (Simulator/gateway) interleave volunteers.
- ``apply(action)``    — execute one action, mutating the world in place.
- ``capture()`` / ``restore(cap)`` — branch points. Restore REBUILDS fresh
  servers from ``QueueServer.snapshot()``/``DataServer.snapshot()`` (the same
  wire-durable state the gateway persists) and re-registers waiters/watches
  through real ``SubscribeQueue``/``WatchVersion`` messages, so every single
  explored transition doubles as a snapshot/restore injection between two
  dispatches — durability is exercised at every edge, not sampled.

## The action alphabet

Per volunteer: ``lease``, ``advance``, ``finish``, ``wake`` (consume one
delivered notification), ``heartbeat``, ``release`` (the step-aside escape
hatch), ``crash`` (hard: connection drops, leases recover only via expiry),
``rejoin`` (fresh session, zombie cleanup via ``abort``), ``leave`` (clean
``bye``). Global: ``deliver``/``drop``/``dup`` — the fate of the OLDEST
undelivered notification (the ``FaultyTransport`` fault set, budgeted by
``max_drops``/``max_dups``) — and ``expire`` (advance virtual time to the
next lease deadline and sweep, i.e. lease expiry at every legal point).

Partial-order reduction: only the head of the pending-notification list
branches. Notifications to different consumers commute (delivery only
appends to disjoint per-volunteer mailboxes; *acting* on a mailbox is a
separate ``wake`` action), so exploring all fates of the head is sound.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.aggregation import AggregationPolicy, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.initiator import enqueue_problem
from repro_torch.core.protocol import (ApplyWork, Blocked, Busy, ExpireAll, Hello,
                                 LocalWork, MapWork, NoTask, ReduceWork,
                                 ServerApplier, ServerEndpoint,
                                 SubscribeQueue, TaskDone, VolunteerSession,
                                 WatchVersion)
from repro_torch.core.queue import QueueServer, VirtualClock
from repro_torch.core.simulator import SyntheticProblem
from repro_torch.core.tasks import INITIAL_QUEUE, results_queue
from repro_torch.core.transport import InProcessTransport

# actions whose availability means the run can still move forward; fault
# injection (crash/drop/dup/leave) and lease renewal (heartbeat) cannot
# unstick a run by themselves, so they do not count against deadlock
PROGRESS_KINDS = frozenset(
    {"lease", "advance", "finish", "wake", "deliver", "expire", "release"})

_ALIVE = ("idle", "task", "parked", "parked_idle", "computing")


@dataclass(frozen=True)
class MCConfig:
    """One bounded exploration problem: fleet, policy, and fault budget.

    ``policy_object`` overrides the ``policy`` spec string with a concrete
    ``AggregationPolicy`` instance — the hook mutation fixtures use to plant
    a buggy policy the checker must catch.
    """
    policy: str = "sync"
    n_volunteers: int = 2
    n_versions: int = 2
    n_mb: int = 2
    visibility_timeout: float = 10.0
    crashable: Tuple[str, ...] = ()
    max_crashes: int = 0
    rejoin: bool = False
    leavable: Tuple[str, ...] = ()
    max_leaves: int = 0
    max_drops: int = 0
    max_dups: int = 0
    # expiry injections are unbounded by default (None) — the realistic
    # setting, but it makes every world with in-flight tickets inexhaustible
    # (expire/re-lease cycles never dedup: redelivery accounting grows).
    # A finite budget turns a tiny world into a genuinely exhaustive search.
    max_expiries: Optional[int] = None
    allow_release: bool = True
    allow_heartbeat: bool = False
    server_apply: bool = False
    gc_keep: Optional[int] = None
    policy_object: Any = None

    def make_policy(self) -> AggregationPolicy:
        return make_policy(
            self.policy_object if self.policy_object is not None
            else self.policy)

    def make_world(self) -> "MCWorld":
        """The concrete world this config describes. Subclasses (the gateway
        micro-world) override so the explorer/replayer construct the right
        world type from the config alone."""
        return MCWorld(self)

    def default_invariants(self) -> List["Invariant"]:  # noqa: F821
        """The invariant catalog checked when the caller supplies none;
        subclasses extend it with world-specific invariants."""
        from repro_torch.analysis.mc.invariants import DEFAULT_INVARIANTS
        return list(DEFAULT_INVARIANTS)

    def to_json(self) -> Dict[str, Any]:
        d = {f: getattr(self, f) for f in self.__dataclass_fields__}
        d.pop("policy_object")
        d["crashable"] = list(self.crashable)
        d["leavable"] = list(self.leavable)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "MCConfig":
        kw = dict(d)
        world = kw.pop("world", None)
        if world == "gateway" and cls is MCConfig:
            from repro_torch.analysis.mc.gateway_world import GatewayMCConfig
            return GatewayMCConfig.from_json(d)
        kw["crashable"] = tuple(kw.get("crashable", ()))
        kw["leavable"] = tuple(kw.get("leavable", ()))
        return cls(**kw)


@dataclass
class _Driver:
    """The engine-side view of one volunteer: what the loop around the
    session would be doing (idle / holding / parked / computing / dead)."""
    vid: str
    state: str = "idle"
    blocked: Optional[Blocked] = None
    work: Any = None
    mailbox: List[Any] = field(default_factory=list)
    dropped: int = 0   # injected drops aimed at this volunteer (sticky)


class _Port(InProcessTransport):
    """InProcessTransport that records every request type it carries, so the
    coverage test can prove ``COVERED_MESSAGES`` is honest (every declared
    wire type is actually exercised, not just listed)."""

    def __init__(self, endpoint: ServerEndpoint, sent: set):
        super().__init__(endpoint)
        self._sent = sent

    def call(self, msg):
        self._sent.add(type(msg).__name__)
        return super().call(msg)


class MCWorld:
    def __init__(self, cfg: MCConfig):
        self.cfg = cfg
        self.policy = cfg.make_policy()
        self.problem = SyntheticProblem(
            n_versions=cfg.n_versions, n_mb=cfg.n_mb, mini_batch_size=1,
            model_bytes=8, grad_bytes=8, map_flops=1.0, reduce_flops=1.0)
        self.n_updates = self.policy.n_updates(self.problem, cfg.n_versions)
        self.vids = tuple(f"w{i}" for i in range(cfg.n_volunteers))
        self.sent_types: set = set()   # exploration-global coverage ledger
        self.now = 0.0
        self.pending: List[Tuple[str, Any]] = []   # undelivered notifications
        self.crashes = self.leaves = self.drops = self.dups = 0
        self.expiries = 0
        self.undeliverable = 0
        self.applied: List[Tuple[int, int]] = []   # (computed_at, applied_at)
        self.commit_meta: List[Tuple[int, str]] = []  # (version, slot key)
        self._fresh_servers()
        self.n_scheduled = enqueue_problem(
            self.problem, self.qs, self.ds, n_versions=cfg.n_versions,
            policy=self.policy, store_real_model=False)
        if self.policy.barrier:
            # pre-declare the per-version results queues so a DepthReq probe
            # (declare-on-read) cannot make two otherwise-equal states differ
            for v in range(cfg.n_versions):
                self.qs.declare(results_queue(v))
        self.sessions: Dict[str, VolunteerSession] = {}
        self.drivers: Dict[str, _Driver] = {}
        for vid in self.vids:
            self.sessions[vid] = VolunteerSession(vid, self.port,
                                                  policy=self.policy)
            self.drivers[vid] = _Driver(vid)
            self.port.call(Hello(vid))

    # -- wiring -------------------------------------------------------------
    def _fresh_servers(self) -> None:
        cfg = self.cfg
        self.qs = QueueServer(default_timeout=cfg.visibility_timeout)
        self.ds = DataServer()
        applier = None
        if cfg.server_apply:
            applier = ServerApplier(self.policy,
                                    lambda blob, result, v: "blob",
                                    gc_keep=cfg.gc_keep)
        self.endpoint = ServerEndpoint(
            self.qs, self.ds, clock=VirtualClock(lambda: self.now),
            applier=applier)
        self.port = _Port(self.endpoint, self.sent_types)
        self.port.set_deliver(self._on_notify)

    def _on_notify(self, consumer: str, msg) -> None:
        self.sent_types.add(type(msg).__name__)
        d = self.drivers.get(consumer) if hasattr(self, "drivers") else None
        if d is None or d.state not in _ALIVE:
            # the connection is gone: the frame falls on the floor (this is
            # delivery loss the SERVER caused by crash/leave, not a budgeted
            # injected fault)
            self.undeliverable += 1
            return
        self.pending.append((consumer, msg))

    # -- predicates ---------------------------------------------------------
    def complete(self) -> bool:
        return self.ds.latest_version >= self.n_updates

    def enabled_actions(self) -> List[Tuple[str, ...]]:
        """Every action legal in this state, in a deterministic order with
        protocol moves (deliver/wake/lease/advance/finish) first and fault
        injections (crash/leave/drop/dup/expire/heartbeat/release) last: the
        explorer's DFS stack pops the LAST element first, so it dives into
        the fault corners — where the bugs live — before exhausting the
        happy-path interleavings, and counterexamples surface early even
        when the budget truncates the search."""
        cfg = self.cfg
        faults: List[Tuple[str, ...]] = []
        moves: List[Tuple[str, ...]] = []
        if self.pending:
            if self.drops < cfg.max_drops:
                faults.append(("drop",))
            if self.dups < cfg.max_dups:
                faults.append(("dup",))
            moves.append(("deliver",))
        if self.qs.next_deadline() is not None and \
                (cfg.max_expiries is None or
                 self.expiries < cfg.max_expiries):
            faults.append(("expire",))
        for vid in self.vids:
            d = self.drivers[vid]
            if d.state == "crashed":
                if cfg.rejoin:
                    faults.append(("rejoin", vid))
                continue
            if d.state in ("gone", "done"):
                continue
            if vid in cfg.crashable and self.crashes < cfg.max_crashes:
                faults.append(("crash", vid))
            if vid in cfg.leavable and self.leaves < cfg.max_leaves:
                faults.append(("leave", vid))
            if cfg.allow_heartbeat and self.sessions[vid].holding and \
                    d.state in ("task", "parked", "computing"):
                faults.append(("heartbeat", vid))
            if d.state == "parked" and cfg.allow_release and \
                    self.sessions[vid].holding and \
                    self.qs.depth(INITIAL_QUEUE) > 0:
                faults.append(("release", vid))
            if d.mailbox:
                moves.append(("wake", vid))
            if d.state == "idle":
                moves.append(("lease", vid))
            elif d.state == "task":
                moves.append(("advance", vid))
            elif d.state == "computing":
                moves.append(("finish", vid))
        return moves + faults

    def symmetry_possible(self) -> bool:
        """True when at least two volunteers have identical fault-capability
        flags — the precondition for the symmetry reduction to ever merge two
        DIFFERENT concrete states. When false the explorer skips the raw
        (unrenamed) fingerprint bookkeeping entirely: every volunteer's blob
        carries distinct flags, so any state isomorphism fixes every
        volunteer and canonical equality coincides with concrete equality."""
        caps = [(v in self.cfg.crashable, v in self.cfg.leavable)
                for v in self.vids]
        return len(set(caps)) < len(caps)

    def progress_possible(self, acts=None) -> bool:
        acts = self.enabled_actions() if acts is None else acts
        return any(a[0] in PROGRESS_KINDS for a in acts)

    def fleet_exhausted(self) -> bool:
        """Every volunteer crashed/left/retired: the run stalls because the
        fleet died, which the paper treats as the norm, not a protocol bug —
        the server just waits for new volunteers."""
        return all(self.drivers[v].state in ("crashed", "gone", "done")
                   for v in self.vids)

    def poll_ready(self) -> bool:
        """Would a watchdog poll tick un-park somebody? True when a parked
        volunteer's wait condition is ALREADY satisfied — the wake it missed
        was eaten by an injected fault (drop, or a crash clearing a mailbox);
        the real engines recover these by timed waits + re-checks, so a stuck
        state that is poll-ready is 'stranded', not deadlocked."""
        for vid in self.vids:
            d = self.drivers[vid]
            if d.state == "parked_idle":
                if self.qs.depth(INITIAL_QUEUE) > 0:
                    return True
            elif d.state == "parked" and d.blocked is not None:
                b = d.blocked
                if b.version is not None:
                    if self.ds.latest_version >= b.version:
                        return True
                elif b.queue is not None:
                    need = 1
                    task = self.sessions[vid].task
                    if b.kind == "publish" and task is not None and \
                            getattr(task, "kind", "") == "reduce":
                        need = task.n_mb
                    if self.qs.depth(b.queue) >= need:
                        return True
        return False

    # -- the step function --------------------------------------------------
    def apply(self, action: Tuple[str, ...]) -> None:
        kind = action[0]
        if kind == "deliver":
            c, m = self.pending.pop(0)
            self.drivers[c].mailbox.append(m)
        elif kind == "drop":
            c, _ = self.pending.pop(0)
            self.drops += 1
            self.drivers[c].dropped += 1
        elif kind == "dup":
            c, m = self.pending.pop(0)
            self.dups += 1
            self.drivers[c].mailbox.extend((m, m))
        elif kind == "expire":
            deadline = self.qs.next_deadline()
            assert deadline is not None, "expire with no finite deadline"
            self.expiries += 1
            self.now = max(self.now, deadline)
            # the sweep goes through the wire op (``ExpireAll`` carries the
            # authoritative now, applied verbatim) — the same message the
            # gateway's sweeper dispatches so its op log can replay expiry
            self.port.call(ExpireAll(self.now))
        elif kind == "heartbeat":
            # the shipped engines ignore the renewal result (gateway: a
            # zombie keeps acting and its eventual ack/nack hits a dead or
            # re-leased tag) — model exactly that, races included
            self.sessions[action[1]].heartbeat(self.now)
        elif kind == "release":
            vid = action[1]
            self.sessions[vid].release(front=False)
            self._to_idle(vid)
        elif kind == "crash":
            vid = action[1]
            self.crashes += 1
            self.endpoint.disconnect(vid)
            d = self.drivers[vid]
            d.state, d.blocked, d.work, d.mailbox = "crashed", None, None, []
            self.pending = [(c, m) for c, m in self.pending if c != vid]
        elif kind == "rejoin":
            vid = action[1]
            self.sessions[vid] = VolunteerSession(vid, self.port,
                                                  policy=self.policy)
            self.port.call(Hello(vid))
            self.sessions[vid].abort(kick_if_empty=True)
            self._to_idle(vid)
        elif kind == "leave":
            vid = action[1]
            self.leaves += 1
            self.sessions[vid].bye()
            d = self.drivers[vid]
            d.state, d.blocked, d.work, d.mailbox = "gone", None, None, []
            self.pending = [(c, m) for c, m in self.pending if c != vid]
        elif kind == "lease":
            self._do_lease(action[1])
        elif kind == "advance":
            self._do_advance(action[1])
        elif kind == "finish":
            self._do_finish(action[1])
        elif kind == "wake":
            vid = action[1]
            self.drivers[vid].mailbox.pop(0)
            # the engines' _continue: no task -> try to lease, else advance
            if self.sessions[vid].task is None:
                if self.drivers[vid].state in ("idle", "parked_idle"):
                    self._do_lease(vid)
            else:
                self._do_advance(vid)
        else:
            raise ValueError(f"unknown action {action!r}")

    def _to_idle(self, vid: str) -> None:
        d = self.drivers[vid]
        d.state, d.blocked, d.work = "idle", None, None

    def _do_lease(self, vid: str) -> None:
        d = self.drivers[vid]
        if self.complete():
            d.state, d.blocked = "done", None
            return
        out = self.sessions[vid].lease(self.now)
        if isinstance(out, NoTask):
            if self.sessions[vid].queue_drained():
                d.state, d.blocked = "done", None
            else:
                self.sessions[vid].subscribe_idle()
                d.state, d.blocked = "parked_idle", None
        else:
            d.state, d.blocked = "task", None

    def _do_advance(self, vid: str) -> None:
        d = self.drivers[vid]
        out = self.sessions[vid].advance(self.now)
        if isinstance(out, Busy):
            return                       # spurious wake mid-compute
        if isinstance(out, TaskDone):
            self._to_idle(vid)           # obsolete duplicate, acked
        elif isinstance(out, Blocked):
            self.sessions[vid].subscribe(out)
            d.state, d.blocked, d.work = "parked", out, None
        else:                            # MapWork | LocalWork | ReduceWork
            d.state, d.blocked, d.work = "computing", None, out

    def _do_finish(self, vid: str) -> None:
        """Compute done + the commit/submit protocol sequence, as ONE engine
        event (the same atomicity the virtual-time engines provide)."""
        d = self.drivers[vid]
        sess = self.sessions[vid]
        work, d.work = d.work, None
        before = self.ds.latest_version
        slot = self._slot_key(work.task)
        if isinstance(work, ReduceWork):
            sess.finish_reduce("blob", 0, gc_keep=self.cfg.gc_keep)
        elif self.policy.barrier:
            sess.finish_map(("g", work.task.mb_index), 0, 0.0)
        else:
            if isinstance(work, LocalWork):
                result = sess.delta_result("delta", 0, 0.0)
            else:
                result = sess.grad_result(("g", work.task.mb_index), 0, 0.0)
            if self.cfg.server_apply:
                out = sess.submit_update(result)
                if not out.stale:
                    self.applied.append((result.computed_at, out.version - 1))
            else:
                out = sess.finish_update(result)
                if isinstance(out, ApplyWork):
                    # admission + apply + publish are one atomic commit
                    self.applied.append((result.computed_at, out.version))
                    sess.commit_update("blob", 0, gc_keep=self.cfg.gc_keep)
        after = self.ds.latest_version
        if after == before + 1:
            self.commit_meta.append((after, slot))
        self._to_idle(vid)

    @staticmethod
    def _slot_key(task) -> str:
        kind = getattr(task, "kind", "?")
        if kind == "map":
            return f"map:{task.version}:{task.mb_index}"
        if kind == "reduce":
            return f"reduce:{task.version}"
        if kind == "local":
            return f"local:{task.slot}"
        return repr(task)

    # -- branch points ------------------------------------------------------
    def capture(self) -> Dict[str, Any]:
        """Everything needed to rebuild this exact state — all of it the
        protocol's own durable/introspectable surface (queue + data snapshots,
        waiter/watch views, session state views), no Python object graphs."""
        cap = {
            "qs": self.qs.snapshot(),
            "ds": self.ds.snapshot(),
            "now": self.now,
            "watches": list(self.endpoint.watch_view()),
            "waiters": self.qs.waiter_views(),
            "sessions": {v: self.sessions[v].state_view() for v in self.vids},
            "drivers": {v: {"state": d.state, "blocked": d.blocked,
                            "work": d.work, "mailbox": list(d.mailbox),
                            "dropped": d.dropped}
                        for v, d in self.drivers.items()},
            "pending": list(self.pending),
            "counters": (self.crashes, self.leaves, self.drops, self.dups,
                         self.expiries, self.undeliverable),
            "applied": list(self.applied),
            "commit_meta": list(self.commit_meta),
        }
        if self.endpoint.applier is not None:
            cap["applier"] = (self.endpoint.applier.applied,
                              self.endpoint.applier.rejected)
        return cap

    def restore(self, cap: Dict[str, Any]) -> None:
        """Rebuild from a capture: fresh servers restored from their own
        snapshots, fresh sessions loaded from their state views, and live
        waits re-registered through real SubscribeQueue/WatchVersion
        messages. Every branch the explorer takes therefore replays the
        gateway's crash-recovery path."""
        self.now = cap["now"]
        (self.crashes, self.leaves, self.drops, self.dups,
         self.expiries, self.undeliverable) = cap["counters"]
        self.applied = list(cap["applied"])
        self.commit_meta = list(cap["commit_meta"])
        self._fresh_servers()
        self.qs.restore(cap["qs"], waiters_from={})
        self.ds.restore(cap["ds"])
        if "applier" in cap:
            self.endpoint.applier.applied = cap["applier"][0]
            self.endpoint.applier.rejected = cap["applier"][1]
        self.sessions = {}
        self.drivers = {}
        for vid in self.vids:
            sess = VolunteerSession(vid, self.port, policy=self.policy)
            sess.load_view(cap["sessions"][vid])
            self.sessions[vid] = sess
            dd = cap["drivers"][vid]
            self.drivers[vid] = _Driver(
                vid, state=dd["state"], blocked=dd["blocked"],
                work=dd["work"], mailbox=list(dd["mailbox"]),
                dropped=dd["dropped"])
        self.pending = list(cap["pending"])
        self._reregister_waits(cap)

    def _reregister_waits(self, cap: Dict[str, Any]) -> None:
        """Re-register live waits in their captured FIFO order. Safe from
        immediate fires: a banked signal and a registered waiter never
        coexist (the queue consumes the bank at subscribe), and a live
        watch key implies the version is still uncommitted. The gateway
        micro-world overrides this to route each re-subscription through the
        consumer's own home gateway (exercising ``Forward`` registration)."""
        for qname, kinds in cap["waiters"].items():
            for c in kinds["any"]:
                self.endpoint.handle(SubscribeQueue(qname, c, "any"))
            for c in kinds["publish"]:
                self.endpoint.handle(SubscribeQueue(qname, c, "publish"))
        for consumer, version in cap["watches"]:
            self.endpoint.handle(WatchVersion(version, consumer))

    def fork(self) -> "MCWorld":
        """A fresh world for the same config (root state)."""
        return replace(self.cfg).make_world()
