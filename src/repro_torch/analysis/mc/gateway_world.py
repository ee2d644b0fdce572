"""Two-gateway micro-world: the replicated control plane as a checkable
model.

``GatewayMCWorld`` extends the base ``MCWorld`` with the cluster overlay the
real multi-gateway deployment (``repro_torch.core.gateway --gid``) adds on top of
one endpoint, using the same building blocks the gateway itself uses:

- a real ``GatewayRing`` routes every request by the gateway's placement
  rule (``colocate_results`` for queue ops, ``MODEL_KEY`` for every
  DataServer-backed op). A request whose slice owner is not the sender's
  home gateway crosses the boundary as a real ``Forward`` envelope through
  the real ``ServerEndpoint.handle`` arm — ``ForwardReply`` comes back, and
  notification fires owed to remotely-homed consumers leave as
  ``ForwardNotify`` exactly as in production (the endpoint's
  remote-consumer table is populated by the forwarded subscribes, not by
  the model).
- every dispatched ``OPLOG_TYPES`` request lands in the owning gateway's
  in-memory op log — the envelope is never logged, the inner op is (the
  gateway's own durability rule) — tagged durable iff the config's
  ``oplog_fsync`` holds. Ops without a routing key (``Bye``,
  ``DropConsumer``, ``ExpireAll``) broadcast to every live gateway's log,
  mirroring the real cluster where each gateway logs its own copy.
- ``("gw_crash", g)`` kills a gateway: its log is truncated to the durable
  watermark, then base + surviving ops replay through a scratch endpoint —
  the exact ``_on_peer_death`` recovery path — and the reconstruction must
  match the pre-crash slice state or **no-lost-forward** fires: work that
  was acknowledged (locally or across a ``Forward``) would be lost at
  failover.
- ``("gw_adopt", g)`` closes the failover window: the deterministic adopter
  (smallest live gid) takes the dead slice and re-bases its own log, with
  **single-owner-per-slice** checking the serve map at every state — no
  slice served twice, none abandoned.

While a slice is orphaned (crash observed, adoption pending) volunteer
protocol moves are held — the model twin of ``GatewayServer._owner_for``
parking requests until a peer adopts — so the only enabled actions are
notification fates and the adoption itself; ``gw_adopt`` counts as progress
for deadlock classification because it is what un-parks the cluster.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.mc.invariants import Invariant
from repro_torch.analysis.mc.world import MCConfig, MCWorld, _Port
from repro_torch.core.dataserver import DataServer
from repro_torch.core.elastic import MODEL_KEY, GatewayRing
from repro_torch.core.protocol import (FetchModel, Forward, ForwardNotify,
                                 ForwardReply, GcModels, LatestReq,
                                 PublishModel, ServerApplier, ServerEndpoint,
                                 SubmitUpdate, SubscribeQueue, WatchVersion,
                                 decode_message, encode_message)
from repro_torch.core.queue import QueueServer, VirtualClock, colocate_results

#: message types routed to the model owner regardless of any ``queue`` field
#: (``SubmitUpdate`` carries one, but its effect is the model update) — the
#: same precedence ``GatewayServer._route_key`` applies
_MODEL_OPS = (FetchModel, PublishModel, GcModels, WatchVersion, LatestReq,
              SubmitUpdate)


def route_key(msg) -> Optional[str]:
    """The ring key a request routes by, or None for sender-local /
    broadcast messages — mirrors ``GatewayServer._route_key``."""
    if isinstance(msg, _MODEL_OPS):
        return MODEL_KEY
    queue = getattr(msg, "queue", None)
    if queue is not None:
        return colocate_results(queue)
    return None


@dataclass(frozen=True)
class GatewayMCConfig(MCConfig):
    """A base world plus the cluster overlay: gateway count, which gateways
    the explorer may kill, and whether the op log fsyncs before acking
    (``oplog_fsync=False`` is the seeded mutation the fsync-drop fixture
    plants)."""
    n_gateways: int = 2
    gw_crashable: Tuple[int, ...] = ()
    max_gw_crashes: int = 0
    oplog_fsync: bool = True

    def make_world(self) -> "GatewayMCWorld":
        return GatewayMCWorld(self)

    def default_invariants(self) -> List[Invariant]:
        return super().default_invariants() + [
            Invariant("single-owner-per-slice", single_owner_per_slice),
            Invariant("no-lost-forward", no_lost_forward),
        ]

    def to_json(self) -> Dict[str, Any]:
        d = super().to_json()
        d["world"] = "gateway"
        d["gw_crashable"] = list(self.gw_crashable)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "GatewayMCConfig":
        kw = dict(d)
        kw.pop("world", None)
        kw["crashable"] = tuple(kw.get("crashable", ()))
        kw["leavable"] = tuple(kw.get("leavable", ()))
        kw["gw_crashable"] = tuple(kw.get("gw_crashable", ()))
        return cls(**kw)


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def single_owner_per_slice(world) -> Optional[str]:
    """Every gateway's base slice is served by exactly one live gateway —
    or by none while it sits in the failover window awaiting adoption.
    A slice served twice (split brain) or a dead slice that is neither
    orphaned nor adopted (lost forever) both violate."""
    served: Dict[int, List[int]] = {}
    live = set(world.ring.live())
    for g in live:
        for s in world.gw_owned.get(g, ()):
            served.setdefault(s, []).append(g)
    for s in world.ring.gids:
        who = sorted(served.get(s, ()))
        if len(who) > 1:
            return (f"slice of gw{s} is served by {len(who)} gateways "
                    f"{who} at once")
        orphaned = s in world.gw_window
        if s in live:
            if not who:
                return f"live gw{s} does not serve its own slice"
        elif orphaned and who:
            return (f"slice of dead gw{s} is served by gw{who[0]} while "
                    f"still awaiting adoption")
        elif not orphaned and not who:
            return (f"slice of dead gw{s} is neither awaiting adoption "
                    f"nor served by any live gateway")
    return None


def no_lost_forward(world) -> Optional[str]:
    """Every op acknowledged to a client — including ops that crossed
    gateways as a ``Forward`` and were acknowledged back over the peer link
    — must survive the owner's crash via op-log replay. ``gw_crash``
    replays the durable log and records any divergence here."""
    if world.gw_lost:
        return world.gw_lost[0]
    return None


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

class _GatewayPort(_Port):
    """One volunteer's transport into the cluster: requests whose slice
    owner is the volunteer's home gateway dispatch directly; anything else
    crosses as a real ``Forward`` and returns the unwrapped ``ForwardReply``
    — the model-checked twin of ``_PeerLink.forward``."""

    def __init__(self, endpoint: ServerEndpoint, sent: set, world,
                 vid: Optional[str]):
        super().__init__(endpoint, sent)
        self._world = world
        self._vid = vid

    def call(self, msg):
        w = self._world
        self._sent.add(type(msg).__name__)
        key = route_key(msg)
        home = w.effective_home(self._vid)
        if key is None or w.ring.owner_of(key) == home:
            return super().call(msg)
        w.gw_seq += 1
        seq = w.gw_seq
        w.gw_forwarding = home
        try:
            reply = super().call(Forward(seq, str(home), msg))
        finally:
            w.gw_forwarding = None
        assert isinstance(reply, ForwardReply) and reply.seq == seq, reply
        w.gw_forwards += 1
        return reply.inner


def _abstract_queue(qsnap: Dict[str, Any], now: float) -> Dict[str, Any]:
    """One queue's snapshot reduced to what op-log replay must reproduce:
    session-coupled wake state out (signals bank differently when live
    subscribers consumed them), waiter-driven accounting out (wakeups), and
    lease deadlines normalized to time-to-expiry."""
    s = {k: v for k, v in qsnap.items()
         if k not in ("signal", "pub_signal", "requeued", "wakeups")}
    s["in_flight"] = [[tag, body, consumer, deadline - now]
                     for tag, body, consumer, deadline, _r
                     in qsnap["in_flight"]]
    return s


def _durable_ds(dsnap: Dict[str, Any]) -> Dict[str, Any]:
    """DataServer snapshot reduced to its durable surface. The accounting
    counters (reads/bytes_read/...) move on READ-ONLY traffic, which is
    deliberately never op-logged, so replay equality must not see them."""
    return {k: dsnap[k] for k in ("kind", "kv", "models", "latest")}


class GatewayMCWorld(MCWorld):
    """See the module docstring. One truth endpoint plays the union of all
    gateways' durable state; the overlay (ring, serve map, per-gateway op
    logs and bases) models which gateway OWNS each piece and what of it
    would survive that gateway's death."""

    def __init__(self, cfg: GatewayMCConfig):
        self.ring = GatewayRing(range(cfg.n_gateways))
        # base slice gid -> serving gateway, as serve lists per gateway
        self.gw_owned: Dict[int, List[int]] = {g: [g] for g in self.ring.gids}
        # per-gateway op log: (record bytes, durable, arrived-forwarded)
        self.gw_logs: Dict[int, List[Tuple[bytes, bool, bool]]] = {
            g: [] for g in self.ring.gids}
        self.gw_window: List[int] = []   # dead, awaiting adoption
        self.gw_crashes = 0
        self.gw_seq = 0                  # Forward envelope correlation
        self.gw_forwards = 0
        self.gw_forwarding: Optional[int] = None
        self.gw_lost: List[str] = []     # no-lost-forward evidence
        self.gw_base: Dict[int, bytes] = {}
        super().__init__(cfg)
        self._rebind_sessions()
        # the boot base each gateway persisted (post-enqueue, pre-traffic)
        self.gw_base = {g: self._slice_snapshot(g) for g in self.ring.gids}

    # -- wiring -------------------------------------------------------------
    def _fresh_servers(self) -> None:
        super()._fresh_servers()
        self.endpoint.op_sink = self._log_op
        self.port = _GatewayPort(self.endpoint, self.sent_types, self, None)
        self.ports = {vid: _GatewayPort(self.endpoint, self.sent_types,
                                        self, vid)
                      for vid in self.vids}
        # all ports share one endpoint; whichever registered its notify
        # hook last wins, so every port must deliver into the world
        for p in (self.port, *self.ports.values()):
            p.set_deliver(self._on_notify)

    def _rebind_sessions(self) -> None:
        for vid in self.vids:
            self.sessions[vid].port = self.ports[vid]

    def _on_notify(self, consumer: str, msg) -> None:
        if isinstance(msg, ForwardNotify):
            # the slice owner addressed this fire to the consumer's home
            # gateway peer link (``gw:<origin>``); the home gateway unwraps
            # and delivers down the consumer's local connection
            self.sent_types.add("ForwardNotify")
            consumer, msg = msg.consumer, msg.inner
        super()._on_notify(consumer, msg)

    def effective_home(self, vid: Optional[str]) -> int:
        """The live gateway serving ``vid``'s connection: its static home
        (round-robin by volunteer index, like ``--ports`` rotation), chased
        through adoptions once the home died — the volunteer reconnected to
        the adopter. World-level traffic (the expiry sweep) homes on the
        smallest live gid."""
        if vid is None:
            return min(self.ring.live())
        return self.ring.serving(
            self.vids.index(vid) % self.cfg.n_gateways)

    # -- op log -------------------------------------------------------------
    def _log_op(self, m) -> None:
        key = route_key(m)
        if key is None:
            owners = list(self.ring.live())   # Bye/DropConsumer/ExpireAll
        else:
            owners = [self.ring.owner_of(key)]
        rec = encode_message({"t": self.now, "m": m})
        durable = bool(self.cfg.oplog_fsync)
        fwd = self.gw_forwarding is not None
        for g in owners:
            self.gw_logs[g].append((rec, durable, fwd))

    def _served_queues(self, g: int) -> List[str]:
        slices = set(self.gw_owned.get(g, ()))
        return sorted(n for n in self.qs.queues
                      if self.ring.base_owner(colocate_results(n)) in slices)

    def _serves_model(self, g: int) -> bool:
        return self.ring.base_owner(MODEL_KEY) in set(self.gw_owned.get(g, ()))

    def _slice_snapshot(self, g: int) -> bytes:
        """The full-state base gateway ``g`` would persist: its served
        queues as a restorable QueueServer snapshot, plus the DataServer
        when it owns the model slice."""
        qsnap = {"kind": "QueueServer",
                 "default_timeout": self.qs.default_timeout,
                 "queues": [self.qs.queues[n].snapshot()
                            for n in self._served_queues(g)]}
        dsnap = self.ds.snapshot() if self._serves_model(g) else None
        return encode_message({"qs": qsnap, "ds": dsnap})

    def _slice_state(self, g: int) -> Dict[str, Any]:
        """The abstracted equality observable for ``g``'s slice, from the
        live truth."""
        queues = {n: _abstract_queue(self.qs.queues[n].snapshot(), self.now)
                  for n in self._served_queues(g)}
        dspart = _durable_ds(self.ds.snapshot()) if self._serves_model(g) \
            else None
        return {"queues": queues, "ds": dspart}

    def _replay_slice(self, g: int) -> Dict[str, Any]:
        """What a peer would reconstruct from ``g``'s base + durable ops —
        the exact ``_on_peer_death`` path: restore the base into scratch
        servers, then re-dispatch each surviving record through a real
        endpoint under the recorded clock."""
        base = decode_message(self.gw_base[g])
        rq = QueueServer(default_timeout=self.cfg.visibility_timeout)
        rq.restore(base["qs"], waiters_from={})
        rd = DataServer()
        if base["ds"] is not None:
            rd.restore(base["ds"])
        applier = None
        if self.cfg.server_apply:
            applier = ServerApplier(self.policy,
                                    lambda blob, result, v: "blob",
                                    gc_keep=self.cfg.gc_keep)
        t = {"now": 0.0}
        ep = ServerEndpoint(rq, rd, clock=VirtualClock(lambda: t["now"]),
                            applier=applier)
        for rec, durable, _fwd in self.gw_logs[g]:
            if not durable:
                continue                 # never fsynced: died with the box
            r = decode_message(rec)
            t["now"] = r["t"]
            ep.handle(r["m"])
        queues = {n: _abstract_queue(rq.queues[n].snapshot(), self.now)
                  for n in self._served_queues(g)}
        dspart = _durable_ds(rd.snapshot()) if self._serves_model(g) else None
        return {"queues": queues, "ds": dspart}

    # -- actions ------------------------------------------------------------
    def enabled_actions(self) -> List[Tuple[str, ...]]:
        cfg = self.cfg
        if self.gw_window:
            # failover window: the cluster holds client requests (the real
            # gateway parks them in ``_owner_for``) until a peer adopts, so
            # only notification fates and the adoption itself interleave
            acts: List[Tuple[str, ...]] = []
            if self.pending:
                if self.drops < cfg.max_drops:
                    acts.append(("drop",))
                if self.dups < cfg.max_dups:
                    acts.append(("dup",))
                acts.append(("deliver",))
            acts.extend(("gw_adopt", g) for g in self.gw_window)
            return acts
        acts = super().enabled_actions()
        if self.gw_crashes < cfg.max_gw_crashes and \
                len(self.ring.live()) > 1:
            acts.extend(("gw_crash", g) for g in cfg.gw_crashable
                        if g in self.ring.live())
        return acts

    def progress_possible(self, acts=None) -> bool:
        acts = self.enabled_actions() if acts is None else acts
        if any(a[0] == "gw_adopt" for a in acts):
            return True                  # adoption is what un-parks the rest
        return super().progress_possible(acts)

    def symmetry_possible(self) -> bool:
        # volunteers are distinguished by home gateway: relabeling them
        # would merge states whose forwarding (and op-log placement) differs
        return False

    def apply(self, action: Tuple[str, ...]) -> None:
        kind = action[0]
        if kind == "gw_crash":
            g = action[1]
            self.gw_crashes += 1
            pre = self._slice_state(g)
            rec = self._replay_slice(g)
            if rec != pre:
                log = self.gw_logs[g]
                dropped = sum(1 for _, d, _f in log if not d)
                fwd = sum(1 for _, d, f in log if not d and f)
                self.gw_lost.append(
                    f"gateway gw{g} crashed and op-log replay diverged "
                    f"from its live slice state: {dropped} acknowledged "
                    f"op(s) were never made durable ({fwd} of them "
                    f"forwarded from a peer gateway) — that work is lost "
                    f"at failover")
            self.ring.kill(g)
            self.gw_window.append(g)
            return
        if kind == "gw_adopt":
            g = action[1]
            adopter = self.ring.adopt(g)
            self.gw_window.remove(g)
            self.gw_owned[adopter] = sorted(
                set(self.gw_owned[adopter]) | set(self.gw_owned.get(g, ())))
            self.gw_owned[g] = []
            # the adopter re-bases over the merged slice (the real gateway
            # buffers a fresh base record after adoption) and starts a
            # clean log; the dead log is subsumed
            self.gw_base[adopter] = self._slice_snapshot(adopter)
            self.gw_logs[adopter] = []
            self.gw_logs[g] = []
            return
        super().apply(action)
        if kind == "rejoin":
            # the base world rebuilt the session on the shared port; hand
            # it back its own home-gateway port
            self.sessions[action[1]].port = self.ports[action[1]]

    # -- branch points ------------------------------------------------------
    def capture(self) -> Dict[str, Any]:
        cap = super().capture()
        cap["gw"] = {
            "dead": sorted(set(self.ring.gids) - set(self.ring.live())),
            "adopted": self.ring.adoptions(),
            "owned": {g: list(v) for g, v in self.gw_owned.items()},
            "logs": {g: list(v) for g, v in self.gw_logs.items()},
            "base": dict(self.gw_base),
            "window": list(self.gw_window),
            "counters": (self.gw_crashes, self.gw_seq, self.gw_forwards),
            "lost": list(self.gw_lost),
            "remote": dict(self.endpoint._remote_consumers),
        }
        return cap

    def restore(self, cap: Dict[str, Any]) -> None:
        gw = cap["gw"]
        ring = GatewayRing(range(self.cfg.n_gateways))
        for g in gw["dead"]:
            ring.kill(g)
        for dead, adopter in gw["adopted"].items():
            ring.adopt(dead, adopter)
        self.ring = ring
        self.gw_owned = {g: list(v) for g, v in gw["owned"].items()}
        self.gw_logs = {g: list(v) for g, v in gw["logs"].items()}
        self.gw_base = dict(gw["base"])
        self.gw_window = list(gw["window"])
        self.gw_crashes, self.gw_seq, self.gw_forwards = gw["counters"]
        self.gw_lost = list(gw["lost"])
        self.gw_forwarding = None
        super().restore(cap)
        self._rebind_sessions()
        # the remote-consumer table is connection state recorded at capture
        # time; the routed re-registration below rebuilds it for resolvable
        # consumers, but a capture taken inside a failover window has
        # unroutable slices — restore the captured truth verbatim
        self.endpoint._remote_consumers = dict(gw["remote"])

    def _reregister_waits(self, cap: Dict[str, Any]) -> None:
        # route each re-subscription through the consumer's own home
        # gateway: a remotely-homed consumer re-registers via a real
        # ``Forward``, repopulating the owner's remote-consumer table the
        # way reconnecting clients would. Inside a failover window the
        # route is legitimately unresolvable (the slice owner is dead and
        # unadopted) — fall back to direct registration on the truth;
        # ``restore`` reinstates the remote table from the capture after.
        def _subscribe(port, msg):
            try:
                port.call(msg)
            except LookupError:
                self.endpoint.handle(msg)

        for qname, kinds in cap["waiters"].items():
            for kind in ("any", "publish"):
                for c in kinds[kind]:
                    _subscribe(self._consumer_port(c),
                               SubscribeQueue(qname, c, kind))
        for consumer, version in cap["watches"]:
            _subscribe(self._consumer_port(consumer),
                       WatchVersion(version, consumer))

    def _consumer_port(self, consumer: str):
        return self.ports.get(consumer, self.port)

    # -- fingerprint overlay ------------------------------------------------
    def extra_state(self) -> Any:
        """The cluster overlay, hashed into the state fingerprint: two
        states whose truth matches but whose ring membership, serve map, or
        op-log/base content differs have different failover futures and
        must not merge."""
        logs = []
        for g in sorted(self.gw_logs):
            entries = self.gw_logs[g]
            digest = hashlib.blake2b(
                b"".join(r for r, _, _ in entries),
                digest_size=8).hexdigest() if entries else ""
            logs.append([g, len(entries),
                         sum(1 for _, d, _f in entries if d), digest])
        bases = [[g, hashlib.blake2b(self.gw_base[g],
                                     digest_size=8).hexdigest()]
                 for g in sorted(self.gw_base)] if self.gw_base else []
        return ["gw",
                sorted(set(self.ring.gids) - set(self.ring.live())),
                sorted(self.ring.adoptions().items()),
                list(self.gw_window),
                [[g, list(v)] for g, v in sorted(self.gw_owned.items())],
                self.gw_crashes, len(self.gw_lost), logs, bases]
