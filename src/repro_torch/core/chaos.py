"""Deterministic chaos harness for the queue federation.

Volunteer platforms live and die by correctness under churn: MLitB and Pando
both treat worker/server failure as the common case. This module turns that
into a replayable test instrument: a ``ChaosSimulator`` drives the ordinary
discrete-event ``Simulator`` while injecting a scripted schedule of faults —
volunteer join/leave, forced visibility-expiry sweeps, and live shard
add/remove on an elastic ``ShardedQueueServer`` federation — at chosen virtual
times.

The headline property is *metamorphic*: because shard membership is supposed
to be semantics-invisible, ANY chaos schedule executed against a K-shard
federation must produce the identical ``SimResult`` (final version, task
counts, full timeline, byte counts, event counts) as the same schedule against
a single ``QueueServer``, in both ``mode="event"`` and ``mode="poll"``. Shard
events are no-ops on a single server, so the schedule is directly reusable on
both sides. ``metamorphic_check`` runs that comparison; ``main`` (the CI
smoke) sweeps it over fixed seeds x {churn-only, reshard-only, mixed}.

## Chaos testing

Seeding and replay: a schedule is either scripted explicitly (a list of
``ChaosEvent``) or generated by ``churn_schedule`` / ``reshard_schedule`` /
``mixed_schedule`` / ``snapshot_schedule`` (the last one adds whole-server
``snapshot_restore`` round-trips — durable-state serialization must be
invisible mid-run) from an integer seed via a private ``random.Random(seed)``
stream — no global RNG state, no wall clock. The virtual-time event loop is
single-threaded and breaks ties by post order, and every cross-queue side
effect (expiry requeues, consumer drops) is ordered by (deadline, queue name)
rather than by shard layout, so running the same (problem, specs, schedule,
mode, n_shards) tuple twice replays the run bit-for-bit: identical
``SimResult``, identical timeline floats. That is what makes any chaos
failure reproducible from just its seed.

Conservation: around every shard membership change the harness snapshots a
census of per-queue live state (published/acked/depth/in-flight/requeued and
the pending bodies themselves) and asserts it is unchanged by the migration —
``remove_shard`` must lose zero messages — then re-checks every queue's
structural invariants (``Queue.check_invariants``).

Transport faults: ``run_chaos``/``metamorphic_check`` accept
``transport="wire"`` (every protocol message round-trips through bytes) and
``faults=FaultSpec(...)`` (seeded drop/duplicate/delay of ``Wake`` /
``VersionReady`` notification deliveries — the DataServer-fault rung). A
dropped ``VersionReady`` strands a volunteer holding a map lease; recovery is
the visibility-timeout expiry path, and the metamorphic contract must STILL
hold because the fault decisions replay identically on both sides of the
single-vs-sharded pair.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.protocol import (OPLOG_TYPES, ExpireAll, ServerApplier,
                                 ServerEndpoint, decode_message,
                                 encode_message)
from repro_torch.core.queue import QueueServer, ShardedQueueServer, VirtualClock
from repro_torch.core.simulator import (CostModel, Simulator, SimResult,
                                  SyntheticProblem, VolunteerSpec)
from repro_torch.core.transport import FaultSpec

CHAOS_KINDS = ("join", "leave", "expire", "add_shard", "remove_shard",
               "snapshot_restore", "gateway_kill")


@dataclass(frozen=True)
class ChaosEvent:
    t: float                      # virtual time the fault fires
    kind: str                     # one of CHAOS_KINDS
    vid: Optional[str] = None     # join/leave target
    speed: float = 1.0            # joining volunteer's device speed
    shard: int = 0                # remove_shard target (mod live shard count)

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}")


@dataclass
class ChaosSchedule:
    """A sorted, replayable fault script. ``seed``/``label`` are provenance
    only — the events are the schedule."""
    events: List[ChaosEvent]
    seed: Optional[int] = None
    label: str = "scripted"

    def __post_init__(self):
        self.events = sorted(
            self.events, key=lambda e: (e.t, e.kind, e.vid or "", e.shard))


def churn_schedule(seed: int, *, horizon: float = 30.0, n_events: int = 10,
                   leavable: Sequence[str] = (),
                   speed_range: Tuple[float, float] = (0.5, 2.0),
                   ) -> ChaosSchedule:
    """Volunteer join/leave only. Leaves target chaos-joined volunteers plus
    any ``leavable`` base volunteers — never the protected stable cohort, so
    the run can always finish."""
    rng = random.Random(seed)
    events: List[ChaosEvent] = []
    pool = list(leavable)
    # walk fire times in order so a leave only ever targets a volunteer whose
    # join fires earlier — every generated event is a real fault, not a no-op
    times = sorted(round(rng.uniform(0.5, horizon), 3) for _ in range(n_events))
    for i, t in enumerate(times):
        if rng.random() < 0.55 or not pool:
            vid = f"c{i:02d}"
            events.append(ChaosEvent(t, "join", vid=vid,
                                     speed=round(rng.uniform(*speed_range), 3)))
            pool.append(vid)
        else:
            events.append(ChaosEvent(t, "leave",
                                     vid=pool.pop(rng.randrange(len(pool)))))
    return ChaosSchedule(events, seed=seed, label=f"churn-{seed}")


def reshard_schedule(seed: int, *, horizon: float = 30.0, n_events: int = 8,
                     ) -> ChaosSchedule:
    """Shard membership changes (plus forced expiry sweeps) only."""
    rng = random.Random(seed + 10_000)
    events: List[ChaosEvent] = []
    for _ in range(n_events):
        t = round(rng.uniform(0.5, horizon), 3)
        r = rng.random()
        if r < 0.45:
            events.append(ChaosEvent(t, "add_shard"))
        elif r < 0.85:
            events.append(ChaosEvent(t, "remove_shard", shard=rng.randrange(8)))
        else:
            events.append(ChaosEvent(t, "expire"))
    return ChaosSchedule(events, seed=seed, label=f"reshard-{seed}")


def mixed_schedule(seed: int, *, horizon: float = 30.0, n_events: int = 14,
                   leavable: Sequence[str] = ()) -> ChaosSchedule:
    """Interleaved volunteer churn AND shard membership changes — the regime
    the rebalancing code actually has to survive."""
    churn = churn_schedule(seed, horizon=horizon,
                           n_events=max(1, n_events // 2), leavable=leavable)
    reshard = reshard_schedule(seed, horizon=horizon,
                               n_events=max(1, n_events - n_events // 2))
    return ChaosSchedule(churn.events + reshard.events, seed=seed,
                         label=f"mixed-{seed}")


def snapshot_schedule(seed: int, *, horizon: float = 30.0,
                      n_events: int = 12,
                      leavable: Sequence[str] = ()) -> ChaosSchedule:
    """Mixed churn + reshard chaos PLUS whole-server snapshot/restore
    round-trips at random instants — the crash-recovery drill under load:
    durable-state serialization must be invisible to a live run."""
    base = mixed_schedule(seed, horizon=horizon,
                          n_events=max(1, n_events - 3), leavable=leavable)
    rng = random.Random(seed + 77_000)
    snaps = [ChaosEvent(round(rng.uniform(0.5, horizon), 3),
                        "snapshot_restore") for _ in range(3)]
    return ChaosSchedule(base.events + snaps, seed=seed,
                         label=f"snapshot-{seed}")


def gateway_schedule(seed: int, *, horizon: float = 30.0,
                     n_events: int = 12,
                     leavable: Sequence[str] = ()) -> ChaosSchedule:
    """Mixed churn + reshard chaos PLUS gateway kill -9 drills at random
    instants: each ``gateway_kill`` replays the op-log journal (base + every
    state-changing op since) into scratch servers and asserts the replay
    reconstructs the live durable state bit-for-bit — the failover adoption
    path exercised under load — then restarts the server from its own
    snapshot bytes, exactly as a peer adopter would."""
    base = mixed_schedule(seed, horizon=horizon,
                          n_events=max(1, n_events - 3), leavable=leavable)
    rng = random.Random(seed + 91_000)
    kills = [ChaosEvent(round(rng.uniform(0.5, horizon), 3),
                        "gateway_kill") for _ in range(3)]
    return ChaosSchedule(base.events + kills, seed=seed,
                         label=f"gateway-{seed}")


def federation_census(qs) -> Dict[str, Tuple]:
    """Per-queue live-state fingerprint: everything a migration must preserve.
    Covers the pending bodies in FIFO order AND the full in-flight table
    (tag, consumer, deadline, body) so a rebalance that corrupted either side
    cannot compare equal. Works on QueueServer and ShardedQueueServer alike
    (merged .queues view)."""
    return {name: (q.published, q.acked, q.requeued, q.depth, q.in_flight,
                   q.waiters, tuple(q.peek_all()),
                   tuple(sorted(((tag, inf.consumer, inf.deadline, inf.body)
                                 for tag, inf in q._in_flight.items()),
                                key=lambda e: e[0])))
            for name, q in qs.queues.items()}


class ChaosSimulator(Simulator):
    """Simulator + scripted fault injection at chosen virtual times.

    Shard events are applied only when the underlying server is a
    ``ShardedQueueServer`` (single-server runs treat them as no-op ticks of
    the virtual clock), which is exactly what makes a schedule reusable for
    the single-vs-sharded metamorphic comparison.
    """

    def __init__(self, problem, specs: List[VolunteerSpec], *,
                 schedule: ChaosSchedule, validate: bool = True, **kw):
        super().__init__(problem, specs, **kw)
        self.schedule = schedule
        self.validate = validate
        self.chaos_log: List[Tuple[float, str]] = []
        self.queues_migrated = 0
        self.snapshots_roundtripped = 0
        self.gateway_kills = 0
        self.journal_ops_replayed = 0
        self._journal: List[bytes] = []
        self._journal_base: Optional[bytes] = None
        if any(ev.kind == "gateway_kill" for ev in schedule.events):
            # op-log journal, as the gateway keeps it: a full-state base plus
            # every state-changing op since, each framed with its virtual
            # time. The endpoint sinks every dispatched op; the run loop's
            # expiry sweeps bypass the endpoint, so the instance's
            # ``expire_all`` is wrapped to journal the same ``ExpireAll``
            # wire op the gateway's sweeper logs.
            self._journal_base = self._snapshot_bytes()
            self.endpoint.op_sink = self._journal_op
            orig_expire = self.qs.expire_all

            def _swept_expire(now, _orig=orig_expire):
                self._journal_op(ExpireAll(now))
                return _orig(now)

            self.qs.expire_all = _swept_expire
        for ev in schedule.events:
            self._post(ev.t, lambda ev=ev: self._chaos(ev))

    # --------------------------------------------------------------- journal
    def _snapshot_bytes(self) -> bytes:
        return encode_message({"qs": self.qs.snapshot(),
                               "ds": self.ds.snapshot()})

    def _journal_op(self, m) -> None:
        self._journal.append(encode_message({"t": self._now, "m": m}))

    @staticmethod
    def _durable_state(qs, ds) -> Dict:
        """The durable-equality observable: per-queue snapshots with the
        session-coupled wake state masked (banked signals; the wakeups
        counter moves on live-subscriber wakes a replay has no waiters to
        reproduce), plus the DataServer's durable surface — its accounting
        counters move on read-only traffic that is deliberately never
        journaled."""
        queues = {}
        for name, q in qs.queues.items():
            s = q.snapshot()
            for k in ("signal", "pub_signal", "wakeups"):
                s.pop(k, None)
            queues[name] = s
        d = ds.snapshot()
        return {"queues": queues,
                "ds": {k: d[k] for k in ("kv", "models", "latest")}}

    def _replay_journal(self) -> Dict:
        """What a peer adopter reconstructs after kill -9: restore the base
        into scratch servers, then re-dispatch every journaled op through a
        real endpoint under the recorded clock."""
        base = decode_message(self._journal_base)
        qsnap = base["qs"]
        if qsnap.get("kind") == "ShardedQueueServer":
            # shard layout is semantics-invisible: the adopter replays the
            # merged queue view into one server
            qsnap = {"kind": "QueueServer",
                     "default_timeout": qsnap["default_timeout"],
                     "queues": [q for shard in qsnap["shards"]
                                for q in shard["queues"]]}
        rq = QueueServer(default_timeout=qsnap["default_timeout"])
        rq.restore(qsnap, waiters_from={})
        rd = DataServer()
        rd.restore(base["ds"])
        applier = None
        if self.server_apply:
            applier = ServerApplier(self.policy,
                                    lambda blob, result, v: "blob",
                                    model_nbytes=self.model_bytes)
        t = {"now": 0.0}
        ep = ServerEndpoint(rq, rd, clock=VirtualClock(lambda: t["now"]),
                            applier=applier)
        for rec in self._journal:
            r = decode_message(rec)
            t["now"] = r["t"]
            ep.handle(r["m"])
            self.journal_ops_replayed += 1
        return self._durable_state(rq, rd)

    # ------------------------------------------------------------------ faults
    def _chaos(self, ev: ChaosEvent) -> None:
        t = self._now
        self.chaos_log.append((t, ev.kind))
        if ev.kind == "join":
            if ev.vid not in self.specs:
                self.specs[ev.vid] = VolunteerSpec(ev.vid, speed=ev.speed,
                                                   join_time=t)
                self._active_cache = None    # spec set changed
                self._post(t, lambda: self._wake(ev.vid))
        elif ev.kind == "leave":
            spec = self.specs.get(ev.vid)
            if spec is not None and spec.leave_time > t:
                # eager disconnect, like the Coordinator: Bye kills the
                # subscriptions and requeues held leases NOW (requeues wake
                # other waiters) and clears the session's client state; any
                # wake the volunteer already consumed is passed on by the
                # dead-volunteer path in _wake
                spec.leave_time = t
                self._active_cache = None    # departure reshapes the fleet
                self._session(ev.vid).bye()
        elif ev.kind == "expire":
            # the posted event forces the virtual clock (and thus the run
            # loop's deadline check) to visit time t — expiry then happens at
            # the scheduled instant instead of the next organic event
            pass
        elif ev.kind == "snapshot_restore":
            # crash-recovery drill: serialize the ENTIRE server state
            # (queues + data) through real snapshot bytes and restore it in
            # place mid-run. Durability must be semantics-invisible — live
            # waiters/watchers are process state and survive an in-process
            # restore, everything else round-trips the codec — so the run
            # (and the single-vs-sharded metamorphic pair) must not notice.
            before = federation_census(self.qs) if self.validate else None
            state = decode_message(encode_message(
                {"qs": self.qs.snapshot(), "ds": self.ds.snapshot()}))
            self.qs.restore(state["qs"])
            self.ds.restore(state["ds"])
            self.snapshots_roundtripped += 1
            if self.validate:
                after = federation_census(self.qs)
                assert after == before, (
                    f"snapshot/restore at t={t} changed live queue state:\n"
                    f"before={before}\nafter={after}")
                for q in self.qs.queues.values():
                    q.check_invariants()
        elif ev.kind == "gateway_kill":
            # kill -9 failover drill: the journal (base + ops) must rebuild
            # the live durable state bit-for-bit — this is exactly what a
            # peer adopter replays — then the server restarts from snapshot
            # bytes (the adoption swap) and a fresh base epoch begins
            live = self._durable_state(self.qs, self.ds)
            replayed = self._replay_journal()
            assert replayed == live, (
                f"gateway_kill at t={t}: op-log replay diverged from live "
                f"durable state over {len(self._journal)} journaled op(s)\n"
                f"replayed={replayed}\nlive={live}")
            before = federation_census(self.qs) if self.validate else None
            state = decode_message(encode_message(
                {"qs": self.qs.snapshot(), "ds": self.ds.snapshot()}))
            self.qs.restore(state["qs"])
            self.ds.restore(state["ds"])
            self.gateway_kills += 1
            self._journal_base = self._snapshot_bytes()
            self._journal = []
            if self.validate:
                after = federation_census(self.qs)
                assert after == before, (
                    f"gateway_kill at t={t} changed live queue state:\n"
                    f"before={before}\nafter={after}")
                for q in self.qs.queues.values():
                    q.check_invariants()
        elif ev.kind in ("add_shard", "remove_shard"):
            if not isinstance(self.qs, ShardedQueueServer):
                return
            before = federation_census(self.qs) if self.validate else None
            if ev.kind == "add_shard":
                moved = self.qs.add_shard()
            else:
                if len(self.qs.shards) <= 1:
                    return
                moved = self.qs.remove_shard(ev.shard % len(self.qs.shards))
            self.queues_migrated += len(moved)
            if self.validate:
                after = federation_census(self.qs)
                assert after == before, (
                    f"rebalance at t={t} changed live queue state:\n"
                    f"before={before}\nafter={after}")
                for q in self.qs.queues.values():
                    q.check_invariants()


def run_chaos(problem, specs: List[VolunteerSpec], schedule: ChaosSchedule, *,
              mode: str = "event", n_shards: int = 1,
              cost: Optional[CostModel] = None,
              visibility_timeout: float = 1.0e9,
              transport: str = "inproc", faults: Optional[FaultSpec] = None,
              fault_seed: int = 0, policy: PolicyLike = None,
              placement: Optional[Callable[[str], str]] = None,
              **kw) -> SimResult:
    sim = ChaosSimulator(problem, specs, schedule=schedule, mode=mode,
                         n_shards=n_shards, cost=cost,
                         visibility_timeout=visibility_timeout,
                         transport=transport, faults=faults,
                         fault_seed=fault_seed, policy=policy,
                         placement=placement, **kw)
    return sim.run()


# --------------------------------------------------------------------- smoke
def _smoke_problem() -> SyntheticProblem:
    return SyntheticProblem(n_versions=5, n_mb=6, model_bytes=1.0e6,
                            grad_bytes=2.0e5, map_flops=8.0e8,
                            reduce_flops=2.0e7)


def _smoke_specs() -> List[VolunteerSpec]:
    # 4 stable volunteers (never targeted by chaos leaves) + 2 churnable
    specs = [VolunteerSpec(f"v{i:02d}", speed=0.7 + 0.3 * i) for i in range(4)]
    specs += [VolunteerSpec(f"x{i:02d}", speed=1.0 + 0.2 * i) for i in range(2)]
    return specs


def _smoke_cost() -> CostModel:
    return CostModel(flops_per_sec=2.0e9, latency=0.020, bandwidth=12.5e6,
                     poll_interval=0.200, cache_bytes=1e15)


def metamorphic_check(schedule: ChaosSchedule, *, mode: str = "event",
                      n_shards: int = 3,
                      visibility_timeout: float = 1.0e9,
                      transport: str = "inproc",
                      faults: Optional[FaultSpec] = None,
                      fault_seed: int = 0,
                      policy: PolicyLike = None,
                      placement: Optional[Callable[[str], str]] = None,
                      ) -> Tuple[SimResult, SimResult]:
    """Run ``schedule`` on a single server and on an n_shards federation —
    same transport, same seeded notification faults, same aggregation policy
    (and optionally a shard-placement rule on the federation side) — and
    assert the SimResults are identical. Returns (single, sharded)."""
    single = run_chaos(_smoke_problem(), _smoke_specs(), schedule, mode=mode,
                       n_shards=1, cost=_smoke_cost(),
                       visibility_timeout=visibility_timeout,
                       transport=transport, faults=faults,
                       fault_seed=fault_seed, policy=policy)
    sharded = run_chaos(_smoke_problem(), _smoke_specs(), schedule, mode=mode,
                        n_shards=n_shards, cost=_smoke_cost(),
                        visibility_timeout=visibility_timeout,
                        transport=transport, faults=faults,
                        fault_seed=fault_seed, policy=policy,
                        placement=placement)
    assert single == sharded, (
        f"metamorphic violation ({schedule.label}, mode={mode}, "
        f"transport={transport}, policy={make_policy(policy).spec}): sharded "
        f"SimResult diverged from single-server SimResult")
    return single, sharded


def main(seeds: int = 5, policy: str = "sync") -> None:
    """CI smoke: metamorphic single-vs-sharded equality over fixed seeds x
    {churn, reshard, mixed, snapshot} x {event, poll}, under the chosen
    aggregation policy (``--policy staleness:2`` / ``--policy local:4`` run
    the same contract with no reduce barrier at all)."""
    pol = make_policy(policy)
    expected = pol.n_updates(_smoke_problem(), _smoke_problem().n_versions)
    leavable = [s.vid for s in _smoke_specs() if s.vid.startswith("x")]
    checked = 0
    for seed in range(seeds):
        for make in (lambda s: churn_schedule(s, leavable=leavable),
                     reshard_schedule,
                     lambda s: mixed_schedule(s, leavable=leavable),
                     lambda s: snapshot_schedule(s, leavable=leavable),
                     lambda s: gateway_schedule(s, leavable=leavable)):
            schedule = make(seed)
            for mode in ("event", "poll"):
                single, sharded = metamorphic_check(schedule, mode=mode,
                                                    policy=pol)
                checked += 1
                print(f"chaos_smoke,{pol.spec},{schedule.label},{mode},"
                      f"final_version={sharded.final_version},"
                      f"events={sharded.events},requeues={sharded.requeues},"
                      f"stale_discards={sharded.stale_discards}")
                assert single.final_version == expected, \
                    (schedule.label, mode, single.final_version, expected)
    # gateway-kill invisibility leg: a kill -9 + journal-replay + restart
    # must be a semantic no-op, so substituting every gateway_kill with a
    # pure clock tick ("expire") must reproduce the SimResult bit-for-bit
    for seed in range(seeds):
        schedule = gateway_schedule(seed, leavable=leavable)
        ref = ChaosSchedule(
            [ChaosEvent(e.t, "expire") if e.kind == "gateway_kill" else e
             for e in schedule.events],
            seed=seed, label=f"gateway-ref-{seed}")
        killed = run_chaos(_smoke_problem(), _smoke_specs(), schedule,
                           mode="event", cost=_smoke_cost(), policy=pol)
        ticked = run_chaos(_smoke_problem(), _smoke_specs(), ref,
                           mode="event", cost=_smoke_cost(), policy=pol)
        checked += 1
        assert killed == ticked, (
            f"gateway_kill was not semantics-invisible ({schedule.label}, "
            f"policy={pol.spec})")
    # tight-visibility leg: leases expire mid-task, so migrations carry live
    # in-flight deadlines — the hardest case for the deadline-index handoff
    for seed in range(seeds):
        schedule = mixed_schedule(seed, leavable=leavable)
        for mode in ("event", "poll"):
            single, _ = metamorphic_check(schedule, mode=mode,
                                          visibility_timeout=0.6, policy=pol)
            checked += 1
            assert single.requeues > 0 and single.expire_scans > 0, \
                "tight-visibility leg produced no expiries"
    # wire + message-fault leg: every protocol message round-trips through
    # bytes AND seeded notification faults (dropped/duplicated/delayed Wake
    # and VersionReady deliveries) hit both sides identically; recovery is
    # the lease-expiry path, and the contract must still hold bit-for-bit
    # budget 2: a dropped VersionReady makes its volunteer comatose (the task
    # recovers via lease expiry, the client does not), so strand at most 2 of
    # the 6 volunteers and the survivors must still finish every version
    faults = FaultSpec(drop_version_ready=0.3, duplicate=0.2, delay=0.15,
                       delay_dt=0.4, max_faults=2)
    for seed in range(seeds):
        schedule = mixed_schedule(seed, leavable=leavable)
        single, _ = metamorphic_check(schedule, mode="event",
                                      transport="wire", faults=faults,
                                      fault_seed=seed,
                                      visibility_timeout=2.0, policy=pol)
        checked += 1
        if pol.barrier:
            # sync commits each version exactly once — keep the exact check
            assert single.final_version == expected, \
                ("wire+faults", seed, single.final_version)
        else:
            # expiry-duplicate tickets may legitimately commit extra updates
            assert single.final_version >= expected, \
                ("wire+faults", seed, single.final_version, expected)
        assert single.wire_bytes > 0, "wire transport measured no bytes"
    print(f"# OK: {checked} chaos runs under policy={pol.spec} — sharded "
          f"SimResult bit-matched single-server under every schedule, both "
          f"modes, including wire-transport runs with injected notification "
          f"faults")


def replay_mc_trace(payload: Dict):
    """Replay a model-checker counterexample (the JSON payload emitted by
    ``repro_torch.analysis.mc`` / inlined in an MC CI violation) step by step
    against a fresh world, re-checking every invariant. Returns the
    ``Replay`` outcome (``.invariant``/``.message``/``.step``); the repro
    scripts the checker generates call this, making an exhaustively-found
    violation an ordinary runnable chaos artifact. Imported lazily so the
    chaos harness itself keeps zero dependency on the analysis package."""
    from repro_torch.analysis.mc import replay_payload
    return replay_payload(payload)


def _replay_main(path: str) -> int:
    import json
    import pathlib
    payload = json.loads(pathlib.Path(path).read_text())
    out = replay_mc_trace(payload)
    if out.violation is None:
        print(f"# counterexample did NOT reproduce: replay ran "
              f"{out.applied}/{len(payload['trace'])} steps cleanly")
        return 1
    print(f"# reproduced at step {out.step}: [{out.invariant}] {out.message}")
    want = payload.get("invariant")
    if want and out.invariant != want:
        print(f"# WARNING: payload expected [{want}]")
        return 1
    return 0


if __name__ == "__main__":
    import argparse
    import sys
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5,
                    help="number of fixed seeds to sweep (default 5)")
    ap.add_argument("--policy", default="sync",
                    help="aggregation policy: sync | staleness:<s> | "
                         "local:<k> (default sync)")
    ap.add_argument("--replay", default=None, metavar="PAYLOAD.json",
                    help="replay a model-checker counterexample payload "
                         "instead of running the chaos sweep")
    args = ap.parse_args()
    if args.replay is not None:
        sys.exit(_replay_main(args.replay))
    main(seeds=args.seeds, policy=args.policy)
