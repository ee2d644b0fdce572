"""Discrete-event simulator of the JSDoop deployment (cluster & classroom).

Reproduces the paper's scalability experiments (Figs. 4-8, Table 4) on one CPU
by simulating heterogeneous volunteers over the *same* protocol the real
Coordinator uses: each volunteer is a ``protocol.VolunteerSession`` speaking
typed messages to the QueueServer/DataServer through a ``transport``. The
Simulator owns only virtual time and costs:

- network: latency + bytes/bandwidth per transfer (model pull, gradient push).
  With ``transport="wire"`` every message round-trips through canonical bytes
  and the cost model prices the MEASURED envelope sizes (plus the logical
  payload bytes the synthetic placeholders stand in for) instead of
  hand-estimating whole exchanges from ``model_bytes``/``grad_bytes``;
- compute: task_flops / (volunteer speed * effective_throughput),
- cache effect: the paper attributes its superlinear relative speedup to "more
  of its data can be placed in fast memory" when the work is spread over more
  processors [Foster'95]. We model this mechanistically: a volunteer that must
  cycle the whole working set (model + optimizer + all mini-batches of a batch)
  through its cache sustains a penalized throughput; when k>=2 volunteers split
  the batch, the per-volunteer working set fits and throughput recovers.

All protocol semantics (lease/ack/requeue, version waits, reduce barrier,
churn) live in the shared ``VolunteerSession`` — identical to the real
Coordinator by construction, and asserted by tests. The consistency model is
the session's ``AggregationPolicy`` (``policy=``): sync-BSP map/reduce,
bounded-staleness async SGD (admit/discard at commit time, ticket nacked on
discard), or local-steps averaging — every policy schedule-deterministic, so
the chaos metamorphic contract holds per policy.

Two coordination modes share every cost and protocol rule:

- ``mode="event"`` (default): waits are push-based. A ``Blocked`` session
  subscribes (task queue, ``DataServer.watch_version``, or the reduce
  barrier's publish-only subscription) and the ``Wake``/``VersionReady``
  notification message resumes it. Total events scale with the amount of
  WORK, not with waiting time.
- ``mode="poll"``: the pre-subscription baseline — every wait reschedules
  itself every ``cost.poll_interval`` seconds, so events scale with
  O(volunteers x makespan / poll_interval). Kept for benchmarking
  (`benchmarks/volunteer_scaling.py`) and the cross-mode equivalence tests.

``faults=FaultSpec(...)`` wraps the transport in a ``FaultyTransport`` that
drops/duplicates/delays notification deliveries; a lost wake strands its
volunteer, and the run recovers through the visibility-timeout expiry path
(the run loop advances the clock to the next deadline when the event heap
would otherwise starve).
"""
from __future__ import annotations

import heapq
import itertools
import math
from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.core.protocol import (Blocked, Busy, LocalWork, MapWork, NoTask,
                                       ReduceWork, ServerApplier, ServerEndpoint,
                                       TaskDone, VolunteerSession, wire_size)
from repro_torch.core.queue import QueueServer, ShardedQueueServer, VirtualClock
from repro_torch.core.transport import FaultSpec, FaultyTransport, make_transport


@dataclass
class VolunteerSpec:
    vid: str
    speed: float = 1.0              # relative device speed
    join_time: float = 0.0
    leave_time: float = math.inf


@dataclass(frozen=True)
class _SyntheticTrainParams:
    batch_size: int
    mini_batch_size: int
    mini_batches_to_accumulate: int
    sample_len: int
    batches_per_epoch: int


@dataclass(frozen=True)
class _SyntheticConfig:
    vocab: int


class SyntheticProblem:
    """Duck-typed TrainingProblem stand-in for timing-only simulations.

    The Simulator never calls map_compute/reduce_compute, so scale studies
    (1k-10k volunteers) don't need a real model at all — just the task schedule
    and the byte/flop sizes the cost model consumes. Constructs in microseconds
    at any scale.
    """

    def __init__(self, *, n_versions: int = 20, n_mb: int = 32,
                 mini_batch_size: int = 8, sample_len: int = 50,
                 vocab: int = 96, model_bytes: float = 2.0e6,
                 grad_bytes: float = 1.0e6, map_flops: float = 1.0e9,
                 reduce_flops: float = 2.0e7, batches_per_epoch: int = 0):
        self.tp = _SyntheticTrainParams(
            batch_size=n_mb * mini_batch_size,
            mini_batch_size=mini_batch_size,
            mini_batches_to_accumulate=n_mb,
            sample_len=sample_len,
            batches_per_epoch=batches_per_epoch or n_versions)
        self.cfg = _SyntheticConfig(vocab=vocab)
        self.n_versions = n_versions
        self.model_bytes = model_bytes
        self.grad_bytes = grad_bytes
        self._map_flops = map_flops
        self._reduce_flops = reduce_flops

    def version_to_epoch_batch(self, version: int):
        return divmod(version, self.tp.batches_per_epoch)

    def flops_per_map(self) -> float:
        return self._map_flops

    def flops_per_reduce(self) -> float:
        return self._reduce_flops


@dataclass
class CostModel:
    flops_per_sec: float = 2.0e9    # sustained JS/WebGL throughput of one device
    latency: float = 0.030          # one-way message latency (s)
    bandwidth: float = 12.5e6       # bytes/s (100 Mbit LAN)
    poll_interval: float = 0.200    # dependency-wait poll (s) — poll mode only
    # cache-effect model (superlinearity, paper §V.A):
    cache_bytes: float = 4.0e6      # fast-memory budget per device
    thrash_penalty: float = 0.22    # throughput multiplier when set exceeds cache
    # server-apply service time: seconds per batched apply DISPATCH on the
    # parameter server. The applier drains serially, and every commit that
    # arrives while a dispatch is pending rides the next one for free — the
    # batched fast path's economics (benchmarks/applier_bench.py measures the
    # real constant). 0.0 (default) keeps commits inline and every existing
    # run bit-identical.
    dispatch_cost: float = 0.0

    def throughput(self, speed: float, working_set: float) -> float:
        base = self.flops_per_sec * speed
        if working_set > self.cache_bytes:
            return base * self.thrash_penalty
        return base

    def xfer(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth


@dataclass
class TimelineEvent:
    vid: str
    kind: str                        # "Compute" (map) | "Accumulate" (reduce)
    start: float
    end: float
    version: int


@dataclass
class SimResult:
    makespan: float
    timeline: List[TimelineEvent]
    tasks_by_worker: Dict[str, int]
    requeues: int
    final_version: int
    bytes_sent: float
    busy_time: Dict[str, float]
    events: int = 0                  # simulator events processed
    poll_events: int = 0             # events that were poll reschedules
    mode: str = "event"
    expire_scans: int = 0            # expiry sweeps actually performed
    wire_bytes: float = 0.0          # measured transport bytes (wire mode)
    stale_discards: int = 0          # barrierless results refused as stale
    policy: str = "sync"             # aggregation policy spec


class Simulator:
    """Event loop: volunteers wake, lease, (wait | compute), publish, ack."""

    def __init__(self, problem: TrainingProblem, specs: List[VolunteerSpec], *,
                 cost: CostModel = None, n_versions: Optional[int] = None,
                 visibility_timeout: float = 900.0, grad_bytes=None,
                 model_bytes=None, mode: str = "event", n_shards: int = 1,
                 max_events: int = 5_000_000,
                 transport: str = "inproc",
                 faults: Optional[FaultSpec] = None, fault_seed: int = 0,
                 watchdog: Optional[bool] = None,
                 policy: PolicyLike = None,
                 placement: Optional[Callable[[str], str]] = None,
                 server_apply: bool = False):
        from repro_torch.core.initiator import enqueue_problem
        if mode not in ("event", "poll"):
            raise ValueError(f"unknown mode {mode!r}")
        self.problem = problem
        self.policy = make_policy(policy)
        self.cost = cost or CostModel()
        self.mode = mode
        self.max_events = max_events
        self.qs: Union[QueueServer, ShardedQueueServer] = (
            QueueServer(default_timeout=visibility_timeout) if n_shards <= 1
            else ShardedQueueServer(n_shards,
                                    default_timeout=visibility_timeout,
                                    placement=placement))
        self.ds = DataServer()
        self._now = 0.0
        # the server is the lease-time authority: the endpoint stamps every
        # lease with THIS engine's virtual clock (identical values to the
        # client-supplied now under a single-threaded event loop, so runs
        # stay bit-identical — but the authority now has one owner)
        self.endpoint = ServerEndpoint(self.qs, self.ds,
                                       clock=VirtualClock(lambda: self._now))
        self.port = make_transport(transport, self.endpoint)
        if faults is not None:
            self.port = FaultyTransport(
                self.port, faults, seed=fault_seed,
                defer=lambda dt, fn: self._post(self._now + dt, fn))
        self.port.set_deliver(self._on_notify)
        self._measuring = self.port.measures_bytes
        # Push notifications are lossy only under injected faults; real
        # volunteer clients back a push wait with a coarse re-check timer
        # (paper §IV.F solution 2: "check if a datum has been modified").
        # Armed ONLY when faults are injected so fault-free event-mode runs
        # stay bit-identical (and event counts unpolluted).
        self._watchdog_dt = (
            visibility_timeout if math.isfinite(visibility_timeout)
            else 10.0 * self.cost.poll_interval)
        self._watchdog = (faults is not None if watchdog is None
                          else watchdog) and mode == "event"
        self.n_versions = (n_versions if n_versions is not None
                           else problem.n_versions)
        self.n_updates = self.policy.n_updates(problem, self.n_versions)
        enqueue_problem(problem, self.qs, self.ds, n_versions=self.n_versions,
                        policy=self.policy, store_real_model=False)
        self.specs = {s.vid: s for s in specs}
        # sorted join/leave arrays for O(log N) active-fleet counts — the
        # per-task churn scan is the 100k-1M volunteer bottleneck. Rebuilt
        # lazily; ChaosSimulator invalidates on every spec mutation.
        self._active_cache: Optional[Tuple[List[float], List[float]]] = None
        self.sessions: Dict[str, VolunteerSession] = {}
        self.grad_bytes = grad_bytes if grad_bytes is not None else problem.grad_bytes
        self.model_bytes = model_bytes if model_bytes is not None else problem.model_bytes
        self.map_flops = problem.flops_per_map()
        self.reduce_flops = problem.flops_per_reduce()
        # per-batch working set: model+opt state+minibatch activations per task
        self.server_apply = bool(server_apply)
        if self.server_apply:
            if self.policy.barrier:
                raise ValueError("server_apply needs a barrierless policy "
                                 "(staleness:<s> or local:<k>)")
            # the synthetic applier mirrors commit_update("blob", model_bytes)
            self.endpoint.applier = ServerApplier(
                self.policy, lambda blob, result, v: "blob",
                model_nbytes=self.model_bytes)
        # serial applier pipeline state for CostModel.dispatch_cost: end of
        # the last scheduled dispatch, start of the last scheduled dispatch
        # (arrivals before a dispatch starts pool into it), and counters
        self._applier_free_at = 0.0
        self._applier_batch_start = float("-inf")
        self.apply_dispatches = 0
        self.batched_dispatch_credits = 0
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.timeline: List[TimelineEvent] = []
        self.tasks_by_worker: Dict[str, int] = {}
        self.busy: Dict[str, float] = {}
        self.bytes_sent = 0.0
        self.done_time = 0.0
        self.events = 0
        self.poll_events = 0
        self.expire_scans = 0
        self.expired = 0                 # messages requeued by expiry sweeps
        self.stale_discards = 0          # barrierless admission refusals

    # ------------------------------------------------------------------ engine
    def _post(self, t: float, fn: Callable):
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def _apply_slot(self, t: float) -> float:
        """Completion time of a server-side apply arriving at ``t`` under the
        serial dispatch pipeline: an idle applier dispatches immediately; an
        arrival after the last scheduled dispatch STARTED opens the next one;
        an arrival before it started pools into it (the batched-drain credit).
        ``dispatch_cost == 0`` returns ``t`` untouched — commits stay inline
        and event order is unchanged."""
        c = self.cost.dispatch_cost
        if c <= 0.0:
            return t
        if t >= self._applier_free_at:
            self._applier_batch_start = t
            self._applier_free_at = t + c
            self.apply_dispatches += 1
        elif t >= self._applier_batch_start:
            self._applier_batch_start = self._applier_free_at
            self._applier_free_at += c
            self.apply_dispatches += 1
        else:
            self.batched_dispatch_credits += 1
        return self._applier_free_at

    def _post_poll(self, t: float, fn: Callable):
        self.poll_events += 1
        self._post(t, fn)

    def _session(self, vid: str) -> VolunteerSession:
        sess = self.sessions.get(vid)
        if sess is None:
            sess = self.sessions[vid] = VolunteerSession(vid, self.port,
                                                         policy=self.policy)
        return sess

    def _wire_bytes(self) -> float:
        inner = getattr(self.port, "inner", self.port)
        return float(getattr(inner, "bytes_sent", 0)
                     + getattr(inner, "bytes_received", 0))

    def run(self) -> SimResult:
        for s in self.specs.values():
            self._post(s.join_time, lambda vid=s.vid: self._wake(vid))
        while self.ds.latest_version < self.n_updates:
            if not self._heap:
                # a lost notification (FaultyTransport) can strand every
                # volunteer at once: advance the clock to the next visibility
                # deadline so expiry requeues — and their wakes — restart the
                # run. This is the lease-expiry recovery path; without faults
                # it is unreachable (subscriptions keep the heap fed).
                dl = self.qs.next_deadline()
                if dl is None or not math.isfinite(dl):
                    break
                self.events += 1
                self._now = dl
                self.expire_scans += 1
                self.expired += self.qs.expire_all(dl)
                continue
            self.events += 1
            if self.events > self.max_events:
                raise RuntimeError("simulator runaway")
            t, _, fn = heapq.heappop(self._heap)
            self._now = t
            # O(expired), not O(queues x events): sweep only when the earliest
            # live visibility deadline has actually passed — each sweep is then
            # guaranteed to requeue at least one message.
            dl = self.qs.next_deadline()
            if dl is not None and dl <= t:
                self.expire_scans += 1
                self.expired += self.qs.expire_all(t)
            fn()
        return SimResult(self.done_time, self.timeline,
                         dict(self.tasks_by_worker), self.qs.total_requeued,
                         self.ds.latest_version, self.bytes_sent,
                         dict(self.busy), self.events, self.poll_events,
                         self.mode, self.expire_scans, self._wire_bytes(),
                         self.stale_discards, self.policy.spec)

    def _alive(self, vid: str) -> bool:
        s = self.specs[vid]
        return s.join_time <= self._now < s.leave_time

    def _active_count(self, now: float) -> int:
        """|{s : join_time <= now < leave_time}| in O(log N).

        Exactly ``sum(1 for s in specs if s.join_time <= now < s.leave_time)``
        — the count of joins at-or-before ``now`` minus the count of leaves
        at-or-before ``now`` (leaves clamped up to their join so a degenerate
        empty interval contributes 0, matching the linear scan). The old
        per-task linear scan made million-volunteer sweeps O(N x tasks)."""
        cache = self._active_cache
        if cache is None:
            specs = self.specs.values()
            joins = sorted(s.join_time for s in specs)
            leaves = sorted(max(s.leave_time, s.join_time) for s in specs)
            cache = self._active_cache = (joins, leaves)
        joins, leaves = cache
        return bisect_right(joins, now) - bisect_right(leaves, now)

    # wait primitives: poll reschedules, event notifications -------------------
    def _on_notify(self, vid: str, msg) -> None:
        """Wake/VersionReady notification -> simulator event at the current
        virtual time (the wake happens inside whatever event triggered it)."""
        self._post(self._now, lambda: self._continue(vid))

    def _continue(self, vid: str) -> None:
        """Resume a volunteer where its session left off: idle volunteers try
        to lease, task holders retry their blocked dependency."""
        if self._session(vid).task is None:
            self._wake(vid)
        else:
            self._dispatch(vid)

    def _advance(self, sess: VolunteerSession):
        """session.advance plus the measured-bytes tap around it (wire mode)."""
        if self._measuring:
            self.port.take_bytes()
        out = sess.advance(self._now)
        return out, (self.port.take_bytes() if self._measuring else 0.0)

    def _wake(self, vid: str):
        """Volunteer becomes idle at _now: try to lease the next task."""
        if self.ds.latest_version >= self.n_updates:
            return
        sess = self._session(vid)
        if not self._alive(vid):
            # a departed volunteer: requeue whatever it held (wakes the next
            # waiter via the requeue notification); if it consumed a wake while
            # holding nothing, pass that wake on so no event is lost
            sess.abort(kick_if_empty=True)
            return
        now = self._now
        out = sess.lease(now)
        if isinstance(out, NoTask):
            if not sess.queue_drained():
                if self.mode == "poll":
                    self._post_poll(now + self.cost.poll_interval,
                                    lambda: self._wake(vid))
                else:
                    sess.subscribe_idle()
                    if self._watchdog:
                        # idle waits have no lease to expire, so a dropped
                        # Wake needs the same client-side re-check fallback
                        self._post(now + self._watchdog_dt,
                                   lambda: self._continue(vid))
            return
        self._post(now + self.cost.latency, lambda: self._dispatch(vid))

    def _dispatch(self, vid: str):
        sess = self._session(vid)
        if not self._alive(vid):
            sess.abort()
            return
        out, adv_bytes = self._advance(sess)
        if isinstance(out, Busy):            # spurious (duplicate/late) wake
            return
        if isinstance(out, TaskDone):        # obsolete duplicate, acked
            self._post(self._now, lambda: self._wake(vid))
            return
        if isinstance(out, Blocked):
            if self.mode == "poll":
                self._post_poll(self._now + self.cost.poll_interval,
                                lambda: self._dispatch(vid))
            else:
                sess.subscribe(out)
                if self._watchdog:
                    # lost-push fallback: re-drive this volunteer later; a
                    # session that progressed meanwhile absorbs it (Busy /
                    # spurious lease attempt)
                    self._post(self._now + self._watchdog_dt,
                               lambda: self._continue(vid))
            return
        if isinstance(out, MapWork):
            if self.policy.barrier:
                self._run_map(vid, sess, out, adv_bytes)
            else:
                self._run_update(vid, sess, out, adv_bytes)
        elif isinstance(out, LocalWork):
            self._run_update(vid, sess, out, adv_bytes)
        else:
            self._run_reduce(vid, sess, out, adv_bytes)

    # ------------------------------------------------------------------ map
    def _run_map(self, vid: str, sess: VolunteerSession, work: MapWork,
                 adv_bytes: float):
        now = self._now
        t = work.task
        spec = self.specs[vid]
        # working set: a lone volunteer cycles model+opt+the whole 128-batch
        # through cache; k volunteers each hold ~1/k of the batch's tasks.
        active = self._active_count(now)
        share = (self.model_bytes
                 + self.grad_bytes
                 + self._batch_bytes() / max(active, 1))
        thr = self.cost.throughput(spec.speed, share)
        if self._measuring:
            # envelope bytes are real; the payloads are synthetic placeholders
            # (None gradients, string model blobs), so add the logical sizes
            # they stand in for — measured overhead + modeled payload
            fetch_b = adv_bytes + self.model_bytes
            push_b = wire_size(sess.result_message(None, self.grad_bytes,
                                                   0.0)) + self.grad_bytes
        else:
            fetch_b, push_b = self.model_bytes, self.grad_bytes
        fetch = self.cost.xfer(fetch_b)
        compute = self.map_flops / thr
        push = self.cost.xfer(push_b)
        start = now + fetch
        end = start + compute + push

        def finish():
            if not self._alive(vid):
                sess.abort()                # task requeues via its lease
                return
            done = sess.finish_map(None, self.grad_bytes, 0.0)
            # busy counts the attempt either way — a stale map burned the
            # same simulated compute before the admission ack (and matches
            # the barrierless _run_update convention)
            self.busy[vid] = self.busy.get(vid, 0.0) + (end - now)
            if not done.stale:
                self.timeline.append(TimelineEvent(vid, "Compute", now, end,
                                                   t.version))
                self.tasks_by_worker[vid] = self.tasks_by_worker.get(vid, 0) + 1
                self.bytes_sent += self.grad_bytes + self.model_bytes
            self._wake(vid)

        self._post(end, finish)

    def _batch_bytes(self) -> float:
        tp = self.problem.tp
        sample = tp.sample_len * max(self.problem.cfg.vocab, 96) * 4
        return tp.batch_size * sample

    # ------------------------------------------------------------- barrierless
    def _run_update(self, vid: str, sess: VolunteerSession, work, adv_bytes):
        """BoundedStaleness gradient ticket or LocalSteps k-step ticket: pull
        the latest model, compute, push the contribution. The network cost is
        the parameter-server shape of async SGD — gradient (or model-sized
        delta) up, model down; the session's volunteer-applied commit stands
        in for the applier node, so its extra model round-trip is not priced.
        A too-stale attempt still pays the push (the rejection is
        server-side) but commits nothing; its ticket requeues for a fresh
        recompute."""
        now = self._now
        t = work.task
        spec = self.specs[vid]
        local = isinstance(work, LocalWork)
        flops = self.map_flops * (t.k if local else 1)
        active = self._active_count(now)
        share = (self.model_bytes + self.grad_bytes
                 + self._batch_bytes() / max(active, 1))
        thr = self.cost.throughput(spec.speed, share)
        fetch_b = (adv_bytes if self._measuring else 0.0) + self.model_bytes
        push_b = self.model_bytes if local else self.grad_bytes
        end = (now + self.cost.xfer(fetch_b) + flops / thr
               + self.cost.xfer(push_b))
        kind = "Local" if local else "Compute"

        def finish():
            if not self._alive(vid):
                sess.abort()                # ticket requeues via its lease
                return
            result = (sess.delta_result(None, self.model_bytes, 0.0) if local
                      else sess.grad_result(None, self.grad_bytes, 0.0))
            if self.server_apply:
                # dispatch_cost > 0 queues this commit behind the applier's
                # serial dispatch pipeline (pooling concurrent arrivals into
                # one batched dispatch); the 0.0 default keeps the commit
                # inline on this event and every existing run bit-identical
                commit_at = self._apply_slot(end)
                if commit_at > end:
                    self._post(commit_at, lambda: commit(result, commit_at))
                    return
            commit(result, end)

        def commit(result, end):
            if not self._alive(vid):
                sess.abort()                # ticket requeues via its lease
                return
            if self.server_apply:
                # one SubmitUpdate round-trip: the server runs admission,
                # applies, publishes, acks — commit semantics identical to
                # the client-applied pair, wire traffic is not (that delta
                # is what benchmarks/staleness.py measures)
                done = sess.submit_update(result)
                # timeline stamps the admission-time version (what the
                # client-applied path records via ApplyWork.version), so a
                # server-applied run's SimResult matches the client-applied
                # one field-for-field — only measured wire bytes differ
                stale, version = done.stale, done.version - 1
            else:
                out = sess.finish_update(result)
                stale = isinstance(out, TaskDone)
                version = -1 if stale else out.version
            self.busy[vid] = self.busy.get(vid, 0.0) + (end - now)
            if stale:                       # refused, discarded
                self.stale_discards += 1
                # the wasted attempt still moved model-down + payload-up
                self.bytes_sent += self.model_bytes + push_b
                self.timeline.append(TimelineEvent(
                    vid, kind + "-stale", now, end, work.base_version))
                # re-wake through the heap: the nack above already woke an
                # idle volunteer (posted first), so a FASTER waiter gets the
                # requeued ticket before this one can re-lease it
                self._post(self._now, lambda: self._wake(vid))
                return
            if not self.server_apply:
                sess.commit_update("blob", self.model_bytes)
            self.timeline.append(TimelineEvent(vid, kind, now, end, version))
            self.tasks_by_worker[vid] = self.tasks_by_worker.get(vid, 0) + 1
            self.bytes_sent += self.model_bytes + push_b
            self.done_time = max(self.done_time, end)
            self._wake(vid)

        self._post(end, finish)

    # ------------------------------------------------------------------ reduce
    def _run_reduce(self, vid: str, sess: VolunteerSession, work: ReduceWork,
                    adv_bytes: float):
        now = self._now
        t = work.task
        spec = self.specs[vid]
        if self._measuring:
            # envelope bytes measured; logical payloads padded in: the leased
            # gradients, the model pull the real Coordinator performs here,
            # and the published model blob
            pull = self.cost.xfer(adv_bytes + self.grad_bytes * t.n_mb
                                  + self.model_bytes)
            push = self.cost.xfer(
                wire_size(sess.model_message("blob", self.model_bytes))
                + self.model_bytes)
        else:
            pull = self.cost.xfer(self.grad_bytes * t.n_mb) + self.cost.xfer(
                self.model_bytes)
            push = self.cost.xfer(self.model_bytes)
        compute = self.reduce_flops / (self.cost.flops_per_sec * spec.speed)
        end = now + pull + compute + push

        def finish():
            if not self._alive(vid):
                sess.abort()                # drop leases + nack drained results
                return
            sess.finish_reduce("blob", self.model_bytes)
            self.timeline.append(TimelineEvent(vid, "Accumulate", now, end,
                                               t.version))
            self.tasks_by_worker[vid] = self.tasks_by_worker.get(vid, 0) + 1
            self.busy[vid] = self.busy.get(vid, 0.0) + (end - now)
            self.bytes_sent += self.grad_bytes * t.n_mb + 2 * self.model_bytes
            self.done_time = max(self.done_time, end)
            self._wake(vid)

        self._post(end, finish)
