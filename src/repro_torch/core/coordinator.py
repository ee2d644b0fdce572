"""Coordinator — REAL execution of the JSDoop protocol, in process.

K volunteers are interleaved round-robin, actually computing gradients and
RMSprop updates with PyTorch (on the card, through the port's kernels).
Each volunteer is a ``protocol.VolunteerSession`` —
the sans-IO state machine owning every protocol rule (lease, model-version
wait, reduce barrier, duplicate ack, requeue) — speaking typed messages to the
QueueServer/DataServer through a ``transport`` ("inproc" for direct
zero-copy calls, "wire" to round-trip every message through canonical bytes;
either way the final model is identical). The Coordinator itself owns only
engine policy: the logical clock (scheduler iteration count, used for
visibility timeouts), real compute + gradient compression, and churn.

Churn is injected as (step, kind, arg) events: 'leave'/'join' of a volunteer
(a leaving volunteer Byes — its leased tasks requeue, exactly like closing the
browser tab mid-task), and — when running on a ShardedQueueServer —
'add_shard'/'remove_shard' membership changes, which rebalance the federation
live (queues migrate with their full state; see queue.ShardedQueueServer).

Waiting is event-driven: a session that reports ``Blocked`` subscribes (a
``Wake``/``VersionReady`` notification message un-blocks it) and is skipped by
the scheduler until woken. When every volunteer is blocked the logical clock
fast-forwards to the next churn event or visibility deadline instead of
spinning — no step ever busy-polls.

This is the engine behind the paper's invariance claim tests: the final model
must bit-match ``sequential_accumulated`` for ANY worker count, ANY churn, and
ANY transport — and, per aggregation policy (``policy=``), each barrierless
policy's sequential reference (``sequential_async`` / ``sequential_local``):
the round-robin scheduler serializes barrierless tickets, so worker count
cannot change the float stream.

Port of ``repro/core/coordinator.py``. Under ``codec=make_codec("ternary")``
on the card, every gradient leaf's encode and decode runs in the port's
ternary kernels. The result's model is on the problem's device whatever the
transport (over the wire the DataServer holds host copies).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch import tree
from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.initiator import enqueue_problem
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.core.protocol import (Blocked, KickQueue, LocalWork, MapWork,
                                 NoTask, ReduceWork, ServerEndpoint, TaskDone,
                                 VolunteerSession)
from repro_torch.core.queue import QueueServer, ShardedQueueServer, VirtualClock
from repro_torch.core.tasks import INITIAL_QUEUE
from repro_torch.core.transport import make_transport
from repro_torch.optim.compression import Codec, ef_compress, ef_init


@dataclass
class _Volunteer:
    vid: str
    sess: VolunteerSession
    ef_residual: Any = None     # error-feedback state (when codec is set)
    blocked: bool = False       # waiting on a Wake/VersionReady notification


@dataclass
class RunResult:
    params: Any
    opt_state: Any
    losses: List[float]                   # mean map loss per version
    steps: int
    tasks_by_worker: Dict[str, int]
    requeues: int
    final_version: int
    stale_discards: int = 0               # barrierless results refused as stale
    policy: str = "sync"
    bytes_sent: int = 0                   # gradient (codec) + model bytes
    # bytes the transport moved both ways (None: it measures none). The codec
    # round-trips on the volunteer, so a gradient crosses the wire decoded:
    # dense fp32 under every codec, unlike ``bytes_sent``'s codec count
    wire_bytes: Optional[int] = None


class Coordinator:
    def __init__(self, problem: TrainingProblem, n_workers: int, *,
                 n_versions: Optional[int] = None,
                 churn: Optional[List[Tuple[int, str, str]]] = None,
                 visibility_timeout: float = float("inf"),
                 codec: Optional[Codec] = None, n_shards: int = 1,
                 transport: Union[str, Callable, None] = "inproc",
                 policy: PolicyLike = None,
                 placement: Optional[Callable[[str], str]] = None):
        self.problem = problem
        self.codec = codec
        self.policy = make_policy(policy)
        self.qs: Union[QueueServer, ShardedQueueServer] = (
            QueueServer(default_timeout=visibility_timeout) if n_shards <= 1
            else ShardedQueueServer(n_shards,
                                    default_timeout=visibility_timeout,
                                    placement=placement))
        self.ds = DataServer()
        # lease-time authority: the endpoint stamps leases with the engine's
        # logical clock (mirrors the scheduler's step counter — identical to
        # the client-supplied now, so runs stay bit-identical)
        self._step = 0
        self.endpoint = ServerEndpoint(self.qs, self.ds,
                                       clock=VirtualClock(lambda: self._step))
        self.port = make_transport(transport, self.endpoint)
        self.port.set_deliver(self._on_notify)
        self.n_versions = n_versions if n_versions is not None else problem.n_versions
        # the run's commit target: the policy maps BSP rounds to versions
        # (sync: 1 per round; async: 1 per gradient; local: 1 per k steps)
        self.n_updates = self.policy.n_updates(problem, self.n_versions)
        enqueue_problem(problem, self.qs, self.ds, n_versions=self.n_versions,
                        policy=self.policy)
        self.volunteers: Dict[str, _Volunteer] = {
            f"w{i}": self._make_volunteer(f"w{i}") for i in range(n_workers)}
        self.churn = sorted(churn or [])
        self.version_losses: Dict[int, List[float]] = {}
        self.tasks_done: Dict[str, int] = {}
        self.bytes_sent = 0
        self.stale_discards = 0

    def _make_volunteer(self, vid: str) -> _Volunteer:
        return _Volunteer(vid, VolunteerSession(
            vid, self.port, model_nbytes=self.problem.model_bytes,
            policy=self.policy))

    # ------------------------------------------------------------------ engine
    def _on_notify(self, vid: str, msg) -> None:
        """Notification sink: mark the volunteer runnable. A wake for a
        departed volunteer is passed on so no wakeup is lost."""
        v = self.volunteers.get(vid)
        if v is not None:
            v.blocked = False
        else:
            self.port.call(KickQueue(INITIAL_QUEUE))

    def run(self, max_steps: int = 2_000_000) -> RunResult:
        step = 0
        churn_i = 0
        while self.ds.latest_version < self.n_updates:
            self._step = step              # keep the lease clock in sync
            if step >= max_steps:
                raise RuntimeError("coordinator did not converge (deadlock?)")
            # churn events
            while churn_i < len(self.churn) and self.churn[churn_i][0] <= step:
                _, kind, vid = self.churn[churn_i]
                churn_i += 1
                if kind == "leave" and vid in self.volunteers:
                    self.volunteers[vid].sess.bye()
                    del self.volunteers[vid]
                elif kind == "join" and vid not in self.volunteers:
                    self.volunteers[vid] = self._make_volunteer(vid)
                elif kind == "add_shard" and \
                        isinstance(self.qs, ShardedQueueServer):
                    self.qs.add_shard()
                elif kind == "remove_shard" and \
                        isinstance(self.qs, ShardedQueueServer) and \
                        len(self.qs.shards) > 1:
                    self.qs.remove_shard(int(vid) % len(self.qs.shards))
            if not self.volunteers:
                # everyone left; semantically the problem just pauses (paper:
                # "If no one is collaborating, the problem simply stops").
                if churn_i >= len(self.churn):
                    raise RuntimeError("no volunteers and no future joins")
                step = max(step + 1, self.churn[churn_i][0])
                continue
            # O(expired): expire_all self-gates on the server's lazy deadline
            # index and returns immediately while nothing is due
            self.qs.expire_all(step)
            ran_any = False
            for vid in list(self.volunteers):
                v = self.volunteers.get(vid)
                if v is not None and not v.blocked:
                    self._step_volunteer(v, step)
                    ran_any = True
            if ran_any:
                step += 1
                continue
            # every volunteer is waiting on a wake: jump the logical clock to
            # the next external event (churn or a visibility-timeout expiry)
            # instead of spinning through empty steps
            candidates = []
            if churn_i < len(self.churn):
                candidates.append(self.churn[churn_i][0])
            dl = self.qs.next_deadline()
            if dl is not None and math.isfinite(dl):
                candidates.append(int(math.ceil(dl)))
            if not candidates:
                raise RuntimeError(
                    "coordinator deadlock: all volunteers blocked with no "
                    "pending churn or visibility deadline")
            step = max(step + 1, min(candidates))
        params, opt_state = tree.to_device(
            self.ds.get_model(self.ds.latest_version), self.problem.device)
        losses = [float(np.mean(self.version_losses[k]))
                  for k in sorted(self.version_losses)]
        return RunResult(params, opt_state, losses, step, dict(self.tasks_done),
                         self.qs.total_requeued, self.ds.latest_version,
                         self.stale_discards, self.policy.spec,
                         self.bytes_sent,
                         int(self.port.take_bytes())
                         if self.port.measures_bytes else None)

    # ------------------------------------------------------------------ compute
    def _step_volunteer(self, v: _Volunteer, now: float):
        """One scheduler slice: drive the session one protocol move; answer
        MapWork/ReduceWork with real PyTorch compute."""
        sess = v.sess
        if sess.task is None:
            if isinstance(sess.lease(now), NoTask):
                v.blocked = True
                sess.subscribe_idle()      # sleep until a publish or requeue
                return
        out = sess.advance(now)
        if isinstance(out, Blocked):
            v.blocked = True
            sess.subscribe(out)
            return
        if isinstance(out, TaskDone):      # obsolete duplicate, acked
            return
        if isinstance(out, MapWork):
            if self.policy.barrier:
                self._do_map(v, out)
            else:
                self._do_async(v, out)
        elif isinstance(out, ReduceWork):
            self._do_reduce(v, out)
        elif isinstance(out, LocalWork):
            self._do_local(v, out)
        else:
            # Busy is unreachable here (compute is synchronous, so nothing
            # can redeliver a wake mid-task) — keep the invariant loud
            raise RuntimeError(f"{v.vid}: unexpected session outcome {out!r}")

    def _compute_grads(self, v: _Volunteer, params, version: int,
                       mb_index: int):
        """One mini-batch gradient (+ optional codec round-trip with error
        feedback). Returns (grads, loss, wire nbytes)."""
        grads, loss = self.problem.map_compute(params, version, mb_index)
        nbytes = self.problem.grad_bytes
        if self.codec is not None:
            if v.ef_residual is None:
                v.ef_residual = ef_init(self.problem.params0)
            grads, v.ef_residual, nbytes = ef_compress(self.codec, grads,
                                                       v.ef_residual)
        return grads, loss, nbytes

    def _do_map(self, v: _Volunteer, work: MapWork):
        t = work.task
        params = work.model[0]             # blob = (params, opt_state)
        grads, loss, nbytes = self._compute_grads(v, params, t.version,
                                                  t.mb_index)
        self.bytes_sent += nbytes
        done = v.sess.finish_map(grads, nbytes, loss)
        if not done.stale:
            self.tasks_done[v.vid] = self.tasks_done.get(v.vid, 0) + 1
            self.version_losses.setdefault(t.version, []).append(loss)

    def _do_async(self, v: _Volunteer, work: MapWork):
        """BoundedStaleness: gradient at the fetched (latest) version, then
        the admission edge; an admitted gradient applies to the CURRENT model
        and commits the next version, all in this scheduler slice."""
        t = work.task
        params = work.model[0]
        grads, loss, nbytes = self._compute_grads(v, params, t.version,
                                                  t.mb_index)
        self.bytes_sent += nbytes
        out = v.sess.finish_update(v.sess.grad_result(grads, nbytes, loss))
        if isinstance(out, TaskDone):      # too stale: discarded + requeued
            self.stale_discards += 1
            return
        params, opt_state = out.model
        params, opt_state = self.problem.apply_one(params, opt_state, grads)
        v.sess.commit_update((params, opt_state), self.problem.model_bytes,
                             gc_keep=2)
        self.bytes_sent += self.problem.model_bytes
        self.tasks_done[v.vid] = self.tasks_done.get(v.vid, 0) + 1
        self.version_losses.setdefault(out.version, []).append(loss)

    def _do_local(self, v: _Volunteer, work: LocalWork):
        """LocalSteps: k local optimizer steps from the fetched model; the
        weighted delta applies to the CURRENT model via commit_update.
        (The stale branch mirrors _do_async for accounting consistency; it
        is unreachable under this engine's serialized round-robin scheduler,
        where admission always sees a fresh model.)"""
        t = work.task
        p0, s0 = work.model
        delta, loss = self.problem.local_compute(p0, s0, t.start, t.k)
        self.bytes_sent += self.problem.model_bytes      # delta pushed up
        out = v.sess.finish_update(
            v.sess.delta_result(delta, self.problem.model_bytes, loss))
        if isinstance(out, TaskDone):
            self.stale_discards += 1
            return
        params, opt_state = out.model
        params, opt_state = self.problem.apply_delta(
            params, opt_state, delta, self.policy.weight)
        v.sess.commit_update((params, opt_state), self.problem.model_bytes,
                             gc_keep=2)
        self.bytes_sent += self.problem.model_bytes      # model pulled down
        self.tasks_done[v.vid] = self.tasks_done.get(v.vid, 0) + 1
        self.version_losses.setdefault(out.version, []).append(loss)

    def _do_reduce(self, v: _Volunteer, work: ReduceWork):
        params, opt_state = v.sess.fetch_model(self.problem.model_bytes)
        params, opt_state = self.problem.reduce_compute(params, opt_state,
                                                        work.results)
        v.sess.finish_reduce((params, opt_state), self.problem.model_bytes,
                             gc_keep=2)
        self.tasks_done[v.vid] = self.tasks_done.get(v.vid, 0) + 1
        self.bytes_sent += self.problem.model_bytes
