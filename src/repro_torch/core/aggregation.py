"""Pluggable aggregation semantics — the consistency model as a config axis.

The paper trains with exactly one consistency model: bulk-synchronous
map/reduce (one barrier per model version, §IV.G Fig. 3). Related
browser-training systems show the rest of the design space — MLitB trains via
periodic model averaging over heterogeneous volunteers, DistML.js evaluates
both synchronous and communication-reduced schemes, Hogwild/SSP-style systems
admit bounded-stale gradients — and which one wins depends on the volunteer
population. This module extracts that decision into one object, the
``AggregationPolicy``, consumed by every layer that used to hard-code it:

- **Initiator** (``enqueue_problem``): the policy emits the work-unit
  schedule — what tasks exist for a run of ``n_versions`` BSP-equivalent
  rounds. All three policies schedule the *same* global mini-batch stream
  (``n_versions x n_mb`` gradient computations), so cross-policy benchmarks
  compare equal work.
- **VolunteerSession** (``repro_torch.core.protocol``): the policy decides the
  per-task protocol shape (barrier reduce vs barrierless fetch-latest ->
  compute -> admit/commit) and the admission rule for an arriving
  version-stamped result (``admit(computed_at, latest)``).
- **Engines** (the Coordinator in this port): the policy sets the
  run's commit target (``n_updates``) and which compute the engine must
  supply (one gradient, a reduce, or ``k`` local optimizer steps).

Three concrete policies:

- ``SyncBSP`` — the paper baseline. Schedule, admission and apply are
  bit-identical to the pre-policy code: ``n_mb`` map tasks + 1 reduce barrier
  per version; a result is admitted only while the model is still at its
  version; the reduce applies the mean gradient. Any Coordinator run
  bit-matches ``sequential_accumulated``.
- ``BoundedStaleness(s)`` — async SGD with a staleness bound (SSP-style): no
  reduce barrier; a volunteer fetches the *latest* model (version ``v``),
  computes one gradient, and the gradient is admitted while
  ``current - v <= s`` — applied immediately to the current model,
  publishing version ``current + 1``. Stale gradients are discarded and
  their ticket nacked for a fresh-version recompute.
- ``LocalSteps(k, weight)`` — MLitB/FedAvg-style communication reduction: a
  volunteer fetches the latest model, runs ``k`` local optimizer steps, and
  publishes the weighted model delta through the existing ``PublishModel``
  path (applied to the then-current model). An optional staleness bound
  gates admission like the async policy.

Every policy is deterministic given the engine's event order, so the chaos
metamorphic contract (sharded SimResult == single-server SimResult for any
seeded fault schedule) holds per policy, not just for the paper baseline.

``python -m repro_torch.core.aggregation --smoke`` is the CI matrix: all
three policies on the reduced real problem, in process, each checked against
its sequential reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Union

from repro_torch.core.tasks import LocalTask, MapTask, ReduceTask


class AggregationPolicy:
    """Base: schedule of work units, result admission, commit target.

    ``barrier`` is the session-level switch: barrier policies run the paper's
    map/reduce conversation; barrierless policies run fetch-latest ->
    compute -> admit/commit.
    """

    name: str = "base"
    barrier: bool = True

    # -- schedule ------------------------------------------------------------
    def n_updates(self, problem, n_versions: int) -> int:
        """Model versions a run of ``n_versions`` BSP rounds must commit."""
        raise NotImplementedError

    def schedule(self, problem, n_versions: int) -> Iterator:
        """The work units to enqueue, in FIFO order."""
        raise NotImplementedError

    # -- admission -----------------------------------------------------------
    def admit(self, computed_at: int, latest: int) -> bool:
        """May a result computed at model version ``computed_at`` still be
        applied while the current version is ``latest``?"""
        return True

    # -- description ---------------------------------------------------------
    @property
    def spec(self) -> str:
        return self.name

    def describe(self) -> dict:
        return {"policy": self.name, "spec": self.spec,
                "barrier": self.barrier}


@dataclass(frozen=True)
class SyncBSP(AggregationPolicy):
    """The paper's bulk-synchronous baseline (must bit-match
    ``sequential_accumulated`` — the schedule below IS the legacy enqueue
    order)."""

    name = "sync-bsp"
    barrier = True

    def n_updates(self, problem, n_versions: int) -> int:
        return n_versions

    def schedule(self, problem, n_versions: int):
        tp = problem.tp
        for v in range(n_versions):
            e, b = problem.version_to_epoch_batch(v)
            for mb in range(tp.mini_batches_to_accumulate):
                yield MapTask(v, e, b, mb, tp.mini_batch_size)
            yield ReduceTask(v, e, b, tp.mini_batches_to_accumulate)

    def admit(self, computed_at: int, latest: int) -> bool:
        # synchronous: a result is only usable while the model has not moved
        return latest <= computed_at

    @property
    def spec(self) -> str:
        return "sync"

    def describe(self) -> dict:
        return {**super().describe(), "staleness": 0,
                "guarantee": "bit-equal to sequential batch SGD"}


@dataclass(frozen=True)
class BoundedStaleness(AggregationPolicy):
    """Async SGD with an SSP-style staleness bound: one ticket per gradient,
    no reduce barrier, gradients older than ``staleness`` versions are
    discarded (their ticket requeues for a fresh recompute)."""

    staleness: int = 2

    name = "bounded-staleness"
    barrier = False

    def n_updates(self, problem, n_versions: int) -> int:
        return n_versions * problem.tp.mini_batches_to_accumulate

    def schedule(self, problem, n_versions: int):
        # the same global mini-batch stream as SyncBSP, minus the barriers:
        # ticket i covers stream slot i = (version i//n_mb, mini-batch i%n_mb)
        tp = problem.tp
        for v in range(n_versions):
            e, b = problem.version_to_epoch_batch(v)
            for mb in range(tp.mini_batches_to_accumulate):
                yield MapTask(v, e, b, mb, tp.mini_batch_size)

    def admit(self, computed_at: int, latest: int) -> bool:
        return (latest - computed_at) <= self.staleness

    @property
    def spec(self) -> str:
        return f"staleness:{self.staleness}"

    def describe(self) -> dict:
        return {**super().describe(), "staleness": self.staleness,
                "guarantee": f"async SGD, gradients at most "
                             f"{self.staleness} versions stale"}


@dataclass(frozen=True)
class LocalSteps(AggregationPolicy):
    """MLitB/FedAvg-style model averaging: one ticket = ``k`` local optimizer
    steps; the volunteer publishes its weighted model delta via PublishModel.
    ``staleness=None`` admits any delta (pure periodic averaging); an integer
    bound gates admission like the async policy."""

    k: int = 4
    weight: float = 1.0
    staleness: Optional[int] = None

    name = "local-steps"
    barrier = False

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("LocalSteps needs k >= 1")

    def n_updates(self, problem, n_versions: int) -> int:
        total = n_versions * problem.tp.mini_batches_to_accumulate
        return -(-total // self.k)            # ceil: same total gradient work

    def schedule(self, problem, n_versions: int):
        tp = problem.tp
        for slot in range(self.n_updates(problem, n_versions)):
            yield LocalTask(slot, slot * self.k, self.k, tp.mini_batch_size)

    def admit(self, computed_at: int, latest: int) -> bool:
        if self.staleness is None:
            return True
        return (latest - computed_at) <= self.staleness

    @property
    def spec(self) -> str:
        w = "" if self.weight == 1.0 else f":{self.weight}"
        return f"local:{self.k}{w}"

    def describe(self) -> dict:
        return {**super().describe(),
                "staleness": ("unbounded" if self.staleness is None
                              else self.staleness),
                "guarantee": f"periodic model averaging, k={self.k} local "
                             f"steps, server weight {self.weight}"}


PolicyLike = Union[None, str, AggregationPolicy]


def make_policy(spec: PolicyLike) -> AggregationPolicy:
    """Resolve an engine's ``policy=`` argument: None -> the paper baseline;
    an ``AggregationPolicy`` instance passes through; strings parse as
    "sync" | "staleness:<s>" | "local:<k>[:<weight>]"."""
    if spec is None:
        return SyncBSP()
    if isinstance(spec, AggregationPolicy):
        return spec
    if isinstance(spec, str):
        parts = spec.strip().lower().split(":")
        head = parts[0]
        if head in ("sync", "bsp", "sync-bsp") and len(parts) == 1:
            return SyncBSP()
        if head in ("staleness", "async", "bounded-staleness"):
            if len(parts) == 1:
                return BoundedStaleness()
            if len(parts) == 2:
                return BoundedStaleness(staleness=int(parts[1]))
        if head in ("local", "local-steps") and 1 <= len(parts) <= 3:
            k = int(parts[1]) if len(parts) >= 2 else 4
            w = float(parts[2]) if len(parts) == 3 else 1.0
            return LocalSteps(k=k, weight=w)
    raise ValueError(f"unknown aggregation policy {spec!r} (want 'sync', "
                     f"'staleness:<s>', 'local:<k>[:<weight>]', or an "
                     f"AggregationPolicy instance)")


# ---------------------------------------------------------------------------
# CI smoke: 3 policies x 2 transports on the reduced real problem
# ---------------------------------------------------------------------------

def _bitmatch(a, b) -> bool:
    import torch

    from repro_torch import tree
    return all(bool(torch.equal(x, y))
               for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True))


def main(n_workers: int = 3, device=None) -> None:
    """CI smoke: for each policy and each transport, a real Coordinator run
    on the reduced problem must (a) commit every scheduled update, (b)
    bit-match the policy's sequential reference, and (c) be
    transport-invariant. SyncBSP's reference is ``sequential_accumulated`` —
    the paper's Table-4 equality, one row of a matrix."""
    from repro_torch.configs.paper_lstm import TrainParams
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.mapreduce import (TrainingProblem,
                                            sequential_accumulated,
                                            sequential_async,
                                            sequential_local)
    from repro_torch.data.text import synthetic_corpus

    tp = TrainParams(batch_size=16, examples_per_epoch=64, num_epochs=1,
                     sample_len=20, mini_batch_size=4,
                     mini_batches_to_accumulate=4)
    problem = TrainingProblem.paper_problem(corpus=synthetic_corpus(6000),
                                            tp=tp, device=device)
    refs = {
        "sync": sequential_accumulated(problem)[0],
        "staleness:2": sequential_async(problem)[0],
        "local:4": sequential_local(problem, k=4)[0],
    }
    print("policy,transport,final_version,n_updates,tasks,stale_discards,"
          "bitmatch")
    for spec in ("sync", "staleness:2", "local:4"):
        policy = make_policy(spec)
        expected = policy.n_updates(problem, problem.n_versions)
        for transport in ("inproc", "wire"):
            res = Coordinator(problem, n_workers=n_workers, policy=policy,
                              transport=transport).run()
            ok = _bitmatch(res.params, refs[spec])
            print(f"aggregation_smoke,{spec},{transport},{res.final_version},"
                  f"{expected},{sum(res.tasks_by_worker.values())},"
                  f"{res.stale_discards},{ok}")
            if res.final_version != expected:
                raise SystemExit(f"{spec}/{transport}: final version "
                                 f"{res.final_version}, expected {expected}")
            if not ok:
                raise SystemExit(f"{spec}/{transport} diverged from the "
                                 f"sequential reference")
    print(f"# OK: 3-policy x 2-transport matrix green: every policy commits "
          f"its full schedule and bit-matches its sequential reference with "
          f"{n_workers} volunteers on {problem.device}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run the 3-policy x 2-transport matrix")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    if not args.smoke:
        ap.error("nothing to do: pass --smoke to run the policy matrix")
    # run through the canonical module instance, not the __main__ copy, so
    # the policy classes here are the ones the engines isinstance-check
    from repro_torch.core import aggregation as _canonical
    _canonical.main(n_workers=args.workers, device=args.device)
