"""Initiator — sets up the problem and enqueues the task graph (paper §IV.B,
§IV.F steps 0-1). The aggregation policy owns the work-unit schedule: SyncBSP
enqueues n_mb map tasks + 1 reduce task per batch (the paper's graph),
BoundedStaleness one gradient ticket per stream slot (no barriers), LocalSteps
one k-step ticket per averaging round. FIFO into the InitialQueue; the model's
version-0 blob into the DataServer."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.aggregation import PolicyLike, make_policy
from repro_torch.core.dataserver import DataServer
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.core.queue import QueueServer
from repro_torch.core.tasks import INITIAL_QUEUE


def enqueue_problem(problem: TrainingProblem, qs: QueueServer, ds: DataServer,
                    *, n_versions: Optional[int] = None,
                    policy: PolicyLike = None,
                    store_real_model: bool = True) -> int:
    """Returns the number of tasks enqueued."""
    pol = make_policy(policy)
    n = n_versions if n_versions is not None else problem.n_versions
    count = 0
    qs.declare(INITIAL_QUEUE)
    for task in pol.schedule(problem, n):
        qs.publish(INITIAL_QUEUE, task)
        count += 1
    blob = ((problem.params0, problem.opt_state0) if store_real_model else "v0")
    ds.publish_model(0, blob, nbytes=problem.model_bytes)
    return count
