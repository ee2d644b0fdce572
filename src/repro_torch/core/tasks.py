"""Task and message types of the JSDoop map-reduce training protocol (§IV.G).

One *batch* (size 128) = ``n_mb`` map tasks (mini-batch 8 gradients against
model version v) + 1 reduce task (accumulate all n_mb gradients, RMSprop-apply,
publish model v+1). The model version required by a batch's tasks equals the
global batch index: version = epoch * batches_per_epoch + batch.

That is the ``SyncBSP`` work-unit vocabulary; the other aggregation policies
(``repro_torch.core.aggregation``) reuse ``MapTask`` as an async gradient ticket
(its ``version`` then names the data-schedule slot, not a required model
version) and add ``LocalTask``/``DeltaResult`` for local-steps model
averaging. Results are version-stamped: ``computed_at`` records the model
version a payload was actually computed against, which is what the policy's
admission rule judges.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

INITIAL_QUEUE = "initial"

RESULTS_PREFIX = "map-results:"


def results_queue(version: int) -> str:
    """Per-batch results queue (the paper's MapResultsQueue, sharded per batch —
    'it is possible to use several QueueServers in which each one stores a
    different type of task')."""
    return f"{RESULTS_PREFIX}v{version}"


@dataclass(frozen=True)
class MapTask:
    version: int              # model version the gradient must be computed on
                              # (async policies: the data-schedule slot only)
    epoch: int
    batch: int
    mb_index: int             # which mini-batch slice of the 128-batch
    mb_size: int

    kind: str = "map"


@dataclass(frozen=True)
class ReduceTask:
    version: int              # consumes results for `version`, publishes version+1
    epoch: int
    batch: int
    n_mb: int

    kind: str = "reduce"


@dataclass(frozen=True)
class LocalTask:
    """LocalSteps ticket: run ``k`` local optimizer steps starting at global
    mini-batch stream offset ``start`` and contribute the model delta."""
    slot: int                 # schedule slot (commit order is arrival order)
    start: int                # first index into the global mini-batch stream
    k: int                    # local optimizer steps per contribution
    mb_size: int

    kind: str = "local"


@dataclass(frozen=True)
class GradResult:
    version: int
    mb_index: int
    payload: Any              # grads pytree (or encoded payload) | None in sim
    nbytes: int = 0
    loss: float = 0.0
    worker: str = ""
    computed_at: int = -1     # model version the gradient was computed at
                              # (== version under SyncBSP; the admission
                              # observable under BoundedStaleness)


@dataclass(frozen=True)
class DeltaResult:
    """A LocalSteps volunteer's k-step model delta (its FedAvg/MLitB-style
    contribution), stamped with the base version it trained from."""
    slot: int
    computed_at: int          # base model version the local run started from
    payload: Any              # (delta_params, delta_opt_state) | None in sim
    nbytes: int = 0
    loss: float = 0.0
    worker: str = ""
    n_steps: int = 0
    weight: float = 1.0


# task/result bodies that may ride inside protocol messages — registered with
# the wire codec in repro_torch.core.protocol so they round-trip bytes by name
WIRE_TYPES = (MapTask, ReduceTask, LocalTask, GradResult, DeltaResult)
