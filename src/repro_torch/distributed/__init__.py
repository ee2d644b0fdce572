"""The paper's queue-scheduled map/reduce schedule as SPMD steps over a
mesh.

``sharding``   per-tensor spec policy (divisibility-checked fallbacks)
``spmd``       the sharded leaves, their gathers and gradient sums, and
               the collectives' counts over a torch ``DeviceMesh``
``steps``      train_step (map = microbatch grad; reduce = the summed
               gradients + optimizer apply), prefill_step, decode_step
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingPolicy, batch_specs, cache_specs, param_specs, opt_state_specs,
)
from repro_torch.distributed.steps import (  # noqa: F401
    make_train_step, make_prefill_step, make_decode_step,
)
