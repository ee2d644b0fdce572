"""The part of ``repro.distributed.sharding`` that the one-card training
step reads: ``ShardingPolicy``'s axis view.

On one card every axis has size 1, so the batch is not split across
devices and no parameter is sharded. The rest of the JAX module (the
per-leaf ``PartitionSpec`` rules, FSDP and tensor-parallel fallbacks,
``seq_parallel``, the cache specs) comes with the port's mesh (ROADMAP
Queue 1 item 9). So does ``grad_accum_dtype``: the one-card step always
accumulates in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Axis-name view of the devices."""
    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (1, 1)

    def size(self, name) -> int:
        if isinstance(name, (tuple, list)):
            return math.prod(self.size(n) for n in name)
        if name is None:
            return 1
        return self.axis_sizes[self.axis_names.index(name)]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Data-parallel axes for the batch dim (pod included when present)."""
        return tuple(a for a in self.axis_names if a in ("pod", "data"))
