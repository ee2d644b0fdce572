"""Runtime (non-architectural) execution options, as
``repro.models.runtime``.

``ArchConfig`` describes the *published* architecture; ``Runtime`` describes
how the port executes it. The port keeps the fields a path of the port
reads: ``remat`` (``launch/train.py --no-remat`` turns it off), and the moe
family's ``moe_impl`` (``"sort"``, the capacity-bounded dispatch at
``cfg.moe.capacity_factor``, or ``"dense"``, the all-experts oracle the
tests hold the sort path to).
Left out until a path of the port reads them: ``capacity_factor`` and
``cf`` (no entry point overrides the config's factor), ``attn_impl`` and the
``BASELINE`` instance (the port always attends through the flash kernel
where there is no cache; ``plain_kernels()`` in ``chip_smoke.py`` swaps in
the plain versions for a comparison), ``kv_chunk`` (the flash backward's kv
chunk is ``kernels.ops.KV_CHUNK``), the expert-parallel knobs
(``moe_expert_axis``, ``moe_token_axes``; ROADMAP Queue 1 item 9),
``ssm_chunk`` (item 7), the sharding hints (``seq_parallel``, ``act_spec``,
``act_inner_spec``; item 9), ``decode_window_only`` (decode always masks
with ``cfg.sliding_window``), ``scan_layers`` (the port always loops over
stacked layers) and ``use_pallas`` / ``pallas_interpret`` (the port's
kernels are chosen by the tensors' device, ``kernels/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Runtime:
    remat: bool = True         # recompute each layer's forward in backward
    moe_impl: str = "sort"     # "sort" (capacity dispatch) | "dense" (oracle)


DEFAULT = Runtime()
