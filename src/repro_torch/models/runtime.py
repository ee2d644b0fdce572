"""Runtime (non-architectural) execution options, as
``repro.models.runtime``.

``ArchConfig`` describes the *published* architecture; ``Runtime`` describes
how the port executes it. The port keeps the fields a path of the port
reads: ``remat`` (``launch/train.py --no-remat`` turns it off), the moe
family's ``moe_impl`` (``"sort"``, the capacity-bounded dispatch at
``cfg.moe.capacity_factor``, or ``"dense"``, the all-experts oracle the
tests hold the sort path to), and ``spmd``: the ``distributed/spmd.py``
layout a step bound to a ``DeviceMesh`` runs the model through (its
sharded leaves gathered at use, each module split over ``model`` where
its spec allows, a moe layer's tokens gathered over the batch axes, and
under a training policy's ``seq_parallel`` the residual stream kept as
the rank's sequence shard: the layout carries what the reference's
``act_spec`` and ``act_inner_spec`` constrain), None on one device's host
mesh.
Left out until a path of the port reads them: ``capacity_factor`` and
``cf`` (no entry point overrides the config's factor), ``ssm_chunk`` and
``sschunk`` (no entry point overrides the scan's chunk; ``models/ssm.py``
reads ``cfg.ssm.chunk``), ``seq_parallel``, ``act_spec`` and
``act_inner_spec`` (the policy's knob decides, and ``spmd.Layout`` holds
the shard), ``attn_impl`` and the
``BASELINE`` instance (the port always attends through the flash kernel
where there is no cache; ``plain_kernels()`` in ``chip_smoke.py`` swaps in
the plain versions for a comparison), ``kv_chunk`` (the flash backward's kv
chunk is ``kernels.ops.KV_CHUNK``), the expert-parallel knobs
(``moe_expert_axis``, ``moe_token_axes``), which wait for the all-to-all
dispatch (ROADMAP Queue 1 item 9, what is left of it),
``decode_window_only`` (decode always masks
with ``cfg.sliding_window``), ``scan_layers`` (the port always loops over
stacked layers) and ``use_pallas`` / ``pallas_interpret`` (the port's
kernels are chosen by the tensors' device, ``kernels/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Runtime:
    remat: bool = True         # recompute each layer's forward in backward
    moe_impl: str = "sort"     # "sort" (capacity dispatch) | "dense" (oracle)
    spmd: Any = None           # a bound step's spmd.Layout; None off a mesh


DEFAULT = Runtime()
