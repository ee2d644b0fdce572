"""The port's SPMD layer over a torch ``DeviceMesh``: by hand, what XLA's
SPMD partitioner does for the JAX package's jitted steps.

Design: ZeRO-3 over every axis of a leaf's spec, with the compute split
over the batch axes.

- A rank stores exactly the shard its spec gives, as a DTensor (``put``):
  its local tensor is the slice that the spec and the rank's mesh
  coordinate define (``local_slice``; a tuple entry's axes major to minor,
  as DTensor lays out one dim over several mesh dims).
- Model code sees a stored leaf as a ``Sharded`` (local tensor, spec,
  layout) and gathers it at use into a plain tensor (``Layout.gathered``:
  one all-gather a mesh axis the spec names, minor axes first), so the
  kernels keep seeing plain contiguous tensors. ``models/blocks.py::
  scan_units`` gathers one unit's leaves at a time, inside the checkpoint
  under remat, so the recompute gathers again and no unit's full weights
  outlive its use.
- The gather's backward sums the full gradient over the batch axes into
  the shard: a reduce-scatter over each batch axis that shards the leaf,
  an all-reduce over each one that does not, and a plain slice along the
  other axes (ranks along ``model`` computed the same rows, so they are
  not summed in). DTensor's own Shard -> Replicate backward only slices,
  which would drop every other data rank's rows.
- A rank computes its rows of each microbatch (``rows``). A moe layer
  gathers the microbatch's tokens over the batch axes before its router
  and keeps its rows after (``gather_rows`` / ``rows``): the capacity
  and the load-balance loss are defined over the whole microbatch.
- A decode cache is gathered at use along its non-batch sharded dims, and
  each rank writes back the slice it owns (``open_cache`` /
  ``close_cache``).
- Every collective goes through ``_collective``, which counts it in
  ``COLLECTIVES`` (calls and bytes by kind), as the kernel wrappers count
  their launches. Collectives are issued on groups of one rank too.

Every rank must issue the same collectives in the same order: each runs
the same program on tensors of the same shapes, and autograd's backward
visits identical graphs in one order.

Not here yet (ROADMAP Queue 1 item 9): compute split over ``model``
(heads and FFN columns, an all-reduce a layer), ``seq_parallel``
activations and the expert-parallel dispatch.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P

KINDS = ("all_gather", "reduce_scatter", "all_reduce")


class Collectives:
    """Collectives issued since the last ``reset``, by kind: ``calls`` and
    ``bytes`` (the gathered tensor's for an all-gather, the summed input's
    for a reduce-scatter, the tensor's for an all-reduce)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += nbytes


COLLECTIVES = Collectives()


def _collective(kind: str, out, inp, group) -> None:
    import torch.distributed as dist
    if kind == "all_gather":
        dist.all_gather_into_tensor(out, inp, group=group)
        counted = out
    elif kind == "reduce_scatter":
        dist.reduce_scatter_tensor(out, inp, group=group)
        counted = inp
    else:
        dist.all_reduce(inp, group=group)
        counted = inp
    COLLECTIVES.add(kind, counted.numel() * counted.element_size())


def is_device_mesh(mesh) -> bool:
    """True for a torch ``DeviceMesh`` (a process group behind it)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _dim_of(spec: P, axis: str):
    """The dim whose entry names ``axis``, or None."""
    for d, entry in enumerate(spec):
        if axis in SH.axes_of(entry):
            return d
    return None


def local_slice(t: torch.Tensor, spec: P, sizes: Dict[str, int],
                coord: Dict[str, int]) -> torch.Tensor:
    """The part of ``t`` that the rank at mesh coordinate ``coord`` holds
    under ``spec`` (a view): along each dim, chunk ``i`` of ``n``, n the
    product of the entry's axis sizes and i their coordinates read major
    to minor."""
    for d, entry in enumerate(spec):
        i, n = 0, 1
        for a in SH.axes_of(entry):
            i, n = i * sizes[a] + coord[a], n * sizes[a]
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split {n} ways ({spec})")
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
    return t


def put(mesh, tr: Any, specs: Any) -> Any:
    """Every leaf of ``tr`` stored as its spec gives on ``mesh`` (JAX's
    ``device_put`` with ``NamedSharding``s): on a ``DeviceMesh`` a DTensor
    whose local tensor is a copy of this rank's slice; a leaf that is
    already a DTensor must carry its spec's placements and stays. On an
    ``AbstractMesh`` (one device, no process group) the tree as it is."""
    if not is_device_mesh(mesh):
        return tr
    from torch.distributed.tensor import DTensor
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))

    def one(t, spec):
        pl = SH.placements(names, spec)
        if isinstance(t, DTensor):
            if list(t.placements) != pl:
                raise ValueError(f"leaf placed {t.placements}, spec {spec} "
                                 f"wants {pl}")
            return t
        local = local_slice(t, spec, sizes, coord).contiguous().clone()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return tree.map(lambda s, t: one(t, s), specs, tr, is_leaf=SH.is_spec)


def writer_copy(mesh, tr: Any) -> Any:
    """A stored tree whole, for the one process that writes it (a
    checkpoint). On a ``DeviceMesh`` every rank gathers the leaves (the
    DTensors a bound step stores) one at a time (DTensor's own all-gathers, not counted); rank 0 copies
    each to the host, and every rank frees it before the next, so no rank
    holds more than one full leaf on its device. Returns the host tree on
    rank 0 and None on the others. On a host mesh: the tree as it is."""
    if not is_device_mesh(mesh):
        return tr
    import torch.distributed as dist
    writer = dist.get_rank() == 0

    def one(t):
        whole = t.full_tensor()
        # a copy even on the CPU, so the gathered tensor dies with this call
        return whole.to("cpu", copy=True) if writer else None

    out = tree.map(one, tr)
    return out if writer else None


def local_of(t) -> torch.Tensor:
    """A stored leaf's local tensor (a DTensor's; a plain tensor itself)."""
    return t.to_local() if hasattr(t, "to_local") else t


class Sharded:
    """One stored leaf as model code sees it on a mesh: the rank's local
    tensor, its spec and the layout that gathers it (``Layout.gathered``).
    ``unbind(0)`` and ``[u]`` take the stacked unit axis, which a spec
    never shards."""
    __slots__ = ("local", "spec", "layout")

    def __init__(self, local: torch.Tensor, spec: P, layout: "Layout"):
        self.local, self.spec, self.layout = local, spec, layout

    def _unit(self, t) -> "Sharded":
        if self.spec[0] is not None:
            raise ValueError(f"the unit axis is sharded: {self.spec}")
        return Sharded(t, P(*self.spec[1:]), self.layout)

    def unbind(self, dim: int = 0):
        if dim != 0:
            raise ValueError("only the unit axis (0) unbinds")
        return [self._unit(t) for t in self.local.unbind(0)]

    def __getitem__(self, u: int) -> "Sharded":
        return self._unit(self.local[u])


class _Gather(torch.autograd.Function):
    """local shard -> the full tensor; backward: the full gradient summed
    over the batch axes into the shard."""

    @staticmethod
    def forward(ctx, local, layout, spec):
        ctx.layout, ctx.spec = layout, spec
        return layout.all_gather(local, spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.reduce_to_shard(g, ctx.spec), None, None


class _GatherRows(torch.autograd.Function):
    """This rank's rows -> the rows of every rank along the batch axes, in
    batch order; backward: the gradient's rows summed back to their rank."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout._gather_dim(x, 0, layout.batch_group, layout.dp)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        return layout._scatter_dim(g, 0, layout.batch_group, layout.dp), None


class Layout:
    """One bound step's view of a ``DeviceMesh``: this rank's coordinate,
    a group per mesh axis, the batch axes' group, and whether the step
    splits its batch rows over them (``split_batch``: the global batch
    divides the batch axes' size, as ``SH.batch_specs`` decides; else every
    rank computes every row)."""

    def __init__(self, mesh, policy: SH.ShardingPolicy, *, split_batch: bool):
        names = tuple(mesh.mesh_dim_names)
        if names != policy.axis_names or \
                tuple(mesh.shape) != policy.axis_sizes:
            raise ValueError(f"policy {policy.axis_names}={policy.axis_sizes}"
                             f" is not the mesh's {names}={tuple(mesh.shape)}")
        self.mesh, self.policy, self.split_batch = mesh, policy, split_batch
        self.names = names
        self.sizes = dict(zip(names, mesh.shape))
        self.coord = dict(zip(names, mesh.get_coordinate()))
        self.groups = {n: mesh.get_group(n) for n in names}
        self.batch_axes = policy.batch_axes
        self.dp = policy.size(self.batch_axes)
        rank = 0
        for a in self.batch_axes:
            rank = rank * self.sizes[a] + self.coord[a]
        self.batch_rank = rank
        if len(self.batch_axes) == 1:
            self.batch_group = self.groups[self.batch_axes[0]]
        else:
            self.batch_group = mesh[self.batch_axes]._flatten().get_group()

    # -- stored leaves ------------------------------------------------------

    def sharded(self, stored: Any, specs: Any) -> Any:
        """The stored tree (``put``'s DTensors, or plain full tensors,
        sliced here) as ``Sharded`` leaves over their local tensors."""
        placed = put(self.mesh, stored, specs)
        return tree.map(lambda s, t: Sharded(local_of(t), s, self), specs,
                        placed, is_leaf=SH.is_spec)

    def stored(self, locals_: Any, specs: Any) -> Any:
        """Local tensors back as the DTensors of their specs."""
        from torch.distributed.tensor import DTensor
        return tree.map(
            lambda s, t: DTensor.from_local(
                t, self.mesh, SH.placements(self.names, s), run_check=False),
            specs, locals_, is_leaf=SH.is_spec)

    def gathered(self, tr: Any) -> Any:
        """Every ``Sharded`` leaf of ``tr`` gathered into its full tensor
        (differentiable: the backward sums over the batch axes into the
        shard); other leaves as they are."""
        return tree.map(lambda a: _Gather.apply(a.local, self, a.spec)
                        if isinstance(a, Sharded) else a, tr)

    # -- collectives on one leaf ------------------------------------------

    def _gather_dim(self, t, d: int, group, n: int):
        t = t.contiguous()
        # the ranks' tensors concatenated along dim 0 (every backend takes
        # that form), then each rank's block moved to its place along d
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        _collective("all_gather", out, t, group)
        if d == 0:
            return out
        shape = list(t.shape)
        shape[d] *= n
        return out.view((n,) + tuple(t.shape)).movedim(0, d).reshape(shape)

    def _scatter_dim(self, g, d: int, group, n: int):
        """g summed over ``group``; this rank's chunk along d."""
        if d:
            g = torch.cat(g.chunk(n, dim=d))  # the chunks along dim 0
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _collective("reduce_scatter", out, g, group)
        return out

    def all_gather(self, local, spec: P):
        """The full tensor of ``local`` under ``spec``: one all-gather a
        mesh axis the spec names, the mesh's minor axes first."""
        t = local
        for a in reversed(self.names):
            d = _dim_of(spec, a)
            if d is not None:
                t = self._gather_dim(t, d, self.groups[a], self.sizes[a])
        return t

    def reduce_to_shard(self, g, spec: P):
        """A full gradient summed over the batch axes, as the shard of
        ``spec``: the mesh's major axes first, a reduce-scatter over a batch
        axis that shards the leaf, an all-reduce over one that does not, a
        slice along any other axis that shards it."""
        for a in self.names:
            d = _dim_of(spec, a)
            n = self.sizes[a]
            if a in self.batch_axes:
                if d is None:
                    g = g.clone(memory_format=torch.contiguous_format)
                    _collective("all_reduce", None, g, self.groups[a])
                else:
                    g = self._scatter_dim(g, d, self.groups[a], n)
            elif d is not None:
                size = g.shape[d] // n
                g = g.narrow(d, self.coord[a] * size, size)
        return g.contiguous()

    # -- batch rows ---------------------------------------------------------

    def rows(self, x):
        """This rank's rows of a global batch entry, or of what
        ``gather_rows`` gathered (every row when the batch is not
        split)."""
        if not self.split_batch:
            return x
        if x.shape[0] % self.dp:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.batch_axes} ({self.dp})")
        b = x.shape[0] // self.dp
        return x.narrow(0, self.batch_rank * b, b)

    def gather_rows(self, x):
        """Every rank's rows of x in batch order (differentiable; x as it
        is when the batch is not split)."""
        if not self.split_batch:
            return x
        return _GatherRows.apply(x, self)

    def mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalars averaged over the batch axes (one all-reduce)."""
        keys = sorted(values)
        buf = torch.stack([values[k].float() for k in keys])
        _collective("all_reduce", None, buf, self.batch_group)
        buf = buf / self.dp if self.dp > 1 else buf
        return {k: buf[i] for i, k in enumerate(keys)}

    # -- decode caches ------------------------------------------------------

    @staticmethod
    def _cache_spec(spec: P) -> P:
        """A unit cache leaf's spec without its batch dim (dim 0): the rows
        a rank computes are its own, the rest is gathered at use."""
        return P(None, *spec[1:])

    def open_cache(self, unit_cache: Any) -> Any:
        """A unit's cache (``Sharded`` leaves of ``[B, ...]``) as full
        tensors along every non-batch dim."""
        return tree.map(lambda a: self.all_gather(a.local,
                                                  self._cache_spec(a.spec))
                        if isinstance(a, Sharded) else a, unit_cache)

    def close_cache(self, unit_cache: Any, full: Any) -> None:
        """Write this rank's slice of each updated full leaf back into its
        shard."""
        def back(a, f):
            if isinstance(a, Sharded):
                a.local.copy_(local_slice(f, self._cache_spec(a.spec),
                                          self.sizes, self.coord))
        tree.map(back, unit_cache, full)


# ---------------------------------------------------------------------------
# what the specs predict
# ---------------------------------------------------------------------------

def _named_axes(spec: P) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in SH.axes_of(e))


def step_collectives(params_shape: Any, pspecs: Any,
                     policy: SH.ShardingPolicy, *, passes: int = 1,
                     backward: bool = False, micro: int = 1,
                     cache_shape: Any = None,
                     gather_logits: bool = False) -> Dict[str, int]:
    """The collectives a bound step issues, from its specs alone: each of
    ``micro`` microbatches runs the model's forward ``passes`` times (2
    under remat: the recompute gathers the stacks again), gathering every
    leaf once a pass (a stacked leaf once a unit) with one all-gather a
    mesh axis its spec names, and with ``backward`` sums each gathered
    leaf's gradient back (one collective a batch axis, a unit at a time);
    a moe layer gathers its tokens a pass and, with ``backward``,
    reduce-scatters their gradient. A training
    step adds one all-reduce of its metrics; a serving step gathers each
    leaf of its cache (``cache_shape``, meta tensors) along the non-batch
    axes its spec names, a unit at a time, and its logits over the batch
    (``gather_logits``). The step's global batch is taken to divide the
    batch axes (``Layout.split_batch``), as every caller's does; every
    stack is taken to run: an encdec decode step, which runs no encoder,
    issues fewer."""
    out = dict.fromkeys(KINDS, 0)
    moe_layers = 0
    for path, leaf, spec in zip(tree.leaf_paths(params_shape),
                                tree.leaves(params_shape),
                                tree.leaves(pspecs, is_leaf=SH.is_spec)):
        stacked = path[0] in SH._STACKED_ROOTS
        units = leaf.shape[0] if stacked else 1
        if path[-1] == "router":
            moe_layers += units
        # the leaves outside the stacks are gathered outside the checkpoints
        out["all_gather"] += (passes if stacked else 1) * units * \
            len(_named_axes(spec))
        if backward:
            for a in policy.batch_axes:
                kind = "reduce_scatter" if a in _named_axes(spec) \
                    else "all_reduce"
                out[kind] += units
    if moe_layers:
        out["all_gather"] += passes * moe_layers
        if backward:
            out["reduce_scatter"] += moe_layers
    if cache_shape is not None:
        for leaf, spec in zip(tree.leaves(cache_shape), tree.leaves(
                SH.cache_specs(cache_shape, policy), is_leaf=SH.is_spec)):
            out["all_gather"] += leaf.shape[0] * len(_named_axes(
                Layout._cache_spec(P(*spec[1:]))))
    out = {k: v * micro for k, v in out.items()}
    if backward:
        out["all_reduce"] += 1
    if gather_logits:
        out["all_gather"] += 1
    return out
