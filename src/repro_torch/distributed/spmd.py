"""The port's SPMD layer over a torch ``DeviceMesh``: by hand, what XLA's
SPMD partitioner does for the JAX package's jitted steps.

Design: ZeRO-3 over the batch axes of a leaf's spec, tensor parallelism
(Megatron's) over ``model``, the compute split over the batch axes.

- A rank stores exactly the shard its spec gives, as a DTensor (``put``):
  its local tensor is the slice that the spec and the rank's mesh
  coordinate define (``local_slice``; a tuple entry's axes major to minor,
  as DTensor lays out one dim over several mesh dims).
- Model code sees a stored leaf as a ``Sharded`` (local tensor, spec,
  layout). Each module's leaves are gathered at use by the module's
  ``plan`` (``Layout.module_at_use``), one all-gather a mesh axis, minor
  axes first, into plain tensors, so the kernels keep seeing plain
  contiguous tensors. A leaf whose ``model`` entry lies on the dim the
  module's compute splits (attention heads, FFN columns, experts, Mamba's
  d_inner, the vocab) is gathered over the batch axes only and reaches the
  model code as the rank's ``model`` shard (mode ``"local"``); any other
  leaf is gathered whole (``"whole"``; ``"summed"`` where each rank uses
  only part of it, below). ``models/blocks.py::scan_units`` gathers one
  unit's leaves at a time, inside the checkpoint under remat, so the
  recompute gathers again and no unit's full weights outlive its use.
- A split module runs between Megatron's two operators: its input passes
  an entry (``enter``: forward identity, backward all-reduce over
  ``model``) and its partial output an exit (``exit``: forward all-reduce,
  backward identity). Under ``seq_parallel`` (training only) the residual
  stream between sublayers is the rank's sequence shard; the entry becomes
  an all-gather along the sequence (backward reduce-scatter) and the exit a
  reduce-scatter (backward all-gather), and a module that computes
  replicated gathers (backward: the rank's slice) and slices (backward:
  all-gather) instead (``part_in`` / ``part_out``).
- The gather's backward sums the gradient over the batch axes into the
  shard: a reduce-scatter over each batch axis that shards the leaf, an
  all-reduce over each one that does not. Along ``model``: a ``"local"``
  leaf's gradient is its shard's already; a ``"whole"`` leaf's is the same
  on every ``model`` rank and is sliced; a ``"summed"`` leaf's (kv
  projections that several ranks slice, Mamba's ``in_proj``, and under
  ``seq_parallel`` the norms, which see one sequence shard) is summed over
  ``model`` too. DTensor's own Shard -> Replicate backward only slices,
  which would drop every other rank's rows.
- A rank computes its rows of each microbatch (``rows``). A moe layer
  gathers the microbatch's tokens over the batch axes before its router
  and keeps its rows after (``gather_rows`` / ``rows``): the capacity
  and the load-balance loss are defined over the whole microbatch.
- A decode cache is gathered at use along its sharded non-batch dims (the
  k/v sequence; a Mamba state's d_inner stays the rank's), and each rank
  writes back the slice it owns (``open_cache`` / ``close_cache``). A
  split attention gathers its new k/v over ``model``'s heads before it
  writes them.
- Every collective goes through ``_collective``, which counts it in
  ``COLLECTIVES`` (calls and bytes by kind), as the kernel wrappers count
  their launches. Collectives are issued on groups of one rank too, and
  ``step_collectives`` predicts them from the specs alone.

Every rank must issue the same collectives in the same order: each runs
the same program on tensors of the same shapes, and autograd's backward
visits identical graphs in one order.

Not here yet (ROADMAP Queue 1 item 9): the expert-parallel all-to-all
dispatch (every rank routes the microbatch's tokens and runs its own
experts on them) and the split-S flash-decode combine (a decode step
gathers the k/v cache along the sequence).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_reduce_max")


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
    elif kind == "all_reduce_max":
        dist.all_reduce(inp, op=dist.ReduceOp.MAX, group=group)
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
    tensor, its spec and the layout that gathers it. ``unbind(0)`` and
    ``[u]`` take the stacked unit axis, which a spec never shards."""
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

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole leaf's shape."""
        size = self.layout.policy.size
        return tuple(n * size(SH.axes_of(e)) for n, e in zip(self.local.shape,
                                                             self.spec))


# ---------------------------------------------------------------------------
# compute split over ``model``: one module's plan
# ---------------------------------------------------------------------------

# a params dict key -> the kind of module under it (a leaf for embed and
# unembed)
MODULE_KINDS = {"attn": "attention", "cross": "attention", "mlp": "mlp",
                "moe": "moe", "ssm": "ssm", "norm1": "norm", "norm2": "norm",
                "norm_x": "norm", "final_norm": "norm", "enc_norm": "norm",
                "embed": "embed", "unembed": "unembed"}


@dataclasses.dataclass(frozen=True)
class Split:
    """How one module computes its ``model`` shard on one rank: ``lo`` and
    ``n``, the rank's slice of the dim the module splits (attention: its
    query heads; mlp: FFN columns; moe: experts; ssm: d_inner channels;
    embed and unembed: vocab rows). Attention also: ``kv``, the rank's
    first kv head and their count among the whole kv heads; ``kv_whole``,
    whether ``wk``/``wv``/``bk``/``bv`` arrive whole (their spec does not
    split the kv heads alike) for the model code to slice; and
    ``cache_heads``, which heads of the k/v gathered over ``model`` are the
    whole kv heads in order (None: all of them, in order). ``size`` is
    ``model``'s; ``layout`` issues the module's collectives."""
    lo: int
    n: int
    size: int
    kv: Tuple[int, int] = (0, 0)
    kv_whole: bool = False
    cache_heads: Optional[Tuple[int, ...]] = None
    layout: Any = dataclasses.field(default=None, compare=False, repr=False)


def _on(specs, tp, name, d) -> bool:
    return name in specs and tp in SH.axes_of(specs[name][d])


def _agree(specs, tp, names_dims, what) -> None:
    """Raise unless every present leaf of ``names_dims`` puts ``tp`` on its
    dim: a module whose leaves disagree cannot split."""
    bad = [n for n, d in names_dims if n in specs and not _on(specs, tp, n, d)]
    if bad:
        raise ValueError(f"{what}: {bad} do not split alike "
                         f"({ {n: specs[n] for n in specs} })")


def plan(kind: str, shapes: Dict[str, Tuple[int, ...]], specs: Dict[str, P],
         m: int, rank: int, *, seq_parallel: bool = False,
         tp: str = "model") -> Tuple[Optional[Split], Dict[str, str]]:
    """One module's route from its leaves' whole shapes and specs (one
    unit's: no stacked axis; names as ``module_leaves`` gives them):
    (its ``Split`` on the ``model`` rank ``rank`` of ``m``, or None when
    it computes replicated; each leaf's gather mode). A module splits
    where its first leaf's spec puts ``tp`` on the dim its compute splits:
    attention when ``wq``'s heads are on it (not under the head_dim
    fallback), mlp on ``wi``'s columns, moe on the experts, ssm on
    ``conv_w``'s d_inner, embed and unembed on the vocab; the module's
    other leaves must agree (raises otherwise). A split module's leaves
    that it takes whole and slices (kv heads whose spec does not split
    them alike, the ssm's ``[x | z]`` ``in_proj``) are ``"summed"``: each
    rank's gradient is a part. Norms compute replicated; under
    ``seq_parallel`` they see one sequence shard, so theirs are summed
    too."""
    modes = dict.fromkeys(shapes, "whole")
    if kind == "norm":
        if seq_parallel:
            modes = dict.fromkeys(shapes, "summed")
        return None, modes
    if kind == "attention":
        if not _on(specs, tp, "wq", -2):
            return None, modes
        _agree(specs, tp, (("bq", -2), ("wo", -3)), "attention")
        H, Kv = shapes["wq"][-2], shapes["wk"][-2]
        hl, G = H // m, H // Kv
        if hl % G and G % hl:
            raise ValueError(f"attention: {hl} query heads a rank over "
                             f"groups of {G} do not take whole kv heads "
                             f"or share one")
        h0 = rank * hl
        nk = max(hl // G, 1)
        kv_local = _on(specs, tp, "wk", -2)
        if kv_local:
            _agree(specs, tp, (("wv", -2), ("bk", -2), ("bv", -2)),
                   "attention kv")
        for n in ("wq", "bq", "wo"):
            if n in modes:
                modes[n] = "local"
        for n in ("wk", "wv", "bk", "bv"):
            if n in modes:
                modes[n] = "local" if kv_local else "summed"
        # kv head j is gathered from the first rank whose query heads use
        # it: the rank holding query head j * G
        heads = tuple((j * G // hl) * nk + j - (j * G // hl) * hl // G
                      for j in range(Kv))
        return Split(h0, hl, m, (h0 // G, nk), not kv_local,
                     None if heads == tuple(range(Kv)) else heads), modes
    if kind == "mlp":
        if not _on(specs, tp, "wi", -1):
            return None, modes
        _agree(specs, tp, (("wg", -1), ("wo", -2)), "mlp")
        fl = shapes["wi"][-1] // m
        return Split(rank * fl, fl, m), dict.fromkeys(shapes, "local")
    if kind == "moe":
        routed = _on(specs, tp, "experts.wi", -3)
        shared = _on(specs, tp, "shared.wi", -1)
        if "shared.wi" in specs and shared != routed:
            raise ValueError(f"moe: the experts ({routed}) and the shared "
                             f"experts ({shared}) do not split alike")
        if not routed:
            return None, modes
        _agree(specs, tp, (("experts.wg", -3), ("experts.wo", -3),
                           ("shared.wg", -1), ("shared.wo", -2)), "moe")
        el = shapes["experts.wi"][-3] // m
        modes = {n: "whole" if n == "router" else "local" for n in shapes}
        return Split(rank * el, el, m), modes
    if kind == "ssm":
        if not _on(specs, tp, "conv_w", -1):
            return None, modes
        _agree(specs, tp, (("in_proj", -1), ("conv_b", -1), ("x_proj", -2),
                           ("dt_proj", -1), ("dt_bias", -1), ("A_log", -2),
                           ("Dskip", -1), ("out_proj", -2)), "ssm")
        dl = shapes["conv_w"][-1] // m
        # in_proj's columns are [x | z]: each rank takes its channels of
        # both from the whole matrix
        modes = {n: "summed" if n == "in_proj" else "local" for n in shapes}
        return Split(rank * dl, dl, m), modes
    if kind in ("embed", "unembed"):
        d = 0 if kind == "embed" else -1
        if not _on(specs, tp, "", d):
            return None, modes
        vl = shapes[""][d] // m
        return Split(rank * vl, vl, m), {"": "local"}
    raise ValueError(f"no plan for a module of kind {kind!r}")


def module_leaves(mod) -> Dict[str, Any]:
    """A module's leaves by name (a moe's nested ones as ``experts.wi``;
    a lone leaf, embed or unembed, as ``""``)."""
    if not isinstance(mod, dict):
        return {"": mod}
    out = {}
    for k, v in mod.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


def _unflatten_module(mod, leaves: Dict[str, Any]):
    if not isinstance(mod, dict):
        return leaves[""]
    return {k: {n: leaves[f"{k}.{n}"] for n in v} if isinstance(v, dict)
            else leaves[k] for k, v in mod.items()}


class _Gather(torch.autograd.Function):
    """local shard -> the tensor its mode gives (whole, or the rank's
    ``model`` shard); backward: the gradient summed into the shard."""

    @staticmethod
    def forward(ctx, local, layout, spec, mode):
        ctx.layout, ctx.spec, ctx.mode = layout, spec, mode
        return layout.all_gather(local, spec, mode)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.reduce_to_shard(g, ctx.spec, ctx.mode), None, \
            None, None


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


# -- Megatron's operators over ``model`` -------------------------------------

class _Enter(torch.autograd.Function):
    """A split module's input: forward identity; backward the ranks'
    partial gradients all-reduced over ``model``."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._all_reduce_model(g), None


class _Exit(torch.autograd.Function):
    """A split module's partial output: forward all-reduced over
    ``model``; backward identity (every rank's consumer is the same)."""

    @staticmethod
    def forward(ctx, x, layout):
        return layout._all_reduce_model(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """A partial sum that split compute consumes (Mamba's ``x_proj``
    output): all-reduced over ``model`` forward and backward."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout._all_reduce_model(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._all_reduce_model(g), None


class _SeqIn(torch.autograd.Function):
    """The rank's sequence shard [B, S/m, ...] -> the whole sequence
    (all-gather along dim 1 over ``model``); backward: a reduce-scatter
    (``partial``: each rank's gradient is its part) or the rank's slice
    (every rank's gradient is the same)."""

    @staticmethod
    def forward(ctx, x, layout, partial):
        ctx.layout, ctx.partial = layout, partial
        return layout._gather_dim(x, 1, layout.mgroup, layout.m)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        if ctx.partial:
            return layout._scatter_dim(g, 1, layout.mgroup, layout.m), \
                None, None
        return layout._own_seq(g).contiguous(), None, None


class _SeqOut(torch.autograd.Function):
    """The whole sequence -> the rank's shard: a reduce-scatter along dim
    1 over ``model`` (``partial``) or the rank's slice; backward: an
    all-gather along the sequence."""

    @staticmethod
    def forward(ctx, x, layout, partial):
        ctx.layout = layout
        if partial:
            return layout._scatter_dim(x, 1, layout.mgroup, layout.m)
        return layout._own_seq(x)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        return layout._gather_dim(g, 1, layout.mgroup, layout.m), None, None


class _GradScale(torch.autograd.Function):
    """Forward identity; backward the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


class Layout:
    """One bound step's view of a ``DeviceMesh``: this rank's coordinate,
    a group per mesh axis, the batch axes' group, whether the step
    splits its batch rows over them (``split_batch``: the global batch
    divides the batch axes' size, as ``SH.batch_specs`` decides; else every
    rank computes every row), and whether its residual stream is the
    rank's sequence shard (``seq_parallel``: a training step's, under the
    policy's knob)."""

    def __init__(self, mesh, policy: SH.ShardingPolicy, *, split_batch: bool,
                 seq_parallel: bool = False):
        names = tuple(mesh.mesh_dim_names)
        if names != policy.axis_names or \
                tuple(mesh.shape) != policy.axis_sizes:
            raise ValueError(f"policy {policy.axis_names}={policy.axis_sizes}"
                             f" is not the mesh's {names}={tuple(mesh.shape)}")
        if policy.tp_axis not in names:
            raise ValueError(f"no {policy.tp_axis!r} axis in {names}")
        self.mesh, self.policy, self.split_batch = mesh, policy, split_batch
        self.seq_parallel = seq_parallel
        self.names = names
        self.sizes = dict(zip(names, mesh.shape))
        self.coord = dict(zip(names, mesh.get_coordinate()))
        self.groups = {n: mesh.get_group(n) for n in names}
        self.tp = policy.tp_axis
        self.m, self.mrank = self.sizes[self.tp], self.coord[self.tp]
        self.mgroup = self.groups[self.tp]
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

    def module_at_use(self, name: str, mod) -> Tuple[Any, Optional[Split]]:
        """One module (the params under key ``name``: a sublayer's attn,
        mlp, moe, ssm or norm, or a top-level embed, unembed or norm) with
        its ``Sharded`` leaves gathered by its ``plan`` (differentiable),
        and its ``Split`` (None: it computes replicated)."""
        leaves = module_leaves(mod)
        split, modes = plan(MODULE_KINDS[name],
                            {k: a.shape for k, a in leaves.items()},
                            {k: a.spec for k, a in leaves.items()},
                            self.m, self.mrank,
                            seq_parallel=self.seq_parallel, tp=self.tp)
        out = {k: _Gather.apply(a.local, self, a.spec, modes[k])
               for k, a in leaves.items()}
        if split is not None:
            split = dataclasses.replace(split, layout=self)
        return _unflatten_module(mod, out), split

    def modules_at_use(self, mods: Dict[str, Any]) -> Tuple[dict, dict]:
        """Every module of a dict (a unit's sublayer, or the top-level
        leaves but the stacks) gathered: (the dict, its splits by key)."""
        out, splits = {}, {}
        for k, v in mods.items():
            out[k], splits[k] = self.module_at_use(k, v)
        return out, splits

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

    def _all_reduce_model(self, t):
        t = t.clone(memory_format=torch.contiguous_format)
        _collective("all_reduce", None, t, self.mgroup)
        return t

    def all_gather(self, local, spec: P, mode: str = "whole"):
        """The tensor of ``local`` under ``spec`` that ``mode`` gives: one
        all-gather a mesh axis the spec names, the mesh's minor axes first,
        ``model`` left out for a ``"local"`` leaf."""
        t = local
        for a in reversed(self.names):
            d = _dim_of(spec, a)
            if d is not None and not (a == self.tp and mode == "local"):
                t = self._gather_dim(t, d, self.groups[a], self.sizes[a])
        return t

    def reduce_to_shard(self, g, spec: P, mode: str = "whole"):
        """A gradient of what ``all_gather`` gave, summed into the shard of
        ``spec``, the mesh's major axes first: over each batch axis (and
        ``model`` for a ``"summed"`` leaf) a reduce-scatter where the spec
        shards the leaf and an all-reduce where it does not; along
        ``model`` otherwise a slice (``"whole"``) or nothing (``"local"``:
        the gradient is the shard's)."""
        for a in self.names:
            d = _dim_of(spec, a)
            n = self.sizes[a]
            if a in self.batch_axes or (a == self.tp and mode == "summed"):
                if d is None:
                    g = g.clone(memory_format=torch.contiguous_format)
                    _collective("all_reduce", None, g, self.groups[a])
                else:
                    g = self._scatter_dim(g, d, self.groups[a], n)
            elif d is not None and not (a == self.tp and mode == "local"):
                size = g.shape[d] // n
                g = g.narrow(d, self.coord[a] * size, size)
        return g.contiguous()

    # -- the model split ----------------------------------------------------

    def enter(self, x):
        """Megatron's entry: forward identity, backward all-reduce over
        ``model``."""
        return _Enter.apply(x, self)

    def exit(self, x):
        """Megatron's exit: forward all-reduce over ``model``, backward
        identity."""
        return _Exit.apply(x, self)

    def sum_model(self, x):
        """A partial sum that split compute consumes: all-reduced over
        ``model`` both ways."""
        return _SumBoth.apply(x, self)

    def grad_scale(self, x, s: float):
        return _GradScale.apply(x, s)

    def part_in(self, h, split: bool):
        """A module's input from the residual stream's ``h`` [B, S, D]:
        under ``seq_parallel`` the whole sequence gathered from the ranks'
        shards; else ``enter`` for a split module, h as it is for a
        replicated one."""
        if self.seq_parallel:
            return self.seq_in(h, split)
        return self.enter(h) if split else h

    def part_out(self, y, split: bool):
        """A module's output [B, S, D] back to the residual stream: under
        ``seq_parallel`` the rank's sequence shard (summed over ``model``
        for a split module); else ``exit`` for a split module, y as it is
        for a replicated one."""
        if self.seq_parallel:
            return self.seq_out(y, split)
        return self.exit(y) if split else y

    def seq_in(self, x, partial: bool):
        """The whole sequence of ``x`` [B, S/m, ...] (``_SeqIn``)."""
        return _SeqIn.apply(x, self, partial)

    def seq_out(self, x, partial: bool):
        """The rank's sequence shard of ``x`` [B, S, ...] (``_SeqOut``)."""
        return _SeqOut.apply(x, self, partial)

    def _own_seq(self, x):
        if x.shape[1] % self.m:
            raise ValueError(f"a sequence of {x.shape[1]} does not split "
                             f"over {self.tp} ({self.m})")
        s = x.shape[1] // self.m
        return x.narrow(1, self.mrank * s, s)

    def gather_model(self, x, d: int):
        """``x`` gathered over ``model`` along dim ``d`` (the serving
        logits' vocab, a split attention's new k/v heads; no gradient)."""
        return self._gather_dim(x, d % x.dim(), self.mgroup, self.m)

    def max_model(self, x):
        """``x`` (no gradient) all-reduced by its max over ``model``."""
        x = x.clone(memory_format=torch.contiguous_format)
        _collective("all_reduce_max", None, x, self.mgroup)
        return x

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

    def _cache_mode(self, name: str) -> str:
        """A Mamba state (``conv``, ``h``) keeps its d_inner shard: the
        split ssm computes the rank's channels; k/v are gathered whole."""
        return "local" if name in _LOCAL_STATE else "whole"

    def _cache_leaves(self, unit_cache):
        for key, sub in unit_cache.items():
            for name, a in sub.items():
                yield key, name, a

    def open_cache(self, unit_cache: Any) -> Any:
        """A unit's cache (``Sharded`` leaves of ``[B, ...]``) as tensors
        whole along every non-batch dim but a Mamba state's d_inner."""
        out = {k: {} for k in unit_cache}
        for key, name, a in self._cache_leaves(unit_cache):
            out[key][name] = self.all_gather(
                a.local, self._cache_spec(a.spec), self._cache_mode(name)) \
                if isinstance(a, Sharded) else a
        return out

    def close_cache(self, unit_cache: Any, full: Any) -> None:
        """Write this rank's slice of each updated leaf back into its
        shard."""
        for key, name, a in self._cache_leaves(unit_cache):
            f = full[key][name]
            if not isinstance(a, Sharded) or f is a.local:
                continue
            spec = self._cache_spec(a.spec)
            if self._cache_mode(name) == "local":
                spec = P(*[e if self.tp not in SH.axes_of(e) else None
                           for e in spec])
            a.local.copy_(local_slice(f, spec, self.sizes, self.coord))


_LOCAL_STATE = ("conv", "h")


# ---------------------------------------------------------------------------
# what the specs predict
# ---------------------------------------------------------------------------

def _named_axes(spec: P) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in SH.axes_of(e))


def _modules(params_shape: Any, pspecs: Any):
    """Every module of a params tree in the order the model runs a unit's
    as (stack root or None, sublayer key, units, module key, leaves' unit
    shapes, unit specs): a stack's modules once for all its units (their
    leaves stacked at dim 0, which no spec shards)."""
    for root, sub in params_shape.items():
        specs = pspecs[root]
        if root in SH._STACKED_ROOTS:
            for lk, layer in sub.items():
                for mk, mod in layer.items():
                    leaves = module_leaves(mod)
                    ls = module_leaves(specs[lk][mk])
                    units = next(iter(leaves.values())).shape[0]
                    yield (root, lk, units, mk,
                           {k: tuple(a.shape[1:]) for k, a in leaves.items()},
                           {k: P(*ls[k][1:]) for k in leaves})
        else:
            leaves = module_leaves(sub)
            ls = module_leaves(specs)
            yield (None, None, 1, root,
                   {k: tuple(a.shape) for k, a in leaves.items()},
                   {k: ls[k] for k in leaves})


def plan_table(params_shape: Any, pspecs: Any, policy: SH.ShardingPolicy,
               rank: int = 0) -> Dict[Tuple[str, str], Tuple[Any, Dict]]:
    """Every module's ``plan`` on ``model`` rank ``rank`` from the specs
    alone: {(``"root.lk"`` for a stack's sublayer or ``""``, module key):
    (its ``Split`` or None, its leaves' gather modes)}."""
    out = {}
    for root, lk, _, mk, shapes, specs in _modules(params_shape, pspecs):
        where = "" if root is None else f"{root}.{lk}"
        out[(where, mk)] = plan(MODULE_KINDS[mk], shapes, specs,
                                policy.size(policy.tp_axis), rank,
                                seq_parallel=policy.seq_parallel,
                                tp=policy.tp_axis)
    return out


def step_collectives(params_shape: Any, pspecs: Any,
                     policy: SH.ShardingPolicy, *, passes: int = 1,
                     backward: bool = False, micro: int = 1,
                     cache_shape: Any = None, gather_logits: bool = False,
                     decode: bool = False) -> Dict[str, int]:
    """The collectives a bound step issues, from its specs alone.

    Each of ``micro`` microbatches runs the model's forward ``passes``
    times (2 under remat: the recompute runs the stacks again) and, with
    ``backward``, its backward once:

    - every leaf is gathered once a pass (a stacked leaf once a unit) with
      one all-gather a mesh axis its spec names, ``model`` left out where
      the leaf's module splits on it (``plan``); with ``backward`` each
      gradient is summed back with one collective a batch axis, and one
      over ``model`` for a ``"summed"`` leaf;
    - a split module's exit is an all-reduce a pass and its entry one in
      the backward; under ``seq_parallel`` (a training step's) every
      module gathers its input along the sequence a pass (a reduce-scatter
      back for a split one) and returns its output's shard (a
      reduce-scatter a pass for a split one; an all-gather back for
      every one). The remat recompute (non-reentrant checkpoints) stops
      at the last tensor the backward needs, so a unit's last module runs
      its exit (or its output's reduce-scatter) once a microbatch, not a
      pass; a split ssm sums its ``x_proj`` product both ways, a
      split moe its gates' gradient, and a split cross-attention its
      encoder memory's gradient;
    - a moe layer gathers its tokens over the batch a pass and, with
      ``backward``, reduce-scatters their gradient;
    - a split embedding's exit is one all-reduce; a training step's split
      unembedding enters (one all-reduce in the backward) and its loss
      takes a max and two sums over ``model``; under ``seq_parallel`` the
      residual stream's shard is taken once (an all-gather back; an
      encdec encoder's frames take no gradient) and gathered once for the
      logits (and the encoder's memory);
    - a training step adds one all-reduce of its metrics.

    A serving step (``cache_shape``, meta tensors) gathers each leaf of
    its cache along the non-batch axes its spec names (a Mamba state's
    ``model`` axis left out), a unit at a time; a split attention gathers
    its new k/v over ``model`` (a cross-attention at the prefill only),
    and with ``gather_logits`` the logits are gathered over ``model`` (a
    split unembedding) and over the batch. ``decode``: a decode step runs
    no encoder. The step's global batch is taken to divide the batch axes
    (``Layout.split_batch``), as every caller's does."""
    out = dict.fromkeys(KINDS, 0)
    tp = policy.tp_axis
    m = policy.size(tp)
    sp = policy.seq_parallel and backward
    tied = "unembed" not in params_shape
    logits_split = False
    per_micro = dict.fromkeys(KINDS, 0)

    def add(kind, n):
        per_micro[kind] += n

    parts: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    for root, lk, units, mk, shapes, specs in _modules(params_shape, pspecs):
        if decode and root == "encoder":
            continue
        kind = MODULE_KINDS[mk]
        split, modes = plan(kind, shapes, specs, m, 0, seq_parallel=sp,
                            tp=tp)
        reps = passes if root is not None else 1
        for k, spec in specs.items():
            named = _named_axes(spec)
            add("all_gather", reps * units * (len(named) - (
                modes[k] == "local" and tp in named)))
            if backward:
                for a in policy.batch_axes:
                    add("reduce_scatter" if a in named else "all_reduce",
                        units)
                if modes[k] == "summed":
                    add("reduce_scatter" if tp in named else "all_reduce",
                        units)
        if root is None:
            if kind == "embed" and split is not None:
                add("all_reduce", 1)
            if (kind == "unembed" or (kind == "embed" and tied)) and \
                    split is not None:
                logits_split = True
            continue
        if mk == "moe":
            add("all_gather", passes * units)
            if backward:
                add("reduce_scatter", units)
                if split is not None:
                    add("all_reduce", units)
        if mk == "ssm" and split is not None:
            add("all_reduce", passes * units + (units if backward else 0))
        if mk == "cross" and split is not None and backward:
            add("all_reduce", units)
        if kind == "norm":
            continue
        part = "ffn" if mk in ("moe", "mlp") else mk
        parts.setdefault((root, lk, part), dict(units=units, split=set()))[
            "split"].add(split is not None)
        if cache_shape is not None and kind == "attention" and \
                split is not None and root != "encoder" and \
                (mk == "attn" or not decode):
            add("all_gather", 2 * units)
    last = {key[0]: key for key in parts}
    for key, info in parts.items():
        if len(info["split"]) > 1:
            raise ValueError(f"{key}: split and replicated modules in one "
                             f"part")
        split, units = info["split"].pop(), info["units"]
        outs = units if last[key[0]] == key else passes * units
        bwd = units if backward else 0
        if sp:
            add("all_gather", passes * units + bwd)
            if split:
                add("reduce_scatter", outs + bwd)
        elif split:
            add("all_reduce", outs + bwd)
    if backward:
        if logits_split:
            add("all_reduce_max", 1)
            add("all_reduce", 2 + (0 if sp else 1))
        if sp:
            encdec = "encoder" in params_shape
            add("all_gather", 1)                  # the stream shard's backward
            add("all_gather", 2 if encdec else 1)        # logits (+ memory)
            if logits_split:
                add("reduce_scatter", 1)
    elif gather_logits and logits_split:
        add("all_gather", 1)
    if cache_shape is not None:
        for path, leaf, spec in zip(
                tree.leaf_paths(cache_shape), tree.leaves(cache_shape),
                tree.leaves(SH.cache_specs(cache_shape, policy),
                            is_leaf=SH.is_spec)):
            named = _named_axes(Layout._cache_spec(P(*spec[1:])))
            if path[-1] in _LOCAL_STATE:
                named = tuple(a for a in named if a != tp)
            add("all_gather", leaf.shape[0] * len(named))
    out = {k: v * micro for k, v in per_micro.items()}
    if backward:
        out["all_reduce"] += 1
    if gather_logits:
        out["all_gather"] += 1
    return out
