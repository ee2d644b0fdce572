"""Per-tensor sharding policy for the meshes, as
``repro.distributed.sharding``.

Axes: one card or a host of ranks ``("data", "model")``; the production
meshes are ``("data", "model")`` = (16, 16) and ``("pod", "data",
"model")`` = (2, 16, 16) (``launch/mesh.py``).

Policy, applied leaf by leaf with divisibility-checked fallback chains (a
proposed axis is used only when the dim divides the axis size, otherwise
the next candidate is tried, ending at replication):

- tensor parallel ("model"): attention q/o heads, kv heads (falling back to
  head_dim for narrow-head archs like whisper), FFN hidden, MoE expert dim,
  Mamba d_inner, vocab for embed/unembed.
- FSDP ("data"): the largest still-unsharded dim of every weight >=
  ``_FSDP_MIN`` elements (ZeRO-3: gathered at use, gradients summed back
  into the shard; ``distributed/spmd.py``).
- batch: leading dim of every input -> ("pod", "data") when divisible.
- decode caches: batch -> data when divisible; the KV sequence dim ->
  "model"; for global_batch=1 (long_500k) the sequence dim takes every
  axis instead.

Nothing here allocates: the rules read shapes (meta tensors, or the
``Spec`` tuples of ``models/model.py``) and return specs. ``P`` stands in
for JAX's ``PartitionSpec``, and ``named`` turns a spec into the DTensor
placements of a torch ``DeviceMesh`` (JAX's ``NamedSharding``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch import tree

# weights smaller than this stay replicated (norm scales, biases): the
# all-gather latency would cost more than the memory saved.
_FSDP_MIN = 1 << 16

# parameter trees whose leading dim is the stacked unit axis: never shard
# it (the loop over units takes one unit at a time).
_STACKED_ROOTS = ("blocks", "encoder", "decoder")


class P(tuple):
    """A partition spec: one entry a dim, each None (replicated), an axis
    name, or a tuple of axis names (the dim split over all of them, major
    to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def is_spec(x) -> bool:
    """``is_leaf`` for trees of specs (a ``P`` is a tuple, which the tree
    walks would otherwise enter)."""
    return isinstance(x, P)


def axes_of(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Axis-name view of a mesh + the knobs the perf loop flips (by
    default one device's mesh)."""
    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (1, 1)
    fsdp_axes: Tuple[str, ...] = ("data",)   # ZeRO-3 domain
    tp_axis: str = "model"
    seq_parallel: bool = False               # activations seq -> model at unit bounds
    grad_accum_dtype: str = "float32"        # bf16 halves the accumulator
    attn_hd_fallback: bool = True            # narrow-head archs: shard head_dim
                                             # when heads don't divide TP. False
                                             # replicates qkv instead (hd is a
                                             # contracting dim in QK^T, so
                                             # sharding it all-reduces the score
                                             # tensors every layer)

    @classmethod
    def for_mesh(cls, mesh, **kw) -> "ShardingPolicy":
        """From a torch ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``
        (both name their axes ``mesh_dim_names`` and size them ``shape``)."""
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.shape), **kw)

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

    @property
    def fsdp_size(self) -> int:
        return self.size(tuple(self.fsdp_axes))

    @property
    def tp_size(self) -> int:
        return self.size(self.tp_axis)

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes)


# ---------------------------------------------------------------------------
# tensor-parallel dim selection (fallback chains)
# ---------------------------------------------------------------------------

def _tp_candidates(path: Tuple[str, ...], shape: Tuple[int, ...],
                   hd_fallback: bool = True):
    """Ordered candidate dims (negative indices) to place on the TP axis."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if parent in ("attn", "cross"):
        hd = (-1,) if hd_fallback else ()
        if name == "wq":
            return (-2,) + hd        # heads, then (optionally) head_dim
        if name in ("wk", "wv"):
            return (-2,) + hd        # kv heads (GQA may not divide)
        if name == "wo":
            return (-3,) + ((-2,) if hd_fallback else ())
        if name in ("bq", "bk", "bv"):
            return (-2,) + hd
    if parent in ("mlp", "shared"):
        return {"wi": (-1,), "wg": (-1,), "wo": (-2,)}.get(name, ())
    if parent == "experts":
        return (-3,)                 # the expert dim => expert parallelism
    if parent == "ssm":
        return {"in_proj": (-1,), "conv_w": (-1,), "conv_b": (-1,),
                "x_proj": (-2,), "dt_proj": (-1,), "dt_bias": (-1,),
                "A_log": (-2,), "Dskip": (-1,), "out_proj": (-2,)}.get(name, ())
    if name == "embed":
        return (0, 1)                # vocab, then d_model
    if name == "unembed":
        return (-1, 0)               # vocab, then d_model
    if parent == "head":             # lstm softmax head
        return (-1,) if name == "w" else ()
    if name == "kernel":             # lstm gate kernel [(d_in+H), 4H]
        return (-1,)
    return ()


def _leaf_size(shape) -> int:
    return math.prod(shape) if shape else 1


def spec_for_param(path: Tuple[str, ...], shape: Tuple[int, ...],
                   policy: ShardingPolicy) -> P:
    """The spec of one weight leaf."""
    ndim = len(shape)
    assign: Dict[int, Any] = {}

    # 1. tensor parallel
    if policy.tp_axis in policy.axis_names:
        tp = policy.size(policy.tp_axis)
        for cand in _tp_candidates(path, shape, policy.attn_hd_fallback):
            d = cand % ndim if ndim else 0
            if ndim and shape[d] % tp == 0 and shape[d] >= tp:
                assign[d] = policy.tp_axis
                break

    # 2. FSDP over the largest remaining dim
    if policy.fsdp_axes and _leaf_size(shape) >= _FSDP_MIN:
        fs = policy.fsdp_size
        skip0 = path and path[0] in _STACKED_ROOTS
        cands = [d for d in range(ndim)
                 if d not in assign and not (skip0 and d == 0)]
        cands.sort(key=lambda d: -shape[d])
        for d in cands:
            if shape[d] % fs == 0 and shape[d] >= fs:
                ax = policy.fsdp_axes
                assign[d] = ax[0] if len(ax) == 1 else tuple(ax)
                break

    return P(*[assign.get(d) for d in range(ndim)])


def param_specs(params_shape: Any, policy: ShardingPolicy) -> Any:
    """Map a params tree (tensors, meta tensors included) to specs."""
    specs = [spec_for_param(tuple(str(k) for k in path), tuple(leaf.shape),
                            policy)
             for path, leaf in zip(tree.leaf_paths(params_shape),
                                   tree.leaves(params_shape))]
    return tree.unflatten(params_shape, specs)


def opt_state_specs(opt_state: Any, pspecs: Any) -> Any:
    """Optimizer slots mirror their weight's spec; scalars replicate.

    Works for any of the port's optimizers: slots live under keys
    ('ms','mu','m','v') with the same tree structure as params; 'step' is a
    scalar.
    """
    out = {}
    for k in opt_state:
        if k == "step":
            out[k] = P()
        else:
            out[k] = pspecs
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _has_shape(x) -> bool:
    return hasattr(x, "shape")


def batch_specs(batch_shape: Dict[str, Any], policy: ShardingPolicy) -> Any:
    """Shard dim 0 (global batch) of every input over the batch axes."""
    bp = policy.batch_axes

    def spec(leaf):
        b = leaf.shape[0] if leaf.shape else 1
        if b % policy.size(bp) == 0:
            return P(bp, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return tree.map(spec, batch_shape, is_leaf=_has_shape)


def cache_specs(cache_shape: Any, policy: ShardingPolicy) -> Any:
    """Decode-cache policy.

    Leaves (stacked over units at dim 0):
      k/v   [U, B, Smax, Kv, hd]   — the sequence over the model axis
      ck/cv [U, B, Se,  Kv, hd]    — encdec cross kv (Se=1500: replicated)
      conv  [U, B, K-1, Di]        — mamba conv window
      h     [U, B, Di,  N]         — mamba state
    """
    bp = policy.batch_axes
    bp_sz = policy.size(bp)
    tp = policy.tp_axis

    def spec(path, leaf):
        name = str(path[-1]) if path else ""
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        if name in ("k", "v"):
            B, S = shape[1], shape[2]
            if B % bp_sz == 0:
                s_ax = tp if S % policy.size(tp) == 0 else None
                return P(None, bp, s_ax, None, None)
            # long-context single-request: spread the cache over everything
            all_ax = tuple(policy.axis_names)
            if S % policy.size(all_ax) == 0:
                return P(None, None, all_ax, None, None)
            return P(None, None, None, None, None)
        if name in ("ck", "cv"):
            return P(None, bp if shape[1] % bp_sz == 0 else None,
                     None, None, None)
        if name == "conv":
            di_ax = tp if shape[-1] % policy.size(tp) == 0 else None
            return P(None, bp if shape[1] % bp_sz == 0 else None, None, di_ax)
        if name == "h":
            di_ax = tp if shape[-2] % policy.size(tp) == 0 else None
            return P(None, bp if shape[1] % bp_sz == 0 else None, di_ax, None)
        return P(*([None] * len(shape)))

    return tree.unflatten(cache_shape, [
        spec(path, leaf) for path, leaf in zip(tree.leaf_paths(cache_shape),
                                               tree.leaves(cache_shape))])


# ---------------------------------------------------------------------------
# binding helpers
# ---------------------------------------------------------------------------

def placements(axis_names: Tuple[str, ...], spec: P) -> list:
    """The DTensor placements of ``spec`` on a mesh whose dims are
    ``axis_names``: ``Shard(d)`` on each mesh dim that dim d's entry names,
    ``Replicate()`` on the others. A tuple entry splits its dim over its
    axes major to minor, and DTensor splits one dim over several mesh dims
    in mesh order, so a tuple must list its axes in mesh order (raises
    otherwise, and for an axis named twice or unknown)."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        idx = [axis_names.index(a) if a in axis_names else -1 for a in axes]
        if -1 in idx or idx != sorted(set(idx)):
            raise ValueError(f"spec {spec}: entry {entry!r} is not a run of "
                             f"the mesh axes {axis_names} in their order")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec}: axis {a!r} shards two dims")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate()
            for a in axis_names]


def named(mesh, specs: Any) -> Any:
    """Each spec of a tree as its placements on the torch ``DeviceMesh``
    ``mesh`` (JAX's ``NamedSharding`` over the tree)."""
    names = tuple(mesh.mesh_dim_names)
    return tree.map(lambda s: placements(names, s), specs, is_leaf=is_spec)


def activation_spec(policy: ShardingPolicy) -> Optional[P]:
    """Per-unit boundary constraint for activations [B, S, D] (seq parallel)."""
    if not policy.seq_parallel:
        return None
    return P(policy.batch_axes, policy.tp_axis, None)
