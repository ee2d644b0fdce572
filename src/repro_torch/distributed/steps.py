"""The port's steps bound to a mesh: the paper's map/reduce schedule, as
``repro.distributed.steps`` computes it.

``train_step`` is JSDoop's Fig. 3 as one call:

  map task    -> one microbatch gradient (a forward and a backward of
                 ``models.model.loss_fn``),
  the MapResultsQueue -> an accumulator in ``policy.grad_accum_dtype``
                 (fp32 by default, bf16 halves it) that sums the
                 microbatch gradients, each freed once added,
  reduce task -> one mean over the microbatches and one optimizer update,
                 publishing "model version v+1" = the returned params.

Weights are not updated until every microbatch gradient of the global batch
is accumulated, so the model does not depend on how many microbatches
("volunteers") computed it (paper Table 4): the reference's
``test_grad_accumulation_invariance``. With one microbatch the raw
gradients, in the parameters' dtype, go to the optimizer, as in the
reference. Microbatch i is the global rows ``[i*B/n, (i+1)*B/n)``, n from
``_microbatch_count``'s per-device rule.

The binders take a mesh (``launch/mesh.py``), as the JAX package's bind
their steps to one under ``jax.jit``:

- one device's host mesh (an ``AbstractMesh`` (1, 1) with its device; no
  process group): the steps run the model on plain tensors, with no
  collective;
- a torch ``DeviceMesh``: the steps run through ``distributed/spmd.py``.
  Parameters, optimizer slots and caches are stored as the DTensors of
  their specs (``spmd.put``; a step given plain full tensors places them
  first, as ``jit``'s ``in_shardings`` would); each rank computes its rows
  of each microbatch or serving batch; each gathered leaf's gradient is
  summed over the batch axes into its shard, then divided by the batch
  axes' size (the mean over the global rows); the optimizer updates each
  rank's shards, its slots mirroring their weight's spec; the metrics are
  averaged over the batch axes; a serving step hands every rank the global
  logits. Each module whose spec splits it over ``model`` computes the
  rank's shard (``spmd.plan``: heads, FFN columns, experts, d_inner,
  vocab) between Megatron's entry and exit.

A policy's ``seq_parallel`` (as in the JAX package, the training step's
alone: prefill and decode ignore it) keeps the residual stream between
sublayers, the remat carry, as the rank's sequence shard over ``model``
(``SH.activation_spec``): each sublayer normalizes its shard, gathers the
norm's output once at entry and reduce-scatters its output at exit. A
sequence that ``model`` does not divide raises ``ValueError`` at binding.

With ``donate`` (the default, as in the JAX package) the training step
empties the params and opt_state trees it is given and releases each
leaf's old value once its new one is written: use the trees it returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd as SP
from repro_torch.distributed.sharding import P
from repro_torch.models import model as M

_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _microbatch_count(shape, policy: SH.ShardingPolicy,
                      requested: int = 0) -> int:
    """Paper Table 3 wants 16 accumulation steps per batch; the microbatch
    must tile the per-device batch, so take the largest feasible count <=
    requested (default 16)."""
    want = requested or 16
    dp = policy.size(policy.batch_axes)
    per_device = max(shape.global_batch // dp, 1)
    n = min(want, per_device)
    while per_device % n:
        n -= 1
    return max(n, 1)


def _layout(mesh, policy: SH.ShardingPolicy, split_batch: bool,
            seq_parallel: bool = False):
    """The ``spmd.Layout`` a step on ``mesh`` runs through (its residual
    stream sequence-sharded with ``seq_parallel``); None on one device's
    host mesh."""
    if SP.is_device_mesh(mesh):
        return SP.Layout(mesh, policy, split_batch=split_batch,
                         seq_parallel=seq_parallel)
    if getattr(mesh, "device", None) is None or any(
            s != 1 for s in mesh.shape):
        raise ValueError(f"{mesh}: an abstract mesh sizes specs and runs no "
                         f"step; bind to a DeviceMesh or make_host_mesh()")
    return None


def _on(rt, layout):
    return rt if layout is None else dataclasses.replace(rt, spmd=layout)


def _release(t) -> None:
    """Empty every container of a tree (the donated inputs)."""
    if isinstance(t, dict):
        for v in t.values():
            _release(v)
        t.clear()
    elif isinstance(t, list):
        for v in t:
            _release(v)
        t.clear()


def make_train_step(cfg, rt, optimizer, shape, policy: SH.ShardingPolicy,
                    *, num_microbatches: int = 0, layout=None,
                    param_specs: Any = None, donate: bool = True):
    """Returns (train_step, grads_fn, n_micro).
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``grads_fn(params, batch) -> (grads, metrics)``, the
    gradients the step hands to the optimizer (the accumulated mean, or the
    raw gradients for one microbatch). ``layout``: a ``DeviceMesh``'s
    (``param_specs`` then gives each leaf's spec), or None for plain
    tensors on one device."""
    n_micro = _microbatch_count(shape, policy, num_microbatches)
    acc_dt = _ACC_DTYPES[policy.grad_accum_dtype]
    rt = _on(rt, layout)
    specs = None if layout is None else tree.leaves(param_specs,
                                                    is_leaf=SH.is_spec)

    def locals_(stored):
        """A stored tree's leaves as this rank's local tensors."""
        if layout is None:
            return tree.leaves(stored)
        return [SP.local_of(t) for t in
                tree.leaves(SP.put(layout.mesh, stored, param_specs))]

    def stored(skel, leaves, spec_tree):
        out = tree.unflatten(skel, leaves)
        return out if layout is None else layout.stored(out, spec_tree)

    def micro_grads(shards, skel, mb):
        ps = [p.detach().requires_grad_() for p in shards]
        if layout is None:
            model_p = tree.unflatten(skel, ps)
        else:
            model_p = tree.unflatten(skel, [SP.Sharded(p, s, layout)
                                            for p, s in zip(ps, specs)])
        loss, mets = M.loss_fn(model_p, cfg, rt, mb)
        grads = list(torch.autograd.grad(loss, ps))
        if layout is not None and layout.dp > 1:
            grads = [g.div_(layout.dp) for g in grads]
        return grads, loss.detach(), {k: v.detach() for k, v in mets.items()}

    def grads_of(shards, skel, batch):
        if n_micro == 1:
            mb = batch if layout is None else \
                {k: layout.rows(v) for k, v in batch.items()}
            grads, loss, mets = micro_grads(shards, skel, mb)
        else:
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                    for p in shards]
            losses, metss = [], []
            for i in range(n_micro):
                mb = {k: v.chunk(n_micro, dim=0)[i] for k, v in batch.items()}
                if layout is not None:
                    mb = {k: layout.rows(v) for k, v in mb.items()}
                g, loss_i, mets_i = micro_grads(shards, skel, mb)
                for a, gi in zip(gsum, g):
                    a.add_(gi.to(acc_dt))
                del g
                losses.append(loss_i)
                metss.append(mets_i)
            # in place: the mean needs no second accumulator's memory
            grads = [a.div_(n_micro).float() for a in gsum]
            del gsum
            loss = torch.stack(losses).mean()
            mets = {k: torch.stack([m[k] for m in metss]).mean()
                    for k in metss[0]}
        metrics = {"loss": loss.float(), **mets}
        if layout is not None:
            metrics = layout.mean(metrics)
            metrics = {k: metrics[k] for k in ("loss", *mets)}
        return grads, metrics

    def grads_fn(params, batch):
        skel = tree.map(lambda _: None, params)
        grads, metrics = grads_of(locals_(params), skel, batch)
        return stored(skel, grads, param_specs), metrics

    def train_step(params, opt_state, batch):
        skel = tree.map(lambda _: None, params)
        p_loc = locals_(params)
        slots = {k: locals_(v) for k, v in opt_state.items() if k != "step"}
        step = SP.local_of(opt_state["step"])
        keys = list(opt_state)
        if donate:
            _release(params)
            _release(opt_state)
        grads, metrics = grads_of(p_loc, skel, batch)
        new_p, new_slots, new_step = [], {k: [] for k in slots}, None
        for i in range(len(p_loc)):
            state = {k: [slots[k][i]] for k in slots}
            state["step"] = step
            (p_new,), s_new = optimizer.update([p_loc[i]], state, [grads[i]])
            new_p.append(p_new)
            for k in slots:
                new_slots[k].append(s_new[k][0])
            new_step = s_new["step"]
            grads[i] = None
            if donate:
                p_loc[i] = None
                for k in slots:
                    slots[k][i] = None
        out_state = {}
        for k in keys:
            if k == "step":
                out_state[k] = new_step if layout is None else \
                    layout.stored([new_step], [P()])[0]
            else:
                out_state[k] = stored(skel, new_slots[k], param_specs)
        return stored(skel, new_p, param_specs), out_state, metrics

    return train_step, grads_fn, n_micro


def _serve_call(layout, param_specs, fn, params, cache):
    """``fn(params, cache) -> logits`` on a mesh: the params and the cache
    (its specs from its own shape, ``SH.cache_specs``) as ``Sharded``
    leaves, the logits gathered over the batch axes, the cache stored
    back as DTensors."""
    cspecs = SH.cache_specs(cache, layout.policy)
    c = layout.sharded(cache, cspecs)
    logits = fn(layout.sharded(params, param_specs), c)
    return layout.gather_rows(logits), layout.stored(
        tree.map(lambda s: s.local, c), cspecs)


def make_decode_step(cfg, rt, *, layout=None, param_specs: Any = None):
    """serve_step: ONE new token against a KV/SSM cache of seq_len.
    ``decode_step(params, cache, token [B], pos) -> (logits [B, V],
    cache)``; on a mesh every rank gets the global logits."""
    rt = _on(rt, layout)

    def decode_step(params, cache, token, pos):
        if layout is None:
            return M.decode_step(params, cfg, rt, token, cache, pos)
        return _serve_call(
            layout, param_specs,
            lambda p, c: M.decode_step(p, cfg, rt, layout.rows(token), c,
                                       pos)[0], params, cache)

    return decode_step


def make_prefill_step(cfg, rt, *, layout=None, param_specs: Any = None):
    """``prefill_step(params, batch, cache) -> (last-token logits [B, V],
    cache)``; on a mesh every rank gets the global logits."""
    rt = _on(rt, layout)

    def prefill_step(params, batch, cache):
        if layout is None:
            return M.prefill(params, cfg, rt, batch, cache)
        rows = {k: layout.rows(v) for k, v in batch.items()}
        return _serve_call(
            layout, param_specs,
            lambda p, c: M.prefill(p, cfg, rt, rows, c)[0], params, cache)

    return prefill_step


# ---------------------------------------------------------------------------
# binding with the sharding policy
# ---------------------------------------------------------------------------

def _splits(global_batch: int, policy: SH.ShardingPolicy) -> bool:
    return global_batch % policy.size(policy.batch_axes) == 0


def bind_train(mesh, cfg, rt, optimizer, shape, *,
               policy: Optional[SH.ShardingPolicy] = None,
               num_microbatches: int = 0, donate: bool = True):
    """The train step plus every spec needed to call it.

    Returns dict(step, grads, param_specs, opt_specs, batch_specs,
    params_shape, opt_shape, batch_shape, n_micro, policy): the shapes are
    meta tensors and ``models.model.Spec``s (nothing allocated)."""
    policy = policy or SH.ShardingPolicy.for_mesh(mesh)
    pshape = M.init_params(cfg, None, "meta")
    pspecs = SH.param_specs(pshape, policy)
    oshape = optimizer.init(pshape)
    ospecs = SH.opt_state_specs(oshape, pspecs)
    bshape = M.train_batch_spec(cfg, shape)
    bspecs = SH.batch_specs(bshape, policy)
    if policy.seq_parallel:
        _check_seq(cfg, shape, policy)
    layout = _layout(mesh, policy, _splits(shape.global_batch, policy),
                     policy.seq_parallel)
    step, grads_fn, n_micro = make_train_step(
        cfg, rt, optimizer, shape, policy, num_microbatches=num_microbatches,
        layout=layout, param_specs=pspecs, donate=donate)
    return dict(step=step, grads=grads_fn, param_specs=pspecs,
                opt_specs=ospecs, batch_specs=bspecs, params_shape=pshape,
                opt_shape=oshape, batch_shape=bshape, n_micro=n_micro,
                policy=policy)


def _check_seq(cfg, shape, policy: SH.ShardingPolicy) -> None:
    """Raise unless ``model`` divides every sequence a ``seq_parallel``
    step shards: the tokens' (with a vlm's patches) and an encdec
    encoder's frames."""
    m = policy.tp_size
    seqs = {"sequence": shape.seq_len}
    if cfg.family == "encdec":
        seqs["encoder sequence"] = cfg.encoder_seq
    for what, n in seqs.items():
        if n % m:
            raise ValueError(f"seq_parallel: a {what} of {n} does not split "
                             f"over {policy.tp_axis} ({m})")


def _serving(mesh, cfg, shape, policy):
    policy = policy or SH.ShardingPolicy.for_mesh(mesh)
    pshape = M.init_params(cfg, None, "meta")
    cshape = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")
    split = _splits(shape.global_batch, policy)
    return (policy, pshape, SH.param_specs(pshape, policy), cshape,
            SH.cache_specs(cshape, policy), split,
            _layout(mesh, policy, split))


def bind_decode(mesh, cfg, rt, shape, *,
                policy: Optional[SH.ShardingPolicy] = None):
    """The decode step + specs. Cache length = shape.seq_len.
    ``token_spec`` places the tokens it takes, ``logit_spec`` the rows of
    the logits each rank computes."""
    policy, pshape, pspecs, cshape, cspecs, split, layout = _serving(
        mesh, cfg, shape, policy)
    tok_spec = P(policy.batch_axes) if split else P(None)
    step = make_decode_step(cfg, rt, layout=layout, param_specs=pspecs)
    tok_shape, pos_shape = M.decode_spec(cfg, shape)
    return dict(step=step, param_specs=pspecs, cache_specs=cspecs,
                params_shape=pshape, cache_shape=cshape,
                token_shape=tok_shape, pos_shape=pos_shape,
                token_spec=tok_spec,
                logit_spec=P(policy.batch_axes, None) if split else P(),
                policy=policy)


def bind_prefill(mesh, cfg, rt, shape, *,
                 policy: Optional[SH.ShardingPolicy] = None):
    """The prefill over the prompt, writing cache positions [0, seq_len).
    ``cache_specs`` are for a cache of seq_len; a step takes any cache
    (a caller that decodes after the prompt passes the decode's, as the
    JAX package's serve does) and shards it by its own shape's specs."""
    policy, pshape, pspecs, cshape, cspecs, split, layout = _serving(
        mesh, cfg, shape, policy)
    bshape = prefill_batch_spec(cfg, shape)
    step = make_prefill_step(cfg, rt, layout=layout, param_specs=pspecs)
    return dict(step=step, param_specs=pspecs, cache_specs=cspecs,
                batch_specs=SH.batch_specs(bshape, policy),
                params_shape=pshape, cache_shape=cshape, batch_shape=bshape,
                logit_spec=P(policy.batch_axes, None) if split
                else P(None, None), policy=policy)


def prefill_batch_spec(cfg, shape) -> Dict[str, M.Spec]:
    """Prompt batch: seq_len tokens (no +1 label shift)."""
    Bsz, S = shape.global_batch, shape.seq_len
    dt = M.dtype_of(cfg)
    if cfg.family == "encdec":
        return {"frames": M.Spec((Bsz, cfg.encoder_seq, cfg.d_model), dt),
                "tokens": M.Spec((Bsz, S), torch.int32)}
    if cfg.family == "vlm":
        St = S - cfg.vision_prefix
        return {"patches": M.Spec((Bsz, cfg.vision_prefix, cfg.d_model), dt),
                "tokens": M.Spec((Bsz, St), torch.int32)}
    return {"tokens": M.Spec((Bsz, S), torch.int32)}
