"""The training step on one card: the paper's map/reduce schedule, as
``repro.distributed.steps.make_train_step`` computes it.

``train_step`` is JSDoop's Fig. 3 as one call:

  map task    -> one microbatch gradient (a forward and a backward of
                 ``models.model.loss_fn``),
  the MapResultsQueue -> an fp32 accumulator that sums the microbatch
                 gradients (``a + g.float()``), each freed once added,
  reduce task -> one mean over the microbatches and one optimizer update,
                 publishing "model version v+1" = the returned params.

Weights are not updated until every microbatch gradient of the global batch
is accumulated, so the model does not depend on how many microbatches
("volunteers") computed it (paper Table 4): the reference's
``test_grad_accumulation_invariance``. With one microbatch the raw
gradients, in the parameters' dtype, go to the optimizer, as in the
reference.

The JAX package binds the step under ``jax.jit`` on a device mesh with
sharded parameters; here there is no mesh (one card, or the CPU where the
tensors lie), so ``bind_train`` takes none. Sharding over several cards,
``bind_prefill`` and ``bind_decode`` come with ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M


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


def make_train_step(cfg, rt, optimizer, shape, policy: SH.ShardingPolicy,
                    *, num_microbatches: int = 0):
    """Returns (train_step, grads_fn, n_micro).
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``grads_fn(params, batch) -> (grads, metrics)``, the
    gradients the step hands to the optimizer (the accumulated mean, or the
    raw gradients for one microbatch)."""
    n_micro = _microbatch_count(shape, policy, num_microbatches)

    def micro_grads(leaves, spec, mb):
        ps = [p.detach().requires_grad_() for p in leaves]
        loss, mets = M.loss_fn(tree.unflatten(spec, ps), cfg, rt, mb)
        grads = torch.autograd.grad(loss, ps)
        return list(grads), loss.detach(), {k: v.detach()
                                            for k, v in mets.items()}

    def grads_fn(params, batch):
        leaves, spec = tree.flatten(params)
        if n_micro == 1:
            grads, loss, mets = micro_grads(leaves, spec, batch)
        else:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves]
            losses, metss = [], []
            for i in range(n_micro):
                mb = {k: v.chunk(n_micro, dim=0)[i] for k, v in batch.items()}
                g, loss_i, mets_i = micro_grads(leaves, spec, mb)
                for a, gi in zip(gsum, g):
                    a.add_(gi.float())
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
        return tree.unflatten(spec, grads), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        new_p, new_s = optimizer.update(params, opt_state, grads)
        return new_p, new_s, metrics

    return train_step, grads_fn, n_micro


def bind_train(cfg, rt, optimizer, shape, *, num_microbatches: int = 0):
    """The train step and what a caller needs to feed it, as the JAX
    ``bind_train`` returns them (without a mesh: no shardings; the policy
    is one card's, so the JAX ``policy=`` argument waits for the mesh).

    Returns dict(step, grads, batch_shape, n_micro, policy)."""
    policy = SH.ShardingPolicy()
    step, grads_fn, n_micro = make_train_step(
        cfg, rt, optimizer, shape, policy, num_microbatches=num_microbatches)
    return dict(step=step, grads=grads_fn,
                batch_shape=M.train_batch_spec(cfg, shape), n_micro=n_micro,
                policy=policy)
