"""The map/reduce compute of JSDoop's distributed SGD (paper §IV.G, Fig. 3).

Port of ``repro/core/mapreduce.py``:

map(version, mb)   = gradient of the mini-batch loss at model version v
reduce(version, *) = mean of the n_mb gradients (sorted by mb_index so the sum
                     order — and hence the floats — are independent of which
                     volunteer computed what, making the paper's Table-4
                     invariance an exact, testable equality), then the RMSprop
                     apply, producing model version v+1.

``TrainingProblem`` packages the model, optimizer, data schedule and compute;
the Initiator and Coordinator consume it. PyTorch runs eagerly, so each step
is the same sequence of kernels every time; on the card the bit-equality with
the sequential references rests on ``repro_torch.device`` keeping every
product's summation order fixed. The batched server applier's flat-carry
methods (``repro/core/mapreduce.py:172-313``) come with a later slice.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as D
from repro_torch import tree
from repro_torch.configs.paper_lstm import (CONFIG as LSTM_CONFIG,
                                            PAPER_PARAMS, TrainParams)
from repro_torch.data.text import TextTask
from repro_torch.models import lstm as LSTM
from repro_torch.optim import Optimizer, dense_bytes, rmsprop


@dataclass
class TrainingProblem:
    cfg: Any                     # ArchConfig (vocab resolved)
    tp: TrainParams
    data: TextTask
    optimizer: Optimizer
    params0: Any
    opt_state0: Any
    device: torch.device

    # ------------------------------------------------------------------ build
    @classmethod
    def paper_problem(cls, *, seed: int = 0, corpus: Optional[str] = None,
                      tp: TrainParams = PAPER_PARAMS,
                      lr: Optional[float] = None,
                      d_model: Optional[int] = None,
                      device=None) -> "TrainingProblem":
        """The paper's problem on ``device`` (the card when None; raises
        when there is none). Params come from a ``torch.Generator`` seeded
        with ``seed``, drawn on the CPU, so they are the same on any device."""
        dev = D.resolve(device)
        data = TextTask.build(corpus, sample_len=tp.sample_len, seed=seed + 99)
        cfg = LSTM_CONFIG.replace(vocab=data.vocab.size)
        if d_model is not None:
            # shrunk variants for overhead-dominated benchmarks (the paper's
            # browser-device regime); same family, same data, fewer cells
            cfg = cfg.replace(d_model=d_model)
        gen = torch.Generator().manual_seed(seed)
        params0 = LSTM.init_lstm_model(gen, cfg, cfg.vocab, dev)
        opt = rmsprop(lr if lr is not None else tp.learning_rate)
        return cls(cfg, tp, data, opt, params0, opt.init(params0), dev)

    # ------------------------------------------------------------------ schedule
    @property
    def n_versions(self) -> int:
        return self.tp.num_epochs * self.tp.batches_per_epoch

    def version_to_epoch_batch(self, version: int) -> Tuple[int, int]:
        return divmod(version, self.tp.batches_per_epoch)

    def minibatch(self, version: int, mb_index: int) -> Dict[str, np.ndarray]:
        e, b = self.version_to_epoch_batch(version)
        return self.data.minibatch(e, b, self.tp.batch_size, mb_index,
                                   self.tp.mini_batch_size)

    def stream_slot(self, i: int) -> Tuple[int, int]:
        """The global mini-batch stream shared by every aggregation policy:
        slot i -> (version, mb_index), wrapping at the problem horizon (a
        LocalSteps tail slot may run past n_versions * n_mb)."""
        n_mb = self.tp.mini_batches_to_accumulate
        return divmod(i % (self.n_versions * n_mb), n_mb)

    # ------------------------------------------------------------------ compute
    # Every compute entry takes tensor or numpy leaves (a message decoded off
    # the wire carries numpy) and moves them to ``self.device`` on entry.

    def loss_and_grads(self, params, batch):
        """(loss tensor, grads tree) of ``lstm_loss`` at ``params`` on a
        numpy batch."""
        leaves, spec = tree.flatten(tree.to_device(params, self.device))
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        b = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        loss = LSTM.lstm_loss(tree.unflatten(spec, leaves), b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree.unflatten(spec, list(grads))

    def map_compute(self, params, version: int, mb_index: int):
        """Returns (grads, loss)."""
        loss, grads = self.loss_and_grads(params,
                                          self.minibatch(version, mb_index))
        return grads, float(loss)

    def reduce_compute(self, params, opt_state, grads_by_mb: Dict[int, Any]):
        """grads_by_mb: mb_index -> grads. Deterministic order via sort."""
        params, opt_state, ordered = tree.to_device(
            (params, opt_state, [grads_by_mb[i] for i in sorted(grads_by_mb)]),
            self.device)
        g_mean = tree.map(lambda *xs: torch.stack(xs).mean(dim=0), *ordered)
        return self.optimizer.update(params, opt_state, g_mean)

    def apply_one(self, params, opt_state, grads):
        """BoundedStaleness commit: apply one (possibly stale) gradient."""
        return self.optimizer.update(
            *tree.to_device((params, opt_state, grads), self.device))

    def local_compute(self, params, opt_state, start: int, k: int):
        """LocalSteps ticket: k local optimizer steps from stream offset
        ``start``. Returns ((delta_params, delta_opt_state), mean_loss)."""
        params, opt_state = tree.to_device((params, opt_state), self.device)
        p0, s0 = params, opt_state
        losses: List[float] = []
        for j in range(k):
            v, mb = self.stream_slot(start + j)
            g, l = self.map_compute(params, v, mb)
            params, opt_state = self.apply_one(params, opt_state, g)
            losses.append(l)
        delta = tree.map(lambda a, b: a - b, (params, opt_state), (p0, s0))
        return delta, float(np.mean(losses))

    def apply_delta(self, params, opt_state, delta, weight: float = 1.0):
        """LocalSteps commit: current blob + weight * delta (dtype-preserving,
        so the int32 optimizer step counter survives a fractional weight)."""
        blob, delta = tree.to_device(((params, opt_state), delta), self.device)
        return tree.map(lambda c, d: (c + weight * d).to(c.dtype), blob, delta)

    # ------------------------------------------------------------------ sizes
    @functools.cached_property
    def grad_bytes(self) -> int:
        return dense_bytes(self.params0)

    @functools.cached_property
    def model_bytes(self) -> int:
        return dense_bytes(self.params0) + dense_bytes(self.opt_state0)

    @functools.cached_property
    def n_params(self) -> int:
        return sum(p.numel() for p in tree.leaves(self.params0))

    def flops_per_map(self) -> float:
        """Analytic cost of one mini-batch fwd+bwd (simulator cost model)."""
        tokens = self.tp.mini_batch_size * self.tp.sample_len
        return 6.0 * self.n_params * tokens

    def flops_per_reduce(self) -> float:
        return 8.0 * self.n_params * self.tp.mini_batches_to_accumulate

    @property
    def cell_launches_per_map(self) -> int:
        """LSTM cell steps (kernel launches on the card) per map compute."""
        return self.cfg.n_layers * self.tp.sample_len


# ---------------------------------------------------------------------------
# sequential references (paper §V.C)
# ---------------------------------------------------------------------------

def sequential_accumulated(problem: TrainingProblem, *, n_versions=None,
                           record_every: int = 1):
    """The distributed algorithm run on one in-process worker (exact reference
    for worker-count invariance: must bit-match any Coordinator run)."""
    params, opt_state = problem.params0, problem.opt_state0
    losses: List[float] = []
    n = n_versions if n_versions is not None else problem.n_versions
    for v in range(n):
        grads_by_mb, ls = {}, []
        for mb in range(problem.tp.mini_batches_to_accumulate):
            g, l = problem.map_compute(params, v, mb)
            grads_by_mb[mb] = g
            ls.append(l)
        params, opt_state = problem.reduce_compute(params, opt_state, grads_by_mb)
        if (v % record_every) == 0:
            losses.append(float(np.mean(ls)))
    return params, opt_state, losses


def sequential_async(problem: TrainingProblem, *, n_updates=None):
    """BoundedStaleness run on ONE worker (every gradient is perfectly
    fresh): plain minibatch SGD over the global mini-batch stream. The exact
    reference for ``Coordinator(policy=BoundedStaleness(...))`` — the
    Coordinator's round-robin scheduler serializes barrierless tickets, so
    ANY worker count must bit-match this."""
    params, opt_state = problem.params0, problem.opt_state0
    n_mb = problem.tp.mini_batches_to_accumulate
    n = n_updates if n_updates is not None else problem.n_versions * n_mb
    losses: List[float] = []
    for i in range(n):
        v, mb = problem.stream_slot(i)
        g, l = problem.map_compute(params, v, mb)
        params, opt_state = problem.apply_one(params, opt_state, g)
        losses.append(l)
    return params, opt_state, losses


def sequential_local(problem: TrainingProblem, *, k: int = 4,
                     weight: float = 1.0, n_updates=None):
    """LocalSteps run on ONE worker: k local optimizer steps per round, the
    round's delta applied through the same ``apply_delta`` the distributed
    commit uses (so a 1-worker Coordinator bit-matches)."""
    params, opt_state = problem.params0, problem.opt_state0
    total = problem.n_versions * problem.tp.mini_batches_to_accumulate
    n = n_updates if n_updates is not None else -(-total // k)
    losses: List[float] = []
    for slot in range(n):
        delta, l = problem.local_compute(params, opt_state, slot * k, k)
        params, opt_state = problem.apply_delta(params, opt_state, delta,
                                                weight)
        losses.append(l)
    return params, opt_state, losses
