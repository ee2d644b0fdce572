"""Optimizers as pure functions over trees of tensors (no ``torch.optim``).

Port of ``repro/optim/optimizers.py``'s RMSprop, which follows TF/Keras
semantics exactly — the paper trains with tfjs's
``train.rmsprop(learningRate=0.1)`` defaults (rho=0.9, eps=1e-7, no momentum):

    ms <- rho * ms + (1 - rho) * g^2
    w  <- w - lr * g / (sqrt(ms) + eps)

Note Keras adds eps *outside* the sqrt; we match that (it matters at lr=0.1).
The state layout is the JAX package's, ``{"ms": tree, "step": int32 scalar}``,
so state carries across the bridge both ways. Updates return new tensors and
never write into their inputs: the DataServer may still hold them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree

Params = Any
State = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], State]
    update: Callable[[Params, State, Params], Tuple[Params, State]]
    name: str = "opt"


def rmsprop(lr: float, rho: float = 0.9, eps: float = 1e-7,
            state_dtype=torch.float32) -> Optimizer:
    def init(params):
        leaves = tree.leaves(params)
        device = leaves[0].device if leaves else "cpu"
        return {"ms": tree.map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                                     device=p.device), params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update(params, state, grads):
        ps, spec = tree.flatten(params)
        new_p, new_m = [], []
        for p, m, g in zip(ps, tree.leaves(state["ms"]), tree.leaves(grads),
                           strict=True):
            g32 = g.to(state_dtype)
            m_new = rho * m + (1.0 - rho) * torch.square(g32)
            step = p.to(state_dtype) - lr * g32 / (torch.sqrt(m_new) + eps)
            new_p.append(step.to(p.dtype))
            new_m.append(m_new)
        return tree.unflatten(spec, new_p), {"ms": tree.unflatten(spec, new_m),
                                             "step": state["step"] + 1}

    return Optimizer(init, update, f"rmsprop(lr={lr})")


def dense_bytes(t) -> int:
    """Bytes of a dense tree (the wire size of an uncompressed gradient)."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))
