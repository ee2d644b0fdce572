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

``sgd`` (with and without momentum, state ``{"mu", "step"}`` or
``{"step"}``) and ``adamw`` (state ``{"m", "v", "step"}``) are the JAX
package's too, for the transformer training path; ``make`` picks one by
name. Every state tensor is ``state_dtype`` (fp32); an update is computed
in it and cast to the parameter's dtype.
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


def _zeros(params, state_dtype):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                          device=p.device), params)


def _step0(params):
    leaves = tree.leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else "cpu")


def sgd(lr: float, momentum: float = 0.0,
        state_dtype=torch.float32) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"mu": _zeros(params, state_dtype), "step": _step0(params)}

    def update(params, state, grads):
        ps, spec = tree.flatten(params)
        gs = tree.leaves(grads)
        if momentum == 0.0:
            new_p = [(p.float() - lr * g.float()).to(p.dtype)
                     for p, g in zip(ps, gs, strict=True)]
            return tree.unflatten(spec, new_p), {"step": state["step"] + 1}
        new_p, new_mu = [], []
        for p, mu, g in zip(ps, tree.leaves(state["mu"]), gs, strict=True):
            mu_new = momentum * mu + g.to(state_dtype)
            new_p.append((p.to(state_dtype) - lr * mu_new).to(p.dtype))
            new_mu.append(mu_new)
        return tree.unflatten(spec, new_p), {
            "mu": tree.unflatten(spec, new_mu), "step": state["step"] + 1}

    return Optimizer(init, update, f"sgd(lr={lr},m={momentum})")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"m": _zeros(params, state_dtype),
                "v": _zeros(params, state_dtype), "step": _step0(params)}

    def update(params, state, grads):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        ps, spec = tree.flatten(params)
        new_p, new_m, new_v = [], [], []
        for p, m, v, g in zip(ps, tree.leaves(state["m"]),
                              tree.leaves(state["v"]), tree.leaves(grads),
                              strict=True):
            g32 = g.to(state_dtype)
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p32 = p.to(state_dtype)
            new_p.append((p32 - lr * (upd + weight_decay * p32)).to(p.dtype))
            new_m.append(m_new)
            new_v.append(v_new)
        return tree.unflatten(spec, new_p), {
            "m": tree.unflatten(spec, new_m),
            "v": tree.unflatten(spec, new_v), "step": step}

    return Optimizer(init, update, f"adamw(lr={lr})")


REGISTRY = {"rmsprop": rmsprop, "sgd": sgd, "adamw": adamw}


def make(name: str, lr: float, **kw) -> Optimizer:
    return REGISTRY[name](lr, **kw)


def dense_bytes(t) -> int:
    """Bytes of a dense tree (the wire size of an uncompressed gradient)."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))
