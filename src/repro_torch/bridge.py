"""Carry parameters and optimizer state across from the JAX package.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of each leaf),
so this module never imports JAX. The layout is the same on both sides:
LSTM kernel ``[Din+H, 4H]`` in Keras gate order i,f,g,o, bias ``[4H]``, head
``w [H, V]`` and ``b [V]``; RMSprop state ``{"ms": tree, "step": int32}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


def _to_tensor(a, device) -> torch.Tensor:
    # np.array copies: the tensor never aliases the caller's buffer
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree_of_numpy, device) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's tensors."""
    return tree.map(lambda a: _to_tensor(a, device), tree_of_numpy)


def opt_state_from_jax(state_of_numpy, device) -> dict:
    """JAX RMSprop state ``{"ms": tree, "step": int32 scalar}`` as tensors."""
    step = np.asarray(state_of_numpy["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"opt state step must be an int32 scalar, got "
                         f"{step.dtype}{list(step.shape)}")
    return {"ms": params_from_jax(state_of_numpy["ms"], device),
            "step": _to_tensor(step, device)}


def to_numpy(tree_of_tensors):
    """The other way: any tree of tensors as numpy arrays on the host."""
    return tree.map(lambda t: t.detach().cpu().numpy(), tree_of_tensors)
