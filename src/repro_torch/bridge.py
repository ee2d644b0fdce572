"""Carry parameters and optimizer state across from the JAX package.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of each leaf),
so this module never imports JAX. The layout is the same on both sides:
LSTM kernel ``[Din+H, 4H]`` in Keras gate order i,f,g,o, bias ``[4H]``, head
``w [H, V]`` and ``b [V]``; optimizer state ``{"ms": tree, "step": int32}``
(RMSprop), ``{"m", "v", "step"}`` (AdamW), ``{"mu", "step"}`` or
``{"step"}`` (SGD with and without momentum);
a transformer's ``{"embed", "blocks": {"l0": ..., "l{P-1}": ...},
"final_norm", "unembed"}`` with every leaf in the JAX shape, each of a
unit's sublayers stacked over the units (one layer a unit, the 8-layer
period for the hybrid family), and each leaf in its own dtype: an ssm
layer's ``dt_bias``, ``A_log`` and ``Dskip`` and a moe layer's router stay
fp32 inside a bf16 tree. An encdec model has ``"encoder"`` (``l0``:
``norm1``, ``attn``, ``norm2``, ``mlp``), ``"enc_norm"`` and ``"decoder"``
(``l0``: ``norm1``, ``attn``, ``norm_x``, ``cross``, ``norm2``, ``mlp``) in
place of ``"blocks"``, and ties its embeddings (no ``"unembed"``).

A bfloat16 leaf (numpy's ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses) crosses as its raw 16-bit words, bit for bit, as
``checkpoint/serialize.py`` ships it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


_BF16 = "bfloat16"


def _to_tensor(a, device) -> torch.Tensor:
    # np.array copies: the tensor never aliases the caller's buffer
    a = np.array(a)
    if a.dtype.name == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes           # only a caller that wants bf16 numpy
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree_of_numpy, device) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's tensors."""
    return tree.map(lambda a: _to_tensor(a, device), tree_of_numpy)


_STATE_TREES = {"ms", "m", "v", "mu"}


def opt_state_from_jax(state_of_numpy, device) -> dict:
    """JAX optimizer state (RMSprop ``{"ms", "step"}``, AdamW ``{"m", "v",
    "step"}``, SGD ``{"mu", "step"}`` or ``{"step"}``; ``step`` an int32
    scalar) as tensors."""
    step = np.asarray(state_of_numpy["step"])
    if step.dtype != np.int32 or step.shape != ():
        raise ValueError(f"opt state step must be an int32 scalar, got "
                         f"{step.dtype}{list(step.shape)}")
    other = set(state_of_numpy) - _STATE_TREES - {"step"}
    if other:
        raise ValueError(f"opt state has keys {sorted(other)} that no "
                         f"optimizer of the port keeps")
    out = {k: params_from_jax(state_of_numpy[k], device)
           for k in state_of_numpy if k in _STATE_TREES}
    out["step"] = _to_tensor(step, device)
    return out


def to_numpy(tree_of_tensors):
    """The other way: any tree of tensors as numpy arrays on the host
    (bfloat16 as ``ml_dtypes.bfloat16``, bit for bit)."""
    return tree.map(_to_numpy, tree_of_tensors)
