"""Transformer blocks and the loop over stacked layers, as
``repro.models.blocks`` for the dense family.

A dense model's repeating unit is one layer. Layers are initialised one by
one and stacked leaf-wise under ``l0``, the JAX package's ``blocks.l0``
layout (every leaf ``[n_layers, ...]``), so weights cross between the
packages unchanged. (The JAX package's hybrid family repeats a period of
several layers, ``l0``..``l7``; it comes with that family.) A plain Python
loop over the layers takes the place of ``lax.scan``; decode caches are
stacked the same way and updated in place, layer by layer. Each call splits
every stacked leaf once (``torch.unbind``), so under autograd the gradient
of a stack is one ``stack`` of its layers' gradients, not one full-size
zero gradient a layer. With ``rt.remat`` and a gradient wanted, each layer
runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint`` of the scan body): its activations are recomputed in
the backward, kernels included.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import layers as L

# the ROADMAP item that ports each family this slice does not run
_NOT_PORTED = {
    "moe": "ROADMAP 'Next, in order': the moe family (models/moe.py)",
    "ssm": "ROADMAP 'Next, in order': the ssm and hybrid families "
           "(models/ssm.py)",
    "hybrid": "ROADMAP 'Next, in order': the ssm and hybrid families "
              "(models/ssm.py, models/moe.py)",
    "encdec": "ROADMAP 'Next, in order': the encdec and vlm families "
              "(encoder, cross-attention)",
    "vlm": "ROADMAP 'Next, in order': the encdec and vlm families "
           "(patch-prefix prefill)",
}


def check_family(cfg) -> None:
    """Raise for a family whose layers the port does not run yet."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see "
            f"{_NOT_PORTED[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no "
                         f"transformer blocks")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sublayer(generator, cfg, dtype, device):
    """One residual layer: norm1 + attention + norm2 + mlp."""
    return {"norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
            "attn": L.init_attention(generator, cfg, dtype, device),
            "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
            "mlp": L.init_mlp(generator, cfg, dtype, device)}


def init_stacked_units(generator, cfg, dtype, device):
    """``{"l0": layer tree}`` with every leaf stacked over the layers. Each
    layer is drawn in turn and copied into its slot, so the draws need room
    for one layer beside the stack, not for a second stack."""
    check_family(cfg)
    first = _init_sublayer(generator, cfg, dtype, device)
    stacked = tree.map(lambda a: a.new_empty((cfg.n_layers,) + a.shape),
                       first)
    for i in range(cfg.n_layers):
        layer = first if i == 0 else _init_sublayer(generator, cfg, dtype,
                                                    device)
        tree.map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return {"l0": stacked}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, dtype, device):
    """Decode cache, stacked over the layers: ``{"l0": {"k", "v"}}``, each
    ``[n_layers, batch, max_seq, Kv, hd]``."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"l0": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# sublayer / unit application
# ---------------------------------------------------------------------------

def _apply_sublayer(p, x, cfg, *, positions, pos, cache: Optional[dict],
                    causal: bool = True, window: int = 0):
    """One layer; its k/v go into ``cache`` (a layer's slice) in place.
    Returns x."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    attn_cache = None
    if cache is not None:
        attn_cache = {"k": cache["k"], "v": cache["v"], "pos": pos}
    x = x + L.self_attention(p["attn"], h, cfg, positions=positions,
                             causal=causal, window=window, cache=attn_cache)
    h2 = L.apply_norm(cfg.norm, p["norm2"], x)
    return x + L.apply_mlp(p["mlp"], h2, cfg.mlp)


def unstack(stacked, n: int):
    """A tree of ``[n, ...]`` leaves as n trees of its layers' views, one
    ``unbind`` per leaf."""
    leaves, spec = tree.flatten(stacked)
    split = [a.unbind(0) for a in leaves]
    if any(len(s) != n for s in split):
        raise ValueError(f"stacked leaves do not hold {n} layers")
    return [tree.unflatten(spec, [s[i] for s in split]) for i in range(n)]


def scan_units(units_p, x, cfg, rt, *, positions, pos=None, cache=None,
               causal: bool = True, window: int = 0):
    """The stacked layers in order (the JAX package's ``lax.scan``).
    Returns (x, cache): the cache given, updated in place, or None."""
    remat = rt.remat and cache is None and torch.is_grad_enabled()
    for i, layer in enumerate(unstack(units_p["l0"], cfg.n_layers)):
        if remat:
            x = checkpoint(_apply_sublayer, layer, x, cfg,
                           positions=positions, pos=pos, cache=None,
                           causal=causal, window=window,
                           use_reentrant=False)
            continue
        layer_cache = None
        if cache is not None:
            layer_cache = {"k": cache["l0"]["k"][i], "v": cache["l0"]["v"][i]}
        x = _apply_sublayer(layer, x, cfg, positions=positions, pos=pos,
                            cache=layer_cache, causal=causal, window=window)
    return x, cache
