"""Transformer blocks and the loop over stacked layers, as
``repro.models.blocks`` for the dense and moe families.

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
the backward, kernels included. A moe layer's feed-forward is
``models/moe.py`` (with a dense MLP beside it when the config has a dense
residual, as Arctic does); without a cache each layer returns its router's
aux loss, which the loop sums (through the checkpoint too). A cached
prefill or decode takes no loss, so it computes none.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

# the ROADMAP item that ports each family the port does not run yet
_NOT_PORTED = {
    "ssm": "ROADMAP Queue 1 item 7: the ssm and hybrid families "
           "(models/ssm.py)",
    "hybrid": "ROADMAP Queue 1 item 7: the ssm and hybrid families "
              "(models/ssm.py, the hybrid period)",
    "encdec": "ROADMAP Queue 1 item 8: the encdec and vlm families "
              "(encoder, cross-attention)",
    "vlm": "ROADMAP Queue 1 item 8: the encdec and vlm families "
           "(patch-prefix prefill)",
}
_PORTED = ("dense", "moe")


def check_family(cfg) -> None:
    """Raise for a family whose layers the port does not run yet."""
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see "
            f"{_NOT_PORTED[cfg.family]}")
    if cfg.family not in _PORTED:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no "
                         f"transformer blocks")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sublayer(generator, cfg, dtype, device):
    """One residual layer: norm1 + attention + norm2 + the feed-forward (an
    mlp; or moe, with an mlp beside it under a dense residual). Every layer
    is layer 0 of its one-layer unit, as in the JAX package's scan."""
    p = {"norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
         "attn": L.init_attention(generator, cfg, dtype, device),
         "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if cfg.layer_is_moe(0):
        p["moe"] = MOE.init_moe(generator, cfg, dtype, device)
        if cfg.moe.dense_residual:
            p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
    return p


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

def _apply_sublayer(p, x, cfg, rt, *, positions, pos,
                    cache: Optional[dict], causal: bool = True,
                    window: int = 0):
    """One layer; its k/v go into ``cache`` (a layer's slice) in place.
    Returns (x, aux): aux the router's load-balance loss (fp32), None
    without moe or with a cache."""
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    attn_cache = None
    if cache is not None:
        attn_cache = {"k": cache["k"], "v": cache["v"], "pos": pos}
    x = x + L.self_attention(p["attn"], h, cfg, positions=positions,
                             causal=causal, window=window, cache=attn_cache)
    h2 = L.apply_norm(cfg.norm, p["norm2"], x)
    aux = y = None
    if "moe" in p:
        y, aux = MOE.apply_moe(p["moe"], h2, cfg, rt,
                               with_aux=cache is None)
    if "mlp" in p:
        ym = L.apply_mlp(p["mlp"], h2, cfg.mlp)
        y = ym if y is None else y + ym
    return x + y, aux


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
    Returns (x, cache, aux): the cache given, updated in place, or None;
    aux the layers' router losses summed (fp32), None without moe layers
    or with a cache."""
    remat = rt.remat and cache is None and torch.is_grad_enabled()
    aux = None
    for i, layer in enumerate(unstack(units_p["l0"], cfg.n_layers)):
        if remat:
            x, a = checkpoint(_apply_sublayer, layer, x, cfg, rt,
                              positions=positions, pos=pos, cache=None,
                              causal=causal, window=window,
                              use_reentrant=False)
        else:
            layer_cache = None
            if cache is not None:
                layer_cache = {"k": cache["l0"]["k"][i],
                               "v": cache["l0"]["v"][i]}
            x, a = _apply_sublayer(layer, x, cfg, rt, positions=positions,
                                   pos=pos, cache=layer_cache, causal=causal,
                                   window=window)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, cache, aux
