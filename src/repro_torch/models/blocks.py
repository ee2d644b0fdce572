"""Transformer and SSM blocks and the loop over stacked units, as
``repro.models.blocks``, for every transformer family.

A *unit* is the repeating parameter structure: one layer for the uniform
families, the whole period (``cfg.hybrid.period`` layers, 8 for Jamba) for
the hybrid one. Its sublayers sit under ``l0``..``l{P-1}``, each leaf
stacked over the units (``[U, ...]``): the JAX package's ``blocks`` layout,
so weights cross between the packages unchanged. A sublayer's mixer
(attention or the Mamba mixer of ``models/ssm.py``) and whether its
feed-forward is moe come from ``cfg.layer_kind(i)`` / ``cfg.layer_is_moe(i)``
of its index ``i`` in the unit. The ssm family's layers have no ``norm2``
and no feed-forward. A plain Python loop over the units takes the place of
``lax.scan``; decode caches are stacked the same way (``{conv, h}`` for an
ssm sublayer, ``{k, v}`` for an attention one) and updated in place, unit
by unit. Each call splits every stacked leaf once (``torch.unbind``), so
under autograd the gradient of a stack is one ``stack`` of its units'
gradients, not one full-size zero gradient a unit. With ``rt.remat`` and a
gradient wanted, each unit runs under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` of the scan body): its activations are
recomputed in the backward, kernels included. A moe layer's feed-forward
is ``models/moe.py`` (with a dense MLP beside it when the config has a
dense residual, as Arctic does); without a cache each moe layer returns its
router's aux loss, which the loop sums (through the checkpoint too). A
cached prefill or decode takes no loss, so it computes none. The encdec
family's decoder layers (drawn with ``cross=True``) add a cross-attention
sublayer (``norm_x``, ``cross``) over the encoder's memory after the mixer,
run wherever the tree holds one; their decode cache holds its projected
k/v (``ck``/``cv``, ``[B, Se, Kv, hd]``), written once by the prefill.
On a mesh (``rt.spmd``, ``distributed/spmd.py``) the stacked leaves arrive
sharded and each unit's are gathered where the unit runs (inside the
checkpoint under remat, so the recompute gathers again), each module by
its plan: a module split over ``model`` gets the rank's shard and runs as
one *part* of its sublayer (the mixer, the cross-attention, the
feed-forward: a moe with its shared experts and any dense residual mlp)
between the layout's entry and exit (``part_in`` / ``part_out``: under
``seq_parallel`` the residual stream is the rank's sequence shard, each
part gathers the norm's output along the sequence and returns its
output's shard). A unit's cache is gathered along its sharded non-batch
dims before the unit (a Mamba state keeps its d_inner shard) and each
rank writes back its own slice after.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg) -> None:
    """Raise for a family without transformer blocks (the LSTM's)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no "
                         f"transformer blocks")


# ---------------------------------------------------------------------------
# sublayer init
# ---------------------------------------------------------------------------

def _init_sublayer(generator, cfg, dtype, device, layer_idx: int, *,
                   cross: bool = False):
    """One residual layer: norm1 + mixer (attention or ssm) (+ norm_x and
    the cross-attention with ``cross``) + norm2 + the feed-forward (an mlp;
    or moe, with an mlp beside it under a dense residual); the ssm family's
    layers stop after the mixer. The layer's
    kind is ``cfg.layer_kind(layer_idx)``, read again where it is applied:
    the tree holds tensors only (the reference's ``"kind"`` marker is
    stripped before stacking)."""
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg.norm, cfg.d_model, dtype,
                                              device)}
    if cfg.layer_kind(layer_idx) == "ssm":
        p["ssm"] = SSM.init_ssm(generator, cfg, dtype, device)
    else:
        p["attn"] = L.init_attention(generator, cfg, dtype, device)
    if cross:
        p["norm_x"] = L.init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = L.init_attention(generator, cfg, dtype, device)
    if cfg.family != "ssm":
        p["norm2"] = L.init_norm(cfg.norm, cfg.d_model, dtype, device)
        if cfg.layer_is_moe(layer_idx):
            p["moe"] = MOE.init_moe(generator, cfg, dtype, device)
            if cfg.moe.dense_residual:
                p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
        else:
            p["mlp"] = L.init_mlp(generator, cfg, dtype, device)
    return p


def unit_size(cfg) -> int:
    return cfg.hybrid.period if cfg.family == "hybrid" else 1


def num_units(cfg) -> int:
    if cfg.n_layers % unit_size(cfg):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"units of {unit_size(cfg)}")
    return cfg.n_layers // unit_size(cfg)


def init_stacked_units(generator, cfg, dtype, device, *,
                       cross: bool = False):
    """``{"l0": ..., "l{P-1}": ...}`` with every leaf stacked over the
    units (with ``cross``, each layer with its cross-attention). Sublayers
    are drawn one at a time, unit by unit, each copied
    into its slot as it is drawn, so the draws need room for one sublayer
    beside the stack: a whole jamba period beside its 52 GB stack would not
    fit one card."""
    check_family(cfg)
    U = num_units(cfg)
    stacked: Dict[str, Any] = {}
    for u in range(U):
        for i in range(unit_size(cfg)):
            key = f"l{i}"
            layer = _init_sublayer(generator, cfg, dtype, device, i,
                                   cross=cross)
            if u == 0:
                stacked[key] = tree.map(
                    lambda a: a.new_empty((U,) + a.shape), layer)
            tree.map(lambda dst, src: dst[u].copy_(src), stacked[key], layer)
            del layer
    return stacked


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_unit_cache(cfg, batch: int, max_seq: int, dtype, device, *,
                    cross_seq: int = 0):
    """Decode cache for one unit: ``{conv, h}`` (``ssm.init_ssm_state``)
    for an ssm sublayer, ``{k, v}`` ``[batch, max_seq, Kv, hd]`` for an
    attention one, and with ``cross_seq`` (an encdec decoder) ``{ck, cv}``
    ``[batch, cross_seq, Kv, hd]`` beside them."""
    def zeros(seq):
        return torch.zeros((batch, seq, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                           device=device)

    cache: Dict[str, Any] = {}
    for i in range(unit_size(cfg)):
        if cfg.layer_kind(i) == "ssm":
            cache[f"l{i}"] = SSM.init_ssm_state(cfg, batch, dtype, device)
        else:
            cache[f"l{i}"] = {"k": zeros(max_seq), "v": zeros(max_seq)}
        if cross_seq:
            cache[f"l{i}"].update(ck=zeros(cross_seq), cv=zeros(cross_seq))
    return cache


def init_cache(cfg, batch: int, max_seq: int, dtype, device, *,
               cross_seq: int = 0):
    """Decode cache, every leaf of ``init_unit_cache`` stacked over the
    units (``[U, ...]``)."""
    check_family(cfg)
    U = num_units(cfg)
    return tree.map(lambda a: a.new_zeros((U,) + a.shape),
                    init_unit_cache(cfg, batch, max_seq, dtype, device,
                                    cross_seq=cross_seq))


# ---------------------------------------------------------------------------
# sublayer / unit application
# ---------------------------------------------------------------------------

def _part(spmd, split, h, fn):
    """``fn`` on a part's input from the normed ``h``, its output back to
    the residual stream (``spmd.Layout.part_in`` / ``part_out``); plain
    off a mesh."""
    if spmd is None:
        return fn(h)
    return spmd.part_out(fn(spmd.part_in(h, split is not None)),
                         split is not None)


def _ffn_split(p, splits):
    """The feed-forward part's split: its moe's and its mlp's, which must
    agree (the part has one exit)."""
    got = {k: splits.get(k) is not None for k in ("moe", "mlp") if k in p}
    if len(set(got.values())) > 1:
        raise ValueError(f"feed-forward modules split unlike: {got}")
    return next((splits[k] for k in ("moe", "mlp") if splits.get(k)), None)


def _apply_sublayer(p, x, cfg, rt, layer_idx: int, *, positions, pos,
                    cache: Optional[dict], memory=None, causal: bool = True,
                    window: int = 0, splits=None):
    """One layer; its new k/v or ssm state go into ``cache`` (a layer's
    slice) in place. A layer with a cross-attention attends to the
    encoder's ``memory`` [B, Se, D]: a prefill (cache and memory) projects
    it once into the cache's ``ck``/``cv`` (cast to the cache's dtype) and
    attends with the uncast k/v, as the JAX package does; a decode step
    reads ``ck``/``cv``; training attends to ``memory`` itself. ``splits``:
    each module's ``spmd.Split`` (or None) on a mesh. Returns (x, aux): aux
    the router's load-balance loss (fp32), None without moe or with a
    cache."""
    spmd, splits = rt.spmd, splits or {}
    h = L.apply_norm(cfg.norm, p["norm1"], x)
    if cfg.layer_kind(layer_idx) == "ssm":
        sp = splits.get("ssm")

        def mixer(hh):
            if cache is None:
                return SSM.apply_ssm(p["ssm"], hh, cfg, split=sp)[0]
            if hh.shape[1] == 1:
                out, st = SSM.apply_ssm_step(p["ssm"], hh, cfg, cache,
                                             split=sp)
            else:
                out, st = SSM.apply_ssm(p["ssm"], hh, cfg, state=cache,
                                        split=sp)
            cache["conv"].copy_(st["conv"])
            cache["h"].copy_(st["h"])
            return out
    else:
        sp = splits.get("attn")
        attn_cache = None
        if cache is not None:
            attn_cache = {"k": cache["k"], "v": cache["v"], "pos": pos}

        def mixer(hh):
            return L.self_attention(p["attn"], hh, cfg, positions=positions,
                                    causal=causal, window=window,
                                    cache=attn_cache, split=sp)
    x = x + _part(spmd, sp, h, mixer)
    if "cross" in p:
        hx = L.apply_norm(cfg.norm, p["norm_x"], x)
        sx = splits.get("cross")

        def cross(hh):
            mem = memory
            if sx is not None and mem is not None:
                mem = spmd.enter(mem)
            if cache is not None and mem is not None:
                _, ck, cv = L.attention_qkv(p["cross"], hh, xkv=mem,
                                            split=sx)
                ck, cv = L.whole_kv(ck, sx), L.whole_kv(cv, sx)
                cache["ck"].copy_(ck)
                cache["cv"].copy_(cv)
                return L.cross_attention(p["cross"], hh, mem_kv=(ck, cv),
                                         split=sx)
            if cache is not None:
                return L.cross_attention(p["cross"], hh, split=sx,
                                         mem_kv=(cache["ck"], cache["cv"]))
            return L.cross_attention(p["cross"], hh, memory=mem, split=sx)
        x = x + _part(spmd, sx, hx, cross)
    if "norm2" not in p:
        return x, None
    h2 = L.apply_norm(cfg.norm, p["norm2"], x)
    sf = _ffn_split(p, splits)
    aux = None

    def ffn(hh):
        nonlocal aux
        y = None
        if "moe" in p:
            y, aux = MOE.apply_moe(p["moe"], hh, cfg, rt,
                                   with_aux=cache is None,
                                   split=splits.get("moe"))
        if "mlp" in p:
            ym = L.apply_mlp(p["mlp"], hh, cfg.mlp)
            y = ym if y is None else y + ym
        return y
    return x + _part(spmd, sf, h2, ffn), aux


def apply_unit(up, x, cfg, rt, *, positions, pos, cache=None, memory=None,
               causal: bool = True, window: int = 0):
    """One unit's sublayers in order. Returns (x, cache, aux): the unit's
    cache given, updated in place, or None; aux the sublayers' router
    losses summed, None without any. On a mesh ``up``'s sharded leaves are
    gathered here, at use, each module by its plan."""
    splits = {}
    if rt.spmd is not None:
        gathered = {}
        for key, sub in up.items():
            gathered[key], splits[key] = rt.spmd.modules_at_use(sub)
        up = gathered
    aux = None
    for i in range(unit_size(cfg)):
        key = f"l{i}"
        x, a = _apply_sublayer(up[key], x, cfg, rt, i, positions=positions,
                               pos=pos,
                               cache=None if cache is None else cache[key],
                               memory=memory, causal=causal, window=window,
                               splits=splits.get(key))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, cache, aux


def unstack(stacked, n: int):
    """A tree of ``[n, ...]`` leaves as n trees of its units' views, one
    ``unbind`` per leaf."""
    leaves, spec = tree.flatten(stacked)
    split = [a.unbind(0) for a in leaves]
    if any(len(s) != n for s in split):
        raise ValueError(f"stacked leaves do not hold {n} units")
    return [tree.unflatten(spec, [s[i] for s in split]) for i in range(n)]


def scan_units(units_p, x, cfg, rt, *, positions, pos=None, cache=None,
               memory=None, causal: bool = True, window: int = 0):
    """The stacked units in order (the JAX package's ``lax.scan``).
    ``memory``: the encoder's output, which the encdec decoder's
    cross-attention reads (under remat it enters each checkpoint as an
    argument, so its gradient reaches the encoder). Returns (x, cache,
    aux): the cache given, updated in place, or None; aux the units' router
    losses summed (fp32), None without moe layers or with a cache."""
    remat = rt.remat and cache is None and torch.is_grad_enabled()
    aux = None
    for u, unit in enumerate(unstack(units_p, num_units(cfg))):
        if remat:
            x, _, a = checkpoint(apply_unit, unit, x, cfg, rt,
                                 positions=positions, pos=pos, cache=None,
                                 memory=memory, causal=causal, window=window,
                                 use_reentrant=False)
        else:
            unit_cache = full = None
            if cache is not None:
                unit_cache = tree.map(lambda c: c[u], cache)
                full = unit_cache if rt.spmd is None else \
                    rt.spmd.open_cache(unit_cache)
            x, _, a = apply_unit(unit, x, cfg, rt, positions=positions,
                                 pos=pos, cache=full, memory=memory,
                                 causal=causal, window=window)
            if full is not unit_cache:
                rt.spmd.close_cache(unit_cache, full)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, cache, aux
