"""Top-level model API of the dense and moe transformer families, as
``repro.models.model``: init, forward, the training loss, prefill and
decode, batch specs and the parameter count.

Batch convention (integer tokens): ``{"tokens": [B, S]}``; a training batch
holds ``S + 1`` tokens a row (inputs and next-token labels). Decode: one
token per sequence against a KV cache of ``max_seq`` positions. ``rt``
(``models/runtime.py``) picks the attention implementation and remat;
serving passes ``runtime.DEFAULT``, and decode always masks with
``cfg.sliding_window``. ``forward`` returns the moe layers' summed router
loss beside the logits (0 for the dense family), which ``loss_fn`` adds at
``cfg.moe.router_aux_weight``. The ssm/hybrid/encdec/vlm families come in
later slices (``init_params`` and ``init_cache`` raise for them).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg):
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random params in ``cfg.dtype`` from ``generator``, drawn on the
    generator's device (torch's stream, not JAX's: the tests carry JAX's
    weights across with ``bridge``); with no generator, unfilled (on the
    meta device: shapes only). The JAX tree: embed, final_norm, blocks.l0
    (stacked), unembed (unless tied)."""
    B.check_family(cfg)
    dt = _dtype(cfg)
    V = cfg.padded_vocab
    p: Params = {
        "embed": L.dense_init(generator, (V, cfg.d_model), dt, device),
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dt, device),
        "blocks": B.init_stacked_units(generator, cfg, dt, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(generator, (cfg.d_model, V), dt, device)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _logits(cfg, p, x):
    """fp32 logits: x and the unembedding are cast to fp32 and multiplied,
    as the JAX package does."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = x.float() @ w.float()
    if cfg.padded_vocab != cfg.vocab:
        # mask the padding tail so the softmax matches the published vocab
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _embed(cfg, p, tokens):
    return p["embed"][tokens.long()]


def _positions(tokens, start: int = 0):
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device) + start
    return pos[None].expand(tokens.shape[0], -1)


def forward(params, cfg, rt, batch, *, start_pos: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B, S, V], aux): aux the
    layers' router losses summed (fp32; 0 without moe layers)."""
    B.check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    x, _, aux = B.scan_units(params["blocks"], x, cfg, rt,
                             positions=_positions(tokens, start_pos))
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux


def loss_fn(params, cfg, rt, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy on ``tokens[:, :-1]`` -> ``tokens[:, 1:]``,
    log-softmax over the fp32 logits, plus the router's aux term (0 for the
    dense family). Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    inp = dict(batch)
    inp["tokens"] = tokens[:, :-1]
    labels = tokens[:, 1:].long()
    logits, aux = forward(params, cfg, rt, inp)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    ce = torch.mean(nll)
    loss = ce + cfg.moe.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serve: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    """Zeroed KV cache in ``cfg.dtype``."""
    return B.init_cache(cfg, batch, max_seq, _dtype(cfg), device)


def prefill(params, cfg, rt, batch, cache) -> Tuple[torch.Tensor, Any]:
    """Run the prompt through the model, filling the cache from position 0.

    Returns (last-token logits [B, V], cache)."""
    B.check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    x, cache, _ = B.scan_units(params["blocks"], x, cfg, rt,
                               positions=_positions(tokens), pos=0,
                               cache=cache)
    x = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x)[:, 0], cache


def decode_step(params, cfg, rt, token, cache, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token [B] int; pos the absolute position (int).
    Decodes with the sliding-window mask when the config has one.
    Returns (logits [B, V], cache)."""
    B.check_family(cfg)
    x = _embed(cfg, params, token[:, None])
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=token.device)
    x, cache, _ = B.scan_units(params["blocks"], x, cfg, rt,
                               positions=positions, pos=pos, cache=cache,
                               window=cfg.sliding_window)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# batch specs and parameter counting
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    """The shape and dtype of one batch entry (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_batch_spec(cfg, shape) -> Dict[str, Spec]:
    """One global training batch of the ``InputShape``: ``S + 1`` tokens a
    row (the dense and moe families)."""
    B.check_family(cfg)
    return {"tokens": Spec((shape.global_batch, shape.seq_len + 1),
                           torch.int32)}


def param_count(cfg, active_only: bool = False) -> int:
    """Parameters of ``init_params``'s tree, counted on the meta device
    (nothing is allocated). With ``active_only`` the routed experts
    (``blocks.l0.moe.experts``) count at ``top_k / num_experts`` (the
    parameters a token runs through), as
    ``repro.models.model.param_count`` counts them."""
    p = init_params(cfg, None, "meta")
    total = sum(t.numel() for t in tree.leaves(p))
    if active_only and "moe" in p["blocks"]["l0"]:
        m = cfg.moe
        experts = sum(t.numel() for t in tree.leaves(
            p["blocks"]["l0"]["moe"]["experts"]))
        total -= experts * (1 - m.top_k / max(m.num_experts, 1))
    return int(total)
