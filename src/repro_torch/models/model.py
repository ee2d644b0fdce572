"""Top-level model API of the dense transformer family, as
``repro.models.model``: init, forward, prefill and decode.

Batch convention (integer tokens): ``{"tokens": [B, S]}``. Decode: one
token per sequence against a KV cache of ``max_seq`` positions.
``loss_fn`` and training, and the moe/ssm/hybrid/encdec/vlm families, come
in later slices (``init_params`` and ``init_cache`` raise for the latter).
The JAX functions' ``rt`` argument (``repro.models.runtime``) is left out:
no execution option of this path has a second value in the port, so
prefill and a call without a cache always take the flash kernel, and decode
always masks with ``cfg.sliding_window``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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
    weights across with ``bridge``). The JAX tree: embed, final_norm,
    blocks.l0 (stacked), unembed (unless tied)."""
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


def forward(params, cfg, batch, *, start_pos: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B, S, V], aux = 0)."""
    B.check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    x, _ = B.scan_units(params["blocks"], x, cfg,
                        positions=_positions(tokens, start_pos))
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serve: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, device="cpu"):
    """Zeroed KV cache in ``cfg.dtype``."""
    return B.init_cache(cfg, batch, max_seq, _dtype(cfg), device)


def prefill(params, cfg, batch, cache) -> Tuple[torch.Tensor, Any]:
    """Run the prompt through the model, filling the cache from position 0.

    Returns (last-token logits [B, V], cache)."""
    B.check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    x, cache = B.scan_units(params["blocks"], x, cfg,
                            positions=_positions(tokens), pos=0, cache=cache)
    x = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x)[:, 0], cache


def decode_step(params, cfg, token, cache, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token [B] int; pos the absolute position (int).
    Decodes with the sliding-window mask when the config has one.
    Returns (logits [B, V], cache)."""
    B.check_family(cfg)
    x = _embed(cfg, params, token[:, None])
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=token.device)
    x, cache = B.scan_units(params["blocks"], x, cfg,
                            positions=positions, pos=pos, cache=cache,
                            window=cfg.sliding_window)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _logits(cfg, params, x)[:, 0], cache
