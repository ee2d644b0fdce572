"""Top-level model API of every transformer family, as
``repro.models.model``: init, forward, the training loss, prefill and
decode, batch specs and the parameter count.

Batch conventions (integer tokens int32): the dense, moe, ssm and hybrid
families take ``{"tokens": [B, S]}``; the vlm family also ``"patches"``
``[B, P, D]`` (the stubbed ViT's output, prepended to the token
embeddings; the logits are the tokens' only), the encdec family
``"frames"`` ``[B, Se, D]`` (the stubbed conv/mel front end's output, which
the encoder reads). A training batch holds ``S + 1`` tokens a row (inputs
and next-token labels; ``S - P + 1`` for vlm). Decode: one token per
sequence against a cache of ``max_seq`` positions (k/v for the attention
layers, the conv window and the fp32 scan state for the ssm layers, the
encoder memory's projected k/v for the encdec decoder), at its absolute
position (``P`` + the prompt for vlm). ``rt`` (``models/runtime.py``)
picks remat, the moe dispatch and the scan's chunk; serving passes
``runtime.DEFAULT``, and decode always masks with ``cfg.sliding_window``.
``forward`` returns the moe layers' summed router loss beside the logits
(0 without moe layers), which ``loss_fn`` adds at
``cfg.moe.router_aux_weight``.
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


def dtype_of(cfg) -> torch.dtype:
    """``cfg.dtype`` as a torch dtype."""
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device) -> Params:
    """Random params in ``cfg.dtype`` from ``generator``, drawn on the
    generator's device (torch's stream, not JAX's: the tests carry JAX's
    weights across with ``bridge``); with no generator, unfilled (on the
    meta device: shapes only). The JAX tree: embed, final_norm,
    blocks.l0..l{P-1} (each stacked over the units), unembed (unless
    tied); for encdec ``encoder`` (drawn as a dense stack of
    ``n_encoder_layers``, so ``wo``'s init scale uses the encoder's depth),
    ``enc_norm`` and ``decoder`` (each layer with its cross-attention) in
    place of ``blocks``."""
    B.check_family(cfg)
    dt = dtype_of(cfg)
    V = cfg.padded_vocab
    p: Params = {
        "embed": L.dense_init(generator, (V, cfg.d_model), dt, device),
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dt, device),
    }
    if cfg.family == "encdec":
        p["encoder"] = B.init_stacked_units(generator, _encoder_cfg(cfg), dt,
                                            device)
        p["enc_norm"] = L.init_norm(cfg.norm, cfg.d_model, dt, device)
        p["decoder"] = B.init_stacked_units(generator, cfg, dt, device,
                                            cross=True)
    else:
        p["blocks"] = B.init_stacked_units(generator, cfg, dt, device)
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


def _encoder_cfg(cfg):
    """The encoder's stack: dense, ``n_encoder_layers`` deep, no RoPE."""
    return cfg.replace(n_layers=cfg.n_encoder_layers, family="dense",
                       rope_fraction=0.0)


def _with_sinusoids(x, positions):
    """x [B, S, D] plus the sinusoidal positions of ``positions`` [B, S],
    cast to x's dtype."""
    return x + L.sinusoidal_positions(positions, x.shape[-1]).to(x.dtype)


def _encode(cfg, rt, p, frames):
    """The whisper encoder over the stubbed frame embeddings [B, Se, D]:
    sinusoidal positions, non-causal units, ``enc_norm``."""
    positions = _positions(frames[..., 0])
    x = _with_sinusoids(frames, positions)
    x, _, _ = B.scan_units(p["encoder"], x, _encoder_cfg(cfg), rt,
                           positions=positions, causal=False)
    return L.apply_norm(cfg.norm, p["enc_norm"], x)


def _inputs(cfg, rt, params, batch, start_pos: int = 0):
    """The first unit's input, its positions and what the units take
    beside: (x [B, S, D], positions [B, S], the stack, {"memory": the
    encoder's output} for encdec, else {}). encdec: the token embeddings
    plus sinusoidal positions; vlm: the patches, then the token
    embeddings."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    if cfg.family == "encdec":
        positions = _positions(tokens, start_pos)
        memory = _encode(cfg, rt, params, batch["frames"])
        return (_with_sinusoids(x, positions), positions, params["decoder"],
                {"memory": memory})
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x, _positions(x[..., 0], start_pos), params["blocks"], {}
    return x, _positions(tokens, start_pos), params["blocks"], {}


def forward(params, cfg, rt, batch, *, start_pos: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B, St, V] over the tokens,
    aux): aux the layers' router losses summed (fp32; 0 without moe
    layers)."""
    B.check_family(cfg)
    x, positions, stack, extra = _inputs(cfg, rt, params, batch, start_pos)
    x, _, aux = B.scan_units(stack, x, cfg, rt, positions=positions,
                             **extra)
    if cfg.family == "vlm":
        x = x[:, batch["patches"].shape[1]:]
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
    """Zeroed decode cache in ``cfg.dtype`` (an ssm layer's h in fp32; an
    encdec decoder layer's ``ck``/``cv`` over ``cfg.encoder_seq``)."""
    cross = cfg.encoder_seq if cfg.family == "encdec" else 0
    return B.init_cache(cfg, batch, max_seq, dtype_of(cfg), device,
                        cross_seq=cross)


def prefill(params, cfg, rt, batch, cache) -> Tuple[torch.Tensor, Any]:
    """Run the prompt (after the patches, for vlm) through the model,
    filling the cache from position 0 (and an encdec decoder's cross k/v
    from the encoded frames).

    Returns (last-token logits [B, V], cache)."""
    B.check_family(cfg)
    x, positions, stack, extra = _inputs(cfg, rt, params, batch)
    x, cache, _ = B.scan_units(stack, x, cfg, rt, positions=positions,
                               pos=0, cache=cache, **extra)
    x = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x)[:, 0], cache


def decode_step(params, cfg, rt, token, cache, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token [B] int; pos the absolute position (int;
    after the patches for vlm). Decodes with the sliding-window mask when
    the config has one; an encdec decoder adds the sinusoidal position and
    attends to the cached cross k/v. Returns (logits [B, V], cache)."""
    B.check_family(cfg)
    x = _embed(cfg, params, token[:, None])
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=token.device)
    stack = params["decoder" if cfg.family == "encdec" else "blocks"]
    if cfg.family == "encdec":
        x = _with_sinusoids(x, positions)
    x, cache, _ = B.scan_units(stack, x, cfg, rt, positions=positions,
                               pos=pos, cache=cache,
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
    row; encdec also ``frames`` ``[B, encoder_seq, D]``; vlm ``patches``
    ``[B, vision_prefix, D]`` and ``S - vision_prefix + 1`` tokens a row
    (the sequence holds both)."""
    B.check_family(cfg)
    Bsz, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": Spec((Bsz, cfg.encoder_seq, cfg.d_model),
                               dtype_of(cfg)),
                "tokens": Spec((Bsz, S + 1), torch.int32)}
    if cfg.family == "vlm":
        return {"patches": Spec((Bsz, cfg.vision_prefix, cfg.d_model),
                                dtype_of(cfg)),
                "tokens": Spec((Bsz, S - cfg.vision_prefix + 1),
                               torch.int32)}
    return {"tokens": Spec((Bsz, S + 1), torch.int32)}


def decode_spec(cfg, shape) -> Tuple[Spec, Spec]:
    """(token, pos) of a decode step: one token a sequence, a scalar
    position."""
    return (Spec((shape.global_batch,), torch.int32), Spec((), torch.int32))


def param_count(cfg, active_only: bool = False) -> int:
    """Parameters of ``init_params``'s tree, counted on the meta device
    (nothing is allocated). With ``active_only`` every leaf under an
    ``experts`` key, wherever it sits (jamba's in l1, l3, l5 and l7),
    counts at ``top_k / num_experts`` (the parameters a token runs
    through), as ``repro.models.model.param_count`` counts them."""
    p = init_params(cfg, None, "meta")
    m = cfg.moe
    total = 0
    for path, t in zip(tree.leaf_paths(p), tree.leaves(p)):
        n = t.numel()
        if active_only and "experts" in path:
            n = n * (m.top_k / max(m.num_experts, 1))
        total += n
    return int(total)
