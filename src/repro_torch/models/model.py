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
``cfg.moe.router_aux_weight``. The loss is ``cross_entropy``'s: the
vocab-parallel form, which runs with no group off a mesh.

On a mesh (``rt.spmd``) the params arrive sharded: ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` gather the embedding, the
unembedding and the final norms at use (``spmd.Layout.modules_at_use``),
and ``blocks.scan_units`` the stacks (the encdec encoder's and decoder's
too) a unit at a time. A vocab split over ``model`` (tied embeddings
alike) looks up the rank's rows (masked; an exit sums the ranks') and
computes the rank's logit columns: the training loss reduces them over
``model`` (a max, then two sums), serving gathers them. Under
``seq_parallel`` the embedded sequence (and the encoder's frames) is cut
to the rank's shard before the units, and the final norm's shard is
gathered for the logits (the encoder's for its memory).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH
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

def _logits(cfg, p, x, split=None):
    """fp32 logits: x and the unembedding are cast to fp32 and multiplied,
    as the JAX package does. Under a ``split`` the rank's vocab columns
    (x passed the unembedding's entry)."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = x.float() @ w.float()
    if cfg.padded_vocab != cfg.vocab:
        # mask the padding tail so the softmax matches the published vocab
        lo = 0 if split is None else split.lo
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _embed(cfg, p, tokens, split=None):
    """The tokens' embeddings; under a ``split`` the rank's vocab rows
    looked up (zero for another rank's token) and summed over ``model``
    by the exit."""
    if split is None:
        return p["embed"][tokens.long()]
    t = tokens.long() - split.lo
    inside = (t >= 0) & (t < split.n)
    e = p["embed"][t.clamp(0, split.n - 1)]
    e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                      device=e.device))
    return split.layout.exit(e)


def cross_entropy(logits, labels, split=None):
    """Mean next-token cross-entropy of fp32 ``logits`` [..., V] at the
    global ``labels`` [...]: log(sum exp(z)) - z[label], z the logits less
    their max. Under a ``split`` the logits are the rank's vocab columns
    and the max, the sum and the label's z are reduced over ``model`` (the
    max by an all-reduce with no gradient, the sums by exits); off one,
    the same arithmetic with no group."""
    lo = 0 if split is None else split.lo
    top = logits.detach().amax(dim=-1)
    if split is not None:
        top = split.layout.max_model(top)
    z = logits - top[..., None]
    se = torch.exp(z).sum(dim=-1)
    t = labels.long() - lo
    inside = (t >= 0) & (t < z.shape[-1])
    lab = torch.gather(z, -1, t.clamp(0, z.shape[-1] - 1)[..., None])[..., 0]
    lab = torch.where(inside, lab, torch.zeros((), dtype=lab.dtype,
                                               device=lab.device))
    if split is not None:
        se, lab = split.layout.exit(se), split.layout.exit(lab)
    return torch.mean(torch.log(se) - lab)


def _positions(tokens, start: int = 0):
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device) + start
    return pos[None].expand(tokens.shape[0], -1)


def _at_use(rt, params):
    """(params, splits): on a mesh every leaf outside the stacked units
    gathered by its module's plan, with each module's ``spmd.Split`` (the
    stacks stay sharded for ``scan_units``); off one the params as they
    are and no splits."""
    if rt.spmd is None:
        return params, {}
    out, splits = rt.spmd.modules_at_use(
        {k: v for k, v in params.items() if k not in SH._STACKED_ROOTS})
    out.update({k: v for k, v in params.items() if k in SH._STACKED_ROOTS})
    return out, splits


def _unembed_split(cfg, splits):
    return splits.get("embed" if cfg.tie_embeddings else "unembed")


def _shard_seq(rt, x):
    """Under ``seq_parallel`` the rank's sequence shard of the stream x
    (its gradient gathered back); x as it is otherwise."""
    if rt.spmd is None or not rt.spmd.seq_parallel:
        return x
    return rt.spmd.seq_out(x, False)


def _unshard_seq(rt, x, split):
    """The final norm's output for the logits: under ``seq_parallel``
    gathered along the sequence (its gradient reduce-scattered where the
    logits are the rank's columns); else through the unembedding's entry
    where it is split."""
    if rt.spmd is None:
        return x
    if rt.spmd.seq_parallel:
        return rt.spmd.seq_in(x, split is not None)
    return rt.spmd.enter(x) if split is not None else x


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
    sinusoidal positions, non-causal units, ``enc_norm`` (under
    ``seq_parallel`` on the rank's shard, then gathered)."""
    positions = _positions(frames[..., 0])
    x = _shard_seq(rt, _with_sinusoids(frames, positions))
    x, _, _ = B.scan_units(p["encoder"], x, _encoder_cfg(cfg), rt,
                           positions=positions, causal=False)
    x = L.apply_norm(cfg.norm, p["enc_norm"], x)
    if rt.spmd is not None and rt.spmd.seq_parallel:
        x = rt.spmd.seq_in(x, False)
    return x


def _inputs(cfg, rt, params, splits, batch, start_pos: int = 0):
    """The first unit's input, its positions and what the units take
    beside: (x [B, S, D] (the rank's sequence shard under
    ``seq_parallel``), positions [B, S], the stack, {"memory": the
    encoder's output} for encdec, else {}). encdec: the token embeddings
    plus sinusoidal positions; vlm: the patches, then the token
    embeddings."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens, splits.get("embed"))
    if cfg.family == "encdec":
        positions = _positions(tokens, start_pos)
        memory = _encode(cfg, rt, params, batch["frames"])
        return (_shard_seq(rt, _with_sinusoids(x, positions)), positions,
                params["decoder"], {"memory": memory})
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return (_shard_seq(rt, x), _positions(x[..., 0], start_pos),
                params["blocks"], {})
    return _shard_seq(rt, x), _positions(tokens, start_pos), \
        params["blocks"], {}


def _features(params, cfg, rt, batch, start_pos: int = 0):
    """The final norm's output over the tokens, ready for the logits (the
    unembedding's entry passed), the units' router losses and the
    unembedding's split: (x [B, St, D], aux or None, params, split)."""
    B.check_family(cfg)
    params, splits = _at_use(rt, params)
    x, positions, stack, extra = _inputs(cfg, rt, params, splits, batch,
                                         start_pos)
    x, _, aux = B.scan_units(stack, x, cfg, rt, positions=positions,
                             **extra)
    split = _unembed_split(cfg, splits)

    def tokens_only(t):          # a vlm's patches carry no logits
        return t[:, batch["patches"].shape[1]:] if cfg.family == "vlm" \
            else t
    if rt.spmd is not None and rt.spmd.seq_parallel:
        # the norm on the rank's shard, its output gathered
        x = L.apply_norm(cfg.norm, params["final_norm"], x)
        x = tokens_only(_unshard_seq(rt, x, split))
    else:
        x = L.apply_norm(cfg.norm, params["final_norm"], tokens_only(x))
        x = _unshard_seq(rt, x, split)
    return x, aux, params, split


def _gathered_logits(cfg, params, x, split):
    """Logits over the whole vocab (a split's columns gathered over
    ``model``)."""
    logits = _logits(cfg, params, x, split)
    return logits if split is None else \
        split.layout.gather_model(logits, -1)


def forward(params, cfg, rt, batch, *, start_pos: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B, St, V] over the tokens,
    aux): aux the layers' router losses summed (fp32; 0 without moe
    layers)."""
    x, aux, params, split = _features(params, cfg, rt, batch, start_pos)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _gathered_logits(cfg, params, x, split), aux


def loss_fn(params, cfg, rt, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy on ``tokens[:, :-1]`` -> ``tokens[:, 1:]``
    over the fp32 logits (``cross_entropy``: the rank's vocab columns on a
    mesh whose ``model`` splits the vocab), plus the router's aux term (0
    for the dense family). Returns (loss, {"ce", "aux"})."""
    tokens = batch["tokens"]
    inp = dict(batch)
    inp["tokens"] = tokens[:, :-1]
    x, aux, params, split = _features(params, cfg, rt, inp)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ce = cross_entropy(_logits(cfg, params, x, split), tokens[:, 1:], split)
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
    params, splits = _at_use(rt, params)
    x, positions, stack, extra = _inputs(cfg, rt, params, splits, batch)
    x, cache, _ = B.scan_units(stack, x, cfg, rt, positions=positions,
                               pos=0, cache=cache, **extra)
    x = L.apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    split = _unembed_split(cfg, splits)
    return _gathered_logits(cfg, params, _unshard_seq(rt, x, split),
                            split)[:, 0], cache


def decode_step(params, cfg, rt, token, cache, pos: int
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step. token [B] int; pos the absolute position (int;
    after the patches for vlm). Decodes with the sliding-window mask when
    the config has one; an encdec decoder adds the sinusoidal position and
    attends to the cached cross k/v. Returns (logits [B, V], cache)."""
    B.check_family(cfg)
    params, splits = _at_use(rt, params)
    x = _embed(cfg, params, token[:, None], splits.get("embed"))
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=token.device)
    stack = params["decoder" if cfg.family == "encdec" else "blocks"]
    if cfg.family == "encdec":
        x = _with_sinusoids(x, positions)
    x, cache, _ = B.scan_units(stack, x, cfg, rt, positions=positions,
                               pos=pos, cache=cache,
                               window=cfg.sliding_window)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    split = _unembed_split(cfg, splits)
    return _gathered_logits(cfg, params, _unshard_seq(rt, x, split),
                            split)[:, 0], cache


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
