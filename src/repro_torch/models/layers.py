"""Core layers of the transformer, as ``repro.models.layers``: init helpers,
norms, RoPE, attention (the flash kernel and plain), cross-attention, MLP
variants and sinusoidal positions.

Plain functions on tensors over dict params, the JAX package's tree and
shapes (``wq [D, H, hd]``, ``wo [H, hd, D]``, ...). ``init_*`` draws from an
explicit ``torch.Generator`` (torch's stream, not JAX's: the tests carry
JAX's weights across with ``bridge``). RMSNorm goes through
``kernels.ops.rms_norm`` and attention over fresh k/v (prefill, training)
through ``kernels.ops.attention``: the hand-written kernels on the card,
their plain versions on the CPU, under autograd where a gradient is wanted.
LayerNorm, decode attention and cross-attention stay plain, as in the JAX
package (which has no kernel for them: its flash kernel, like the port's,
is self-attention only, Sq == Skv).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator, shape, dtype, device, scale: float = 0.02):
    """``scale * truncated_normal(-2, 2)`` in fp32, then cast: drawn on the
    generator's device, then moved to ``device``. Without a generator, an
    unfilled tensor (shapes only: ``model.param_count`` builds the tree on
    the meta device)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * t).to(device=device, dtype=dtype)


def init_norm(kind: str, d: int, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(kind: str, p, x, eps: float = 1e-6):
    if kind == "rmsnorm":
        return ops.rms_norm(x.contiguous(), p["scale"], eps)
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    return (y + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (partial rotation supported)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, rot_dim: int, theta: float):
    """positions [...] -> cos/sin [..., rot_dim/2], fp32."""
    half = rot_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, fraction: float, theta: float):
    """x [B, S, H, hd]; rotate the first ``fraction*hd`` dims (rounded to
    even), halves split (not interleaved), in fp32, then cast back."""
    if fraction <= 0.0:
        return x
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    cos, sin = rope_cos_sin(positions, rot, theta)          # [B, S, rot/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int,
               kv_valid_len=None):
    """Additive bias [..., Sq, Skv], NEG_INF where masked. q_pos [B?, Sq],
    kv_pos [Skv] (absolute positions)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window and window > 0:
        ok &= kp > qp - window
    if kv_valid_len is not None:
        ok &= kp < kv_valid_len
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def plain_attention(q, k, v, q_positions, kv_positions, *, causal: bool,
                    window: int = 0, kv_valid_len=None):
    """q [B,Sq,H,hd]; k,v [B,Skv,Kv,hd]; GQA by head grouping. Scores are
    materialised in fp32. Returns [B,Sq,H,hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, Kv, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    bias = _mask_bias(q_positions, kv_positions, causal=causal,
                      window=window, kv_valid_len=kv_valid_len)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def init_attention(generator, cfg, dtype, device):
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(generator, (D, H, hd), dtype, device),
        "wk": dense_init(generator, (D, Kv, hd), dtype, device),
        "wv": dense_init(generator, (D, Kv, hd), dtype, device),
        "wo": dense_init(generator, (H, hd, D), dtype, device,
                         scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H, hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(Kv, hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(Kv, hd, dtype=dtype, device=device)
    return p


def _project(x, w):
    """x [B,S,D] @ w [D,N,hd] -> [B,S,N,hd], one matrix product."""
    D, N, hd = w.shape
    return (x @ w.reshape(D, N * hd)).reshape(*x.shape[:-1], N, hd)


def attention_qkv(p, x, xkv=None):
    """Project. x [B,S,D] -> q [B,S,H,hd]; k/v [B,Skv,Kv,hd] from ``xkv``
    (the encoder's memory of a cross-attention), else from x."""
    xkv = x if xkv is None else xkv
    q, k, v = (_project(x, p["wq"]), _project(xkv, p["wk"]),
               _project(xkv, p["wv"]))
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def attention_out(p, ctx):
    """ctx [B,S,H,hd] @ wo [H,hd,D] -> [B,S,D]."""
    H, hd, D = p["wo"].shape
    return ctx.reshape(*ctx.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, D)


def self_attention(p, x, cfg, *, positions, causal=True, window=0,
                   cache=None):
    """Self-attention with an optional KV cache. Returns out [B,S,D].

    cache: dict(k [B,Smax,Kv,hd], v likewise, pos int) or None; the new k/v
    are written into ``cache["k"]``/``cache["v"]`` in place (the JAX package
    returns updated copies). One token against a cache (decode, at position
    ``cache["pos"]``) runs plain attention over the cache; several tokens
    against a cache (prefill, from position 0) run the flash kernel over the
    fresh k/v, as does a call without a cache (under autograd through
    ``FlashAttention``, its backward over kv chunks of ``ops.KV_CHUNK``)."""
    q, k, v = attention_qkv(p, x)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    if cache is not None:
        pos, S = cache["pos"], x.shape[1]
        ck, cv = cache["k"], cache["v"]
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        if S == 1:
            kv_positions = torch.arange(ck.shape[1], dtype=torch.int32,
                                        device=x.device)
            out = plain_attention(q, ck, cv, positions, kv_positions,
                                  causal=causal, window=window,
                                  kv_valid_len=pos + S)
            return attention_out(p, out)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window)
    return attention_out(p, out)


def cross_attention(p, x, *, memory=None, mem_kv=None):
    """Decoder -> encoder attention, plain (non-causal, Sq != Skv). x
    [B,S,D]; memory [B,Se,D], or its projected ``mem_kv`` = (k, v)
    [B,Se,Kv,hd] (the decode cache's ``ck``/``cv``). Returns [B,S,D]."""
    if mem_kv is None:
        _, k, v = attention_qkv(p, x, xkv=memory)
    else:
        k, v = mem_kv
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    B, Sq = x.shape[:2]
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    kpos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    out = plain_attention(q, k, v, qpos, kpos, causal=False)
    return attention_out(p, out)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg, dtype, device, d_ff: int = 0):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {"wi": dense_init(generator, (D, F_), dtype, device)}
    if cfg.mlp == "swiglu":
        p["wg"] = dense_init(generator, (D, F_), dtype, device)
    p["wo"] = dense_init(generator, (F_, D), dtype, device, scale=out_scale)
    return p


def apply_mlp(p, x, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif kind == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"]))
    else:  # gelu
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# sinusoidal positions (whisper-style, computed on the fly)
# ---------------------------------------------------------------------------

def sinusoidal_positions(positions, d_model: int):
    """positions [...] -> [..., d_model] fp32: ``sin`` then ``cos`` of the
    positions over ``d_model / 2`` geometric frequencies."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(half - 1, 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
