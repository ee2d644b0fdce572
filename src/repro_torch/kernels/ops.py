"""Device dispatch over the port's kernels.

A CPU tensor goes to the plain version (``ref``), any other tensor to the
hand-written kernel, whose wrapper launches it or raises. There is no
fallback: a card without a working kernel is an error, not a slow path.

``FlashAttention`` and ``RMSNorm`` put the two transformer kernels under
autograd: each forward goes through the dispatch below (the kernel on the
card, the plain version on the CPU). ``FlashAttention``'s backward goes
through ``flash_attention_bwd`` likewise: on the card the hand-written
backward kernels (the JAX package's backward is jnp, ``_fa_bwd``), on the
CPU its plain version over kv chunks. ``RMSNorm``'s backward is plain torch
on both devices (the JAX package's RMSNorm has no custom VJP). Each
``Function`` calls this module's ``flash_attention`` /
``flash_attention_bwd`` / ``rmsnorm`` by name, and ``models/lstm.py::_Seq``
calls ``lstm_seq`` / ``lstm_seq_bwd`` by name, so a comparison that patches
those names runs the whole model on the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ternary as _tern


def lstm_cell(x, h, c, kernel, bias):
    if x.device.type == "cpu":
        return ref.lstm_cell(x, h, c, kernel, bias)
    return _lstm.lstm_cell(x, h, c, kernel, bias)


def lstm_seq(x_seq, h0, c0, kernel, bias):
    """x_seq [T,B,Din] from (h0, c0) [B,H] -> (hs, cs [T,B,H], gates
    [T,B,4H] fp32), in one launch on the card."""
    if x_seq.device.type == "cpu":
        return ref.lstm_seq(x_seq, h0, c0, kernel, bias)
    return _lstm.lstm_seq(x_seq, h0, c0, kernel, bias)


def lstm_seq_bwd(dhs, gates, cs, c0, w_h):
    """Backpropagation through time of ``lstm_seq`` for the cotangent dhs
    [T,B,H], from its gates and cs, c0 and w_h = kernel[Din:] -> (dz
    [T,B,4H], dh0, dc0 [B,H]) fp32, in one launch on the card."""
    if dhs.device.type == "cpu":
        return ref.lstm_seq_bwd(dhs, gates, cs, c0, w_h)
    return _lstm.lstm_seq_bwd(dhs, gates, cs, c0, w_h)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x [..., D], scale [D] -> ``x * rsqrt(mean(x^2) + eps) * scale``."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """Self-attention, q [B,S,H,hd], k/v [B,S,Kv,hd] -> [B,S,H,hd]; with
    ``with_lse`` also each row's log-sum-exp, fp32 [B,H,S]."""
    if q.device.type == "cpu":
        if k.shape[1] != q.shape[1]:
            raise ValueError(f"flash_attention: Sq={q.shape[1]} != "
                             f"Skv={k.shape[1]} (self-attention only)")
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   with_lse=with_lse)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               with_lse=with_lse)


# the plain flash backward's kv-chunk length (the JAX package's
# Runtime.kv_chunk)
KV_CHUNK = 512


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, chunk: int = KV_CHUNK):
    """The backward of ``flash_attention`` from its out and lse [B,H,S] for
    the cotangent dout -> (dq, dk, dv) in q's, k's and v's dtypes. On the
    CPU the plain version over kv chunks of ``chunk``; on the card the
    kernels, two launches, with their own tiles."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       chunk=chunk)
    return _fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """``flash_attention`` with a gradient where one is wanted (through
    ``FlashAttention``, whose plain backward on the CPU runs over kv chunks
    of ``min(KV_CHUNK, S)``); without one (serving, ``torch.no_grad``) the
    plain call, which writes no lse."""
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window,
                                    min(KV_CHUNK, k.shape[1]))
    return flash_attention(q, k, v, causal=causal, window=window)


def rms_norm(x, scale, eps: float = 1e-6):
    """``rmsnorm`` with a gradient where one is wanted (``RMSNorm``)."""
    if _wants_grad(x, scale):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd (the JAX package's
    ``repro/models/layers.py::flash_attention`` custom VJP):
    ``FlashAttention.apply(q, k, v, causal, window, chunk)``. The forward
    also writes lse and saves q, k, v, out and lse; the backward is
    ``flash_attention_bwd`` (the kernels on the card; on the CPU the plain
    version over kv chunks of ``chunk``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, chunk = ctx.attrs
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, chunk=chunk)
        return dq, dk, dv, None, None, None


class RMSNorm(torch.autograd.Function):
    """``rmsnorm`` under autograd: ``RMSNorm.apply(x, scale, eps)``; the
    backward is ``ref.rmsnorm_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = ref.rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


def ternary_encode(g_flat, s):
    """fp32 [N] (N % 4 == 0), fp32 scale -> packed uint8 [N/4]."""
    if g_flat.device.type == "cpu":
        if g_flat.numel() % 4:
            raise ValueError(f"ternary_encode: N={g_flat.numel()} is not a "
                             f"multiple of 4")
        return ref.ternary_encode_packed(g_flat, s)
    return _tern.ternary_encode(g_flat, s)


def ternary_decode(packed, s):
    """packed uint8 [N/4], fp32 scale -> fp32 [N] of +s, -s and 0 * s."""
    if packed.device.type == "cpu":
        return ref.ternary_decode_packed(packed, s)
    return _tern.ternary_decode(packed, s)


# The gradient-level codec: lists of flat leaves, one device (the first
# leaf's decides). On the card each call is one or two launches for the
# whole gradient (``kernels/ternary.py``).

def ternary_ef(gs, rs, payload: bool = False):
    """Error feedback over fp32 leaves gs, rs -> (decoded, residual) per
    leaf, shaped like gs; with ``payload``, (packed, s, decoded,
    residual)."""
    if gs[0].device.type == "cpu":
        return ref.ternary_ef(gs, rs, payload)
    return _tern.ef_compress_leaves(gs, rs, payload)


def ternary_encode_leaves(gs, scales=None):
    """fp32 leaves, contiguous (and their scales, or None: max|g| clamped) ->
    (packed [ceil(n/4)] uint8, s) per leaf."""
    if gs[0].device.type == "cpu":
        return ref.ternary_encode_leaves(gs, scales)
    return _tern.encode_leaves(gs, scales)


def ternary_decode_leaves(packed, scales, shapes):
    """Packed leaves and scales -> fp32 ``shapes[i]`` per leaf."""
    if packed[0].device.type == "cpu":
        return ref.ternary_decode_leaves(packed, scales, shapes)
    return _tern.decode_leaves(packed, scales, shapes)
