"""Device dispatch over the port's kernels.

A CPU tensor goes to the plain version (``ref``), any other tensor to the
hand-written kernel, whose wrapper launches it or raises. There is no
fallback: a card without a working kernel is an error, not a slow path.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ternary as _tern


def lstm_cell(x, h, c, kernel, bias):
    if x.device.type == "cpu":
        return ref.lstm_cell(x, h, c, kernel, bias)
    return _lstm.lstm_cell(x, h, c, kernel, bias)


def rmsnorm(x, scale, eps: float = 1e-6):
    """x [..., D], scale [D] -> ``x * rsqrt(mean(x^2) + eps) * scale``."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Self-attention, q [B,S,H,hd], k/v [B,S,Kv,hd] -> [B,S,H,hd]."""
    if q.device.type == "cpu":
        if k.shape[1] != q.shape[1]:
            raise ValueError(f"flash_attention: Sq={q.shape[1]} != "
                             f"Skv={k.shape[1]} (self-attention only)")
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ternary_encode(g_flat, s):
    """fp32 [N] (N % 4 == 0), fp32 scale -> packed uint8 [N/4]."""
    if g_flat.device.type == "cpu":
        if g_flat.numel() % 4:
            raise ValueError(f"ternary_encode: N={g_flat.numel()} is not a "
                             f"multiple of 4")
        return ref.ternary_encode_packed(g_flat, s)
    return _tern.ternary_encode(g_flat, s)


def ternary_decode(packed, s):
    """packed uint8 [N/4], fp32 scale -> fp32 [N] of +s, -s and +0.0."""
    if packed.device.type == "cpu":
        return ref.ternary_decode_packed(packed, s)
    return _tern.ternary_decode(packed, s)
