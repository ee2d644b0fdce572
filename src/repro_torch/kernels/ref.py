"""Plain PyTorch versions of the port's kernels (the allclose references).

Each computes exactly what its kernel computes, in the most literal form, so
a kernel bug cannot hide behind a mirrored bug here. The CPU path runs these;
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import math

import torch


def lstm_cell(x, h, c, kernel, bias):
    """Keras-gate-order LSTM cell. x [B,Din], h/c [B,H], kernel [(Din+H),4H].

    As the TPU kernel (``repro/kernels/lstm_cell.py::_cell_kernel``) does,
    everything is computed in fp32 and the outputs are stored in the input
    dtype. For fp32 inputs this is ``repro/kernels/ref.py::lstm_cell``."""
    z = torch.cat([x, h], dim=-1).float() @ kernel.float() + bias.float()
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in fp32,
    stored in x's dtype (``repro/kernels/ref.py::rmsnorm``)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Exact softmax attention (materialised scores), as
    ``repro/kernels/ref.py::flash_attention``. q [B,Sq,H,hd]; k/v
    [B,Skv,Kv,hd] with GQA head grouping (query head h reads kv head
    h // (H/Kv)). q positions are aligned to the end of kv
    (q_pos = Skv - Sq + i). The scores are scaled after the product."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)
    ok = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(ok[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def ternary_encode(g, scale):
    """Threshold ternarization: t = sign(g) * (|g| >= scale/2), int8."""
    return (torch.sign(g) * (g.abs() >= scale / 2)).to(torch.int8)


def ternary_pack(t_flat):
    """Pack int8 {-1,0,1} (len % 4 == 0) into uint8, 2 bits each:
    {0 -> 0b00, 1 -> 0b01, -1 -> 0b10}, little-endian within the byte."""
    codes = torch.where(t_flat < 0, 2, t_flat).to(torch.uint8)
    c = codes.reshape(-1, 4)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def ternary_unpack(packed, n):
    parts = [(packed >> (2 * i)) & 3 for i in range(4)]
    codes = torch.stack(parts, dim=1).reshape(-1)[:n].to(torch.int8)
    return torch.where(codes == 2, -1, codes)


def ternary_encode_packed(g_flat, s):
    """What the encode kernel computes, as the Pallas body
    (``repro/kernels/ternary.py::_encode_kernel``) writes it: g_flat fp32
    [N] (N % 4 == 0), s fp32 -> uint8 [N/4]."""
    g = g_flat.float().reshape(-1, 4)
    code = torch.where(g.abs() >= s / 2,
                       torch.where(g > 0, 1, 2), 0).to(torch.uint8)
    return code[:, 0] | (code[:, 1] << 2) | (code[:, 2] << 4) | \
        (code[:, 3] << 6)


def ternary_decode_packed(packed, s):
    """What the decode kernel computes, as ``_decode_kernel`` writes it:
    codes 0b01 -> +s, 0b10 -> -s, anything else -> +0.0; fp32 [4 * len]."""
    code = torch.stack([(packed >> (2 * i)) & 3 for i in range(4)], dim=1)
    val = torch.where(code == 1, 1.0, torch.where(code == 2, -1.0, 0.0))
    return (val * s).reshape(-1).to(torch.float32)
