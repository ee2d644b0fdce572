"""Plain PyTorch versions of the port's kernels (the allclose references).

Each computes exactly what its kernel computes, in the most literal form, so
a kernel bug cannot hide behind a mirrored bug here. The CPU path runs these;
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import math

import torch


def _cell(x, h, c, kernel, bias):
    """One Keras-gate-order LSTM step: (h', c', gates [B,4H] fp32, the
    activated sigmoid(i), sigmoid(f), tanh(g), sigmoid(o))."""
    z = torch.cat([x, h], dim=-1).float() @ kernel.float() + bias.float()
    i, f, g, o = z.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), \
        torch.sigmoid(o)
    c_new = f * c.float() + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype), torch.cat([i, f, g, o], -1)


def lstm_cell(x, h, c, kernel, bias):
    """Keras-gate-order LSTM cell. x [B,Din], h/c [B,H], kernel [(Din+H),4H].

    As the TPU kernel (``repro/kernels/lstm_cell.py::_cell_kernel``) does,
    everything is computed in fp32 and the outputs are stored in the input
    dtype. For fp32 inputs this is ``repro/kernels/ref.py::lstm_cell``."""
    h_new, c_new, _ = _cell(x, h, c, kernel, bias)
    return h_new, c_new


def lstm_seq(x_seq, h0, c0, kernel, bias):
    """``lstm_cell`` over x_seq [T,B,Din] from (h0, c0), each step fed the
    last one's outputs in the input dtype (as chained kernel launches are):
    (hs, cs) [T,B,H] in the input dtype and gates [T,B,4H] fp32."""
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for x in x_seq:
        h, c, g = _cell(x, h, c, kernel, bias)
        hs.append(h)
        cs.append(c)
        gates.append(g)
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_seq_bwd(dhs, gates, cs, c0, w_h):
    """Backpropagation through time of ``lstm_seq`` from its saved gates
    [T,B,4H] (fp32), cs [T,B,H] and c0 [B,H], with w_h = kernel[Din:]
    [H,4H], for the cotangent dhs [T,B,H] of hs (the backward of the JAX
    package's ``lax.scan``, ``repro/models/lstm.py:68``). Per step t, from
    the last: dh = dhs[t] + dh_next, dc = dc_next + dh * o * (1 -
    tanh(c_t)^2), dz_t = (dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i *
    (1-g^2), dh * tanh(c_t) * o(1-o)), then dh_next = dz_t @ w_h^T and
    dc_next = dc * f. Returns (dz [T,B,4H], dh0, dc0 [B,H]), all fp32: the
    final dh_next and dc_next are the gradients of h0 and c0."""
    T, B, H = dhs.shape
    f32 = torch.float32
    c = cs.to(f32)
    c_prev = torch.cat([c0.to(f32)[None], c[:-1]])
    i, f, g, o = gates.split(H, dim=-1)
    tanh_c = torch.tanh(c)
    # the factors of the chain that do not depend on it, for all t
    dz_dc = torch.stack([g * i * (1 - i), c_prev * f * (1 - f),
                         i * (1 - g * g)], -2)               # [T, B, 3, H]
    dz_dh = tanh_c * o * (1 - o)
    dc_dh = o * (1 - tanh_c * tanh_c)
    w_h_t = w_h.to(f32).t()
    dz = torch.empty(T, B, 4 * H, dtype=f32, device=dhs.device)
    dh = torch.zeros(B, H, dtype=f32, device=dhs.device)
    dc = torch.zeros(B, H, dtype=f32, device=dhs.device)
    dhs = dhs.to(f32)
    for t in range(T - 1, -1, -1):
        dh = dhs[t] + dh
        dc = torch.addcmul(dc, dh, dc_dh[t])
        torch.mul(dz_dc[t], dc[:, None], out=dz[t, :, :3 * H].view(B, 3, H))
        torch.mul(dz_dh[t], dh, out=dz[t, :, 3 * H:])
        dc = dc * f[t]
        dh = dz[t] @ w_h_t
    return dz, dh, dc


def rmsnorm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in fp32,
    stored in x's dtype (``repro/kernels/ref.py::rmsnorm``)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """The gradient of ``rmsnorm`` (the plain formula in fp32, as ``jax.grad``
    of ``repro/models/layers.py::apply_norm`` differentiates it; the JAX
    package has no custom VJP for it): (dx in x's dtype, dscale in scale's
    dtype) for the cotangent dy of y."""
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_()
        sf = scale.detach().float().requires_grad_()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * sf
        dx, ds = torch.autograd.grad(y, (xf, sf), dy.float())
    return dx.to(x.dtype), ds.to(scale.dtype)


def _mask(qpos, kpos, causal: bool, window: int):
    """[Sq, Skv] bool: where query position qpos[i] sees key kpos[j]."""
    ok = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, with_lse: bool = False):
    """Exact softmax attention (materialised scores), as
    ``repro/kernels/ref.py::flash_attention``. q [B,Sq,H,hd]; k/v
    [B,Skv,Kv,hd] with GQA head grouping (query head h reads kv head
    h // (H/Kv)). q positions are aligned to the end of kv
    (q_pos = Skv - Sq + i). The scores are scaled after the product, by
    ``scale`` where given, else by 1/sqrt(hd). With ``with_lse`` it also
    returns each row's log-sum-exp of the scaled, masked scores, fp32
    [B,H,Sq] (``lse`` of ``repro/models/layers.py::_flash_fwd``)."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    qg = q.reshape(B, Sq, Kv, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / math.sqrt(hd) if scale is None else s * scale
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)
    ok = _mask(qpos, kpos, causal, window)
    s = torch.where(ok[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, chunk: int = 512):
    """The backward of self-attention (Sq == Skv) from the forward's out and
    lse [B,H,S]: the math of ``repro/models/layers.py::_fa_bwd``, in fp32
    over kv chunks of ``chunk`` positions. Drow = rowsum(dout * out); per
    chunk p = exp(s - lse), dv = p^T dout, dp = dout v^T,
    ds = p (dp - Drow) / sqrt(hd), dq += ds k, dk = ds^T q. Returns (dq,
    dk, dv) in q's, k's and v's dtypes.

    A chunk's rows are cut to the query positions that can see it (from the
    chunk's first position when causal, up to its last + window - 1 under
    a window): the rows cut off have p = exp(-1e30 - lse) = 0 exactly, so
    they add exact zeros, and the causal products cost half the square."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, Kv, G, hd).float()
    dog = dout.reshape(B, S, Kv, G, hd).float()
    drow = torch.einsum("bqkgd,bqkgd->bkgq", dog,
                        out.reshape(B, S, Kv, G, hd).float())
    dog_bk = dog.permute(0, 2, 3, 1, 4)                      # [B,Kv,G,S,hd]
    lse = lse.reshape(B, Kv, G, S).float()
    pos = torch.arange(S, device=q.device)
    dq = torch.zeros(B, S, Kv, G, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, S, Kv, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        r0 = c0 if causal else 0
        r1 = min(S, c1 - 1 + window) if window else S
        if r0 >= r1:
            continue
        kch, vch = k[:, c0:c1].float(), v[:, c0:c1].float()
        qr = qg[:, r0:r1]
        s = torch.einsum("bqkgd,bckd->bkgqc", qr, kch) * scale
        ok = _mask(pos[r0:r1], pos[c0:c1], causal, window)
        s = torch.where(ok[None, None, None], s, -1e30)
        p = torch.exp(s - lse[..., r0:r1, None])            # [B,Kv,G,r,c]
        do_r = dog_bk[:, :, :, r0:r1]
        dv[:, c0:c1] = torch.einsum("bkgqc,bkgqd->bckd", p, do_r)
        dp = torch.einsum("bkgqd,bckd->bkgqc", do_r, vch)
        ds = p * (dp - drow[..., r0:r1, None]) * scale
        dq[:, r0:r1] += torch.einsum("bkgqc,bckd->bqkgd", ds, kch)
        dk[:, c0:c1] = torch.einsum("bkgqc,bqkgd->bckd", ds, qr)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
    g = g_flat.float()
    return _pack_codes(torch.where(g.abs() >= s / 2,
                                   torch.where(g > 0, 1, 2), 0)
                       .to(torch.uint8))


def ternary_decode_packed(packed, s):
    """What the decode kernel computes, as ``_decode_kernel`` writes it:
    codes 0b01 -> +s, 0b10 -> -s, anything else -> 0 * s (+0.0 for a
    finite s > 0, NaN for s = inf or NaN); fp32 [4 * len]."""
    code = torch.stack([(packed >> (2 * i)) & 3 for i in range(4)], dim=1)
    val = torch.where(code == 1, 1.0, torch.where(code == 2, -1.0, 0.0))
    return (val * s).reshape(-1).to(torch.float32)


# The gradient-level codec (``kernels/ternary.py``'s ``*_leaves``): the
# same per-leaf arithmetic as the JAX codec, one leaf at a time. The codes
# are gated on isfinite(s): for a finite s, |c| >= s/2 is the JAX codec's
# |c|/s >= 0.5; for s = inf or NaN the JAX codec keeps no code.

def ternary_scale(c):
    """A leaf's scale: max|c| (NaN propagates) clamped to 1e-12."""
    return torch.clamp_min(c.abs().max(), 1e-12)


def ternary_codes(c, s):
    """uint8 codes of flat c under scale s: 0b01 / 0b10 where isfinite(s)
    and |c| >= s/2, by the sign of c, else 0b00."""
    keep = torch.isfinite(s) & (c.abs() >= s / 2)
    return torch.where(keep, torch.where(c > 0, 1, 2), 0).to(torch.uint8)


def _pack_codes(code):
    """uint8 codes [n] -> packed bytes [ceil(n/4)] (pad codes 0b00)."""
    code = torch.cat([code, code.new_zeros(-code.numel() % 4)]).reshape(-1, 4)
    return code[:, 0] | (code[:, 1] << 2) | (code[:, 2] << 4) | \
        (code[:, 3] << 6)


def ternary_encode_leaves(gs, scales=None):
    """Leaves -> (packed [ceil(n/4)] uint8, s) per leaf; ``scales`` given:
    used as they are, else ``ternary_scale`` of each leaf."""
    packed, out_s = [], []
    for i, g in enumerate(gs):
        c = g.reshape(-1).float()
        s = ternary_scale(c) if scales is None else scales[i]
        packed.append(_pack_codes(ternary_codes(c, s)))
        out_s.append(s)
    return packed, out_s


def ternary_decode_leaves(packed, scales, shapes):
    """Packed leaves and their scales -> fp32 ``shapes[i]`` per leaf (code
    * s)."""
    return [ternary_decode_packed(p, s)[:math.prod(sh)].reshape(sh)
            for p, s, sh in zip(packed, scales, shapes, strict=True)]


def ternary_ef(gs, rs, payload: bool = False):
    """Error feedback over leaves: c = g + r; -> (decoded, residual
    c - decoded) per leaf, shaped like g; with ``payload``, (packed, s,
    decoded, residual)."""
    out = ([], [], [], [])
    for g, r in zip(gs, rs, strict=True):
        c = g.float() + r
        s = ternary_scale(c)
        packed = _pack_codes(ternary_codes(c.reshape(-1), s))
        d = ternary_decode_packed(packed, s)[:c.numel()].reshape(c.shape)
        for lst, v in zip(out, (packed, s, d, c - d)):
            lst.append(v)
    return out if payload else out[2:]
