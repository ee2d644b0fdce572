"""The paper's workload: stacked-LSTM next-char model (tfjs lstm_text_generation).

Port of ``repro/models/lstm.py``. Input: one-hot chars [B, sample_len, vocab]
(the tfjs example feeds one-hot, no embedding). Two stacked LSTM layers of
``cfg.d_model`` cells, dense softmax head over the vocabulary, categorical
cross-entropy on the next char. Keras/TF gate order (i, f, c, o) and unit
forget-gate bias, matching TensorFlow.js semantics.

Params are plain dicts of tensors, the JAX package's pytree layout, so the
control plane passes them around unchanged. Each layer's forward over the
whole sequence is one ``kernels.ops.lstm_seq`` call (one launch of the CUDA
sequence kernel on the card); its gradient is backpropagation through time
in plain PyTorch from the gates the forward saved (the JAX package has no
backward kernel either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _dense_init(generator, shape, scale):
    """``scale * truncated_normal(-2, 2)``, drawn on the CPU from
    ``generator`` so a seed gives the same weights on every device."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return scale * t


def init_lstm_model(generator: torch.Generator, cfg, vocab: int, device):
    """Random params from ``generator`` (torch's stream, not JAX's: tests
    that compare with JAX carry JAX's params across with ``bridge``)."""
    H = cfg.d_model
    layers = []
    d_in = vocab
    for _ in range(cfg.n_layers):
        kernel = _dense_init(generator, (d_in + H, 4 * H),
                             (2.0 / (d_in + 4 * H)) ** 0.5)
        bias = torch.zeros(4 * H)
        bias[H:2 * H] = 1.0                       # unit forget bias (keras)
        layers.append({"kernel": kernel.to(device), "bias": bias.to(device)})
        d_in = H
    head = {"w": _dense_init(generator, (H, vocab),
                             (2.0 / (H + vocab)) ** 0.5).to(device),
            "b": torch.zeros(vocab, device=device)}
    return {"layers": layers, "head": head}


class _Seq(torch.autograd.Function):
    """One layer over the whole sequence: the kernel's forward, and
    backpropagation through time in plain PyTorch from the saved gates.

    Per step t, from the last: dh = dhs[t] + dh_next, dc = dc_next + dh *
    o * (1 - tanh(c_t)^2), dz_t = (dc * g * i(1-i), dc * c_{t-1} * f(1-f),
    dc * i * (1-g^2), dh * tanh(c_t) * o(1-o)), then dh_next = dz_t @
    W_h^T and dc_next = dc * f. After the loop one product each gives dW =
    [x; h_prev]^T dZ over all T*B rows and dx = dZ W_x^T (skipped where
    x needs no gradient, as layer 0's one-hot input), and db = dZ.sum(0)."""

    @staticmethod
    def forward(ctx, x_seq, h0, c0, kernel, bias):
        hs, cs, gates = ops.lstm_seq(x_seq, h0, c0, kernel, bias)
        ctx.save_for_backward(x_seq, h0, c0, kernel, hs, cs, gates)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_seq, h0, c0, kernel, hs, cs, gates = ctx.saved_tensors
        T, B, Din = x_seq.shape
        H = h0.shape[1]
        f32 = torch.float32
        w = kernel.to(f32)
        c = cs.to(f32)
        c_prev = torch.cat([c0.to(f32)[None], c[:-1]])
        i, f, g, o = gates.split(H, dim=-1)
        tanh_c = torch.tanh(c)
        # the factors of the chain that do not depend on it, for all t
        dz_dc = torch.stack([g * i * (1 - i), c_prev * f * (1 - f),
                             i * (1 - g * g)], -2)           # [T, B, 3, H]
        dz_dh = tanh_c * o * (1 - o)
        dc_dh = o * (1 - tanh_c * tanh_c)
        w_h_t = w[Din:].t()
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
        dz2 = dz.view(T * B, 4 * H)
        h_prev = torch.cat([h0.to(f32)[None], hs.to(f32)[:-1]])
        xh = torch.cat([x_seq.to(f32), h_prev], -1).view(T * B, Din + H)
        d_kernel = (xh.t() @ dz2).to(kernel.dtype)
        d_bias = dz2.sum(0).to(kernel.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dz2 @ w[:Din].t()).view(T, B, Din).to(x_seq.dtype)
        return dx, dh.to(h0.dtype), dc.to(c0.dtype), d_kernel, d_bias


def apply_lstm_model(params, onehot):
    """onehot [B, T, V] -> next-char logits [B, V]. Each layer runs the
    whole sequence in one ``lstm_seq`` call, where JAX runs ``lax.scan``."""
    B = onehot.shape[0]
    x_seq = onehot.transpose(0, 1).contiguous()              # [T, B, V]
    for lp in params["layers"]:
        H = lp["kernel"].shape[1] // 4
        h = torch.zeros(B, H, dtype=onehot.dtype, device=onehot.device)
        x_seq = _Seq.apply(x_seq, h, torch.zeros_like(h), lp["kernel"],
                           lp["bias"])                        # [T, B, H]
    last = x_seq[-1]                                          # [B, H]
    return last @ params["head"]["w"] + params["head"]["b"]


def lstm_loss(params, batch):
    """batch: {"x": one-hot [B,T,V], "y": int labels [B]} -> mean CE (nats).
    The label pick is a one-hot product, not a gather, so its gradient is a
    plain product too (a scatter would not be deterministic on the card)."""
    logits = apply_lstm_model(params, batch["x"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot_y = F.one_hot(batch["y"].long(), logp.shape[-1]).to(logp.dtype)
    nll = -(logp * onehot_y).sum(dim=-1)
    return nll.mean()
