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
from the gates the forward saved, one ``kernels.ops.lstm_seq_bwd`` call (one
launch of the CUDA backward kernel on the card), then three plain products
over all steps.
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
    backpropagation through time from the saved gates.

    ``ops.lstm_seq_bwd`` (one launch on the card) runs the recurrence from
    the last step and gives every step's gate gradients dZ [T,B,4H] and
    those of (h0, c0); then one product each gives dW = [x; h_prev]^T dZ
    over all T*B rows and dx = dZ W_x^T (skipped where x needs no
    gradient, as layer 0's one-hot input), and db = dZ.sum(0)."""

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
        dz, dh, dc = ops.lstm_seq_bwd(dhs.contiguous(), gates, cs, c0,
                                      kernel[Din:])
        dz2 = dz.view(T * B, 4 * H)
        h_prev = torch.cat([h0.to(f32)[None], hs.to(f32)[:-1]])
        xh = torch.cat([x_seq.to(f32), h_prev], -1).view(T * B, Din + H)
        d_kernel = (xh.t() @ dz2).to(kernel.dtype)
        d_bias = dz2.sum(0).to(kernel.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (dz2 @ kernel[:Din].to(f32).t()).view(T, B, Din) \
                .to(x_seq.dtype)
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
