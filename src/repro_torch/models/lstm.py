"""The paper's workload: stacked-LSTM next-char model (tfjs lstm_text_generation).

Port of ``repro/models/lstm.py``. Input: one-hot chars [B, sample_len, vocab]
(the tfjs example feeds one-hot, no embedding). Two stacked LSTM layers of
``cfg.d_model`` cells, dense softmax head over the vocabulary, categorical
cross-entropy on the next char. Keras/TF gate order (i, f, c, o) and unit
forget-gate bias, matching TensorFlow.js semantics.

Params are plain dicts of tensors, the JAX package's pytree layout, so the
control plane passes them around unchanged. Every cell step's forward goes
through ``kernels.ops.lstm_cell`` (the CUDA kernel on the card); its gradient
is plain PyTorch (the JAX package has no backward kernel either).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import ref


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


class _Cell(torch.autograd.Function):
    """Kernel forward; plain-torch backward recomputing the cell from the
    saved inputs (z = [x,h] @ W + b and the gates)."""

    @staticmethod
    def forward(ctx, x, h, c, kernel, bias):
        ctx.save_for_backward(x, h, c, kernel, bias)
        return ops.lstm_cell(x, h, c, kernel, bias)

    @staticmethod
    def backward(ctx, dh, dc):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            h_new, c_new = ref.lstm_cell(*inputs)
        return torch.autograd.grad((h_new, c_new), inputs, (dh, dc))


def lstm_cell(p, x, hc):
    """One step. x [B, d_in]; hc = (h [B,H], c [B,H])."""
    h, c = hc
    return _Cell.apply(x, h, c, p["kernel"], p["bias"])


def apply_lstm_model(params, onehot):
    """onehot [B, T, V] -> next-char logits [B, V]. A Python loop over T
    stands in for ``lax.scan``."""
    B = onehot.shape[0]
    x_seq = onehot.transpose(0, 1).contiguous()              # [T, B, V]
    for lp in params["layers"]:
        H = lp["kernel"].shape[1] // 4
        h = torch.zeros(B, H, dtype=onehot.dtype, device=onehot.device)
        c = torch.zeros_like(h)
        hs = []
        for x in x_seq:
            h, c = lstm_cell(lp, x, (h, c))
            hs.append(h)
        x_seq = torch.stack(hs)                               # [T, B, H]
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
