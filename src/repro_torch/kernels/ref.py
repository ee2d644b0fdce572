"""Plain PyTorch versions of the port's kernels (the allclose references).

Each computes exactly what its kernel computes, in the most literal form, so
a kernel bug cannot hide behind a mirrored bug here. The CPU path runs these;
``chip_smoke.py`` holds each kernel against its plain version on the card.
"""
from __future__ import annotations

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
