"""Device dispatch over the port's kernels.

A CPU tensor goes to the plain version (``ref``), any other tensor to the
hand-written kernel, whose wrapper launches it or raises. There is no
fallback: a card without a working kernel is an error, not a slow path.
"""
from __future__ import annotations

from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import ref


def lstm_cell(x, h, c, kernel, bias):
    if x.device.type == "cpu":
        return ref.lstm_cell(x, h, c, kernel, bias)
    return _lstm.lstm_cell(x, h, c, kernel, bias)
