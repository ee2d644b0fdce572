"""The fused LSTM cell on Hopper: build, bind and launch ``csrc/lstm_cell.cu``.

Replaces the Pallas kernel ``repro/kernels/lstm_cell.py::_cell_kernel``; the
source's header note gives the design and its bound. Three entry points:
``lstm_cell`` runs one step (the Pallas kernel's own contract),
``lstm_seq`` runs a whole sequence of steps in one launch, bit-equal to
chained ``lstm_cell`` launches, and ``lstm_seq_bwd`` runs the sequence's
backpropagation through time in one launch (the backward of the JAX
package's ``lax.scan``, ``repro/models/lstm.py:68``); the model runs
``lstm_seq`` forward and ``lstm_seq_bwd`` backward. The shared library is
compiled with ``nvcc`` for ``sm_90a`` at first use (``kernels/build.py``)
and bound with ``ctypes`` through a plain C interface.

``lstm_cell.launches``, ``lstm_seq.launches`` and ``lstm_seq_bwd.launches``
count the launches each wrapper made, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "lstm_cell.cu"

_FNS = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}
_SEQ_FNS = {torch.float32: "lstm_seq_f32", torch.bfloat16: "lstm_seq_bf16"}
_BWD_FNS = {torch.float32: "lstm_seq_bwd_f32",
            torch.bfloat16: "lstm_seq_bwd_bf16"}


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = kbuild.load(SOURCE)
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _SEQ_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD_FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, h, c, kernel, bias, what="lstm_cell"):
    """Refuse what the kernel does not take: x [B,Din] (``lstm_seq``:
    [T,B,Din]), h/c [B,H], kernel [Din+H,4H], bias [4H], one dtype,
    contiguous, on one CUDA device (checked last). Returns (B, Din, H)."""
    ts = {"x": x, "h": h, "c": c, "kernel": kernel, "bias": bias}
    x_dims = 3 if what == "lstm_seq" else 2
    if x.dim() != x_dims or h.dim() != 2:
        raise ValueError(f"{what} kernel: x must be {x_dims}-D and h 2-D")
    B, Din = x.shape[-2:]
    H = h.shape[1]
    if min(x.shape) < 1 or H < 1:
        raise ValueError(f"{what} kernel: empty shape x "
                         f"{tuple(x.shape)} H={H}")
    want = {"h": (B, H), "c": (B, H), "kernel": (Din + H, 4 * H),
            "bias": (4 * H,)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{what} kernel: {name} has shape "
                             f"{tuple(ts[name].shape)}, want {shape}")
    if x.dtype not in _FNS:
        raise ValueError(f"{what} kernel: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in ts.items():
        if t.dtype != x.dtype:
            raise ValueError(f"{what} kernel: {name} is {t.dtype}, "
                             f"x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} is not contiguous")
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what} kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"{what} kernel: {name} on {t.device}, "
                             f"x on {x.device}")
    return B, Din, H


def lstm_cell(x, h, c, kernel, bias):
    """Launch the kernel on CUDA tensors: x [B,Din], h/c [B,H],
    kernel [Din+H, 4H], bias [4H], all float32 or all bfloat16, contiguous.
    Returns (h_new, c_new) in the input dtype. Raises on any other input."""
    B, Din, H = _check(x, h, c, kernel, bias)
    lib = build()
    h_out = kbuild.empty_like(h)
    c_out = kbuild.empty_like(c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _FNS[x.dtype])(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), kernel.data_ptr(),
            bias.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            B, Din, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error "
                           f"{err} (B={B} Din={Din} H={H} {x.dtype})")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0


def lstm_seq(x_seq, h0, c0, kernel, bias):
    """Launch the sequence kernel on CUDA tensors: x_seq [T,B,Din], h0/c0
    [B,H], kernel [Din+H, 4H], bias [4H], all float32 or all bfloat16,
    contiguous. Returns (hs, cs, gates): hs and cs [T,B,H] in the input
    dtype, gates [T,B,4H] float32 (sigmoid(i), sigmoid(f), tanh(g),
    sigmoid(o) of every step). Raises on any other input."""
    B, Din, H = _check(x_seq, h0, c0, kernel, bias, what="lstm_seq")
    n_t = x_seq.shape[0]
    lib = build()
    hs = kbuild.empty(n_t, B, H, dtype=x_seq.dtype, device=x_seq.device)
    cs = kbuild.empty(n_t, B, H, dtype=x_seq.dtype, device=x_seq.device)
    gates = kbuild.empty(n_t, B, 4 * H, dtype=torch.float32,
                         device=x_seq.device)
    with torch.cuda.device(x_seq.device):
        stream = torch.cuda.current_stream(x_seq.device).cuda_stream
        err = getattr(lib, _SEQ_FNS[x_seq.dtype])(
            x_seq.data_ptr(), h0.data_ptr(), c0.data_ptr(), kernel.data_ptr(),
            bias.data_ptr(), hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            n_t, B, Din, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq kernel launch failed: CUDA error {err} "
                           f"(T={n_t} B={B} Din={Din} H={H} {x_seq.dtype})")
    lstm_seq.launches += 1
    return hs, cs, gates


lstm_seq.launches = 0


def _check_bwd(dhs, gates, cs, c0, w_h):
    """Refuse what the backward kernel does not take: dhs and cs [T,B,H],
    c0 [B,H] and w_h [H,4H] in one dtype (float32 or bfloat16), gates
    [T,B,4H] float32, contiguous, on one CUDA device (checked last).
    Returns (T, B, H)."""
    ts = {"dhs": dhs, "gates": gates, "cs": cs, "c0": c0, "w_h": w_h}
    if dhs.dim() != 3:
        raise ValueError("lstm_seq_bwd kernel: dhs must be 3-D [T,B,H]")
    n_t, B, H = dhs.shape
    if min(n_t, B, H) < 1:
        raise ValueError(f"lstm_seq_bwd kernel: empty shape dhs "
                         f"{tuple(dhs.shape)}")
    want = {"gates": (n_t, B, 4 * H), "cs": (n_t, B, H), "c0": (B, H),
            "w_h": (H, 4 * H)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"lstm_seq_bwd kernel: {name} has shape "
                             f"{tuple(ts[name].shape)}, want {shape}")
    if dhs.dtype not in _BWD_FNS:
        raise ValueError(f"lstm_seq_bwd kernel: dtype {dhs.dtype} not "
                         f"supported (float32, bfloat16)")
    for name, t in ts.items():
        want_dtype = torch.float32 if name == "gates" else dhs.dtype
        if t.dtype != want_dtype:
            raise ValueError(f"lstm_seq_bwd kernel: {name} is {t.dtype}, "
                             f"want {want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_seq_bwd kernel: {name} is not "
                             f"contiguous")
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"lstm_seq_bwd kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != dhs.device:
            raise ValueError(f"lstm_seq_bwd kernel: {name} on {t.device}, "
                             f"dhs on {dhs.device}")
    return n_t, B, H


def lstm_seq_bwd(dhs, gates, cs, c0, w_h):
    """Launch the backpropagation-through-time kernel on CUDA tensors: the
    cotangent dhs [T,B,H] of the forward's hs, its saved gates [T,B,4H]
    (float32) and cs [T,B,H], c0 [B,H] and w_h = kernel[Din:] [H,4H].
    Returns (dz [T,B,4H], dh0 [B,H], dc0 [B,H]), all float32: the gate
    pre-activations' gradients of every step and the gradients of the
    initial state. Raises on any other input."""
    n_t, B, H = _check_bwd(dhs, gates, cs, c0, w_h)
    lib = build()
    dev = dhs.device
    dz = kbuild.empty(n_t, B, 4 * H, dtype=torch.float32, device=dev)
    dh0 = kbuild.empty(B, H, dtype=torch.float32, device=dev)
    dc0 = kbuild.empty(B, H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _BWD_FNS[dhs.dtype])(
            dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            w_h.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            n_t, B, H, stream)
    if err != 0:
        raise RuntimeError(f"lstm_seq_bwd kernel launch failed: CUDA error "
                           f"{err} (T={n_t} B={B} H={H} {dhs.dtype})")
    lstm_seq_bwd.launches += 1
    return dz, dh0, dc0


lstm_seq_bwd.launches = 0
