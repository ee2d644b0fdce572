"""TernGrad 2-bit codec on Hopper: build, bind and launch ``csrc/ternary.cu``.

Replaces the Pallas kernels ``repro/kernels/ternary.py::_encode_kernel`` and
``::_decode_kernel``; the source's header note gives the design and its
bound. ``ternary_encode`` packs a flat fp32 gradient into the 2-bit byte
stream the wire protocol ships, ``ternary_decode`` unpacks it to ``±s``/0.
As in the JAX package, N must be a multiple of 4: the codec
(``repro_torch/optim/compression.py``) pads each leaf before it calls these.

The scale ``s`` stays on the card as a one-element fp32 tensor, so computing
it (a plain ``max|g|`` reduction) and encoding never wait on the host.

``ternary_encode.launches`` and ``ternary_decode.launches`` count the
launches these wrappers made, so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ternary.cu"


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = kbuild.load(SOURCE)
    for name in ("ternary_encode_f32", "ternary_decode_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, dtype, s, multiple=1):
    """Refuse what the kernel does not take: the type, shape and layout
    checks come before the device check, so every refusal can be shown
    without a card."""
    if not isinstance(x, torch.Tensor) or not isinstance(s, torch.Tensor):
        raise TypeError(f"{name} kernel: takes torch tensors")
    if x.dtype != dtype:
        raise ValueError(f"{name} kernel: input is {x.dtype}, want {dtype}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"{name} kernel: scale must be one float32 value, "
                         f"got {s.dtype}{list(s.shape)}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} kernel: input must be 1-D and contiguous")
    n = x.numel()
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"{name} kernel: {n} elements, want 1 to 2**31 - 1")
    if n % multiple:
        raise ValueError(f"{name} kernel: N={n} is not a multiple of "
                         f"{multiple}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel: input is on {x.device}, not a CUDA "
                         f"device")
    if s.device != x.device:
        raise ValueError(f"{name} kernel: scale on {s.device}, input on "
                         f"{x.device}")


def _launch(fn_name, src, s, out, n_bytes):
    lib = build()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(lib, fn_name)(src.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), n_bytes, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} "
                           f"({n_bytes} packed bytes)")


def ternary_encode(g_flat, s):
    """g_flat fp32 [N] (N % 4 == 0), s one fp32 value, both on one CUDA
    device -> packed uint8 [N/4]. Raises on any other input."""
    _check("ternary_encode", g_flat, torch.float32, s, multiple=4)
    n = g_flat.numel()
    out = torch.empty(n // 4, dtype=torch.uint8, device=g_flat.device)
    _launch("ternary_encode_f32", g_flat, s, out, n // 4)
    ternary_encode.launches += 1
    return out


def ternary_decode(packed, s):
    """packed uint8 [N/4], s one fp32 value, both on one CUDA device ->
    fp32 [N] of ``+s``, ``-s`` and ``+0.0``. Raises on any other input."""
    _check("ternary_decode", packed, torch.uint8, s)
    n_bytes = packed.numel()
    out = torch.empty(4 * n_bytes, dtype=torch.float32, device=packed.device)
    _launch("ternary_decode_f32", packed, s, out, n_bytes)
    ternary_decode.launches += 1
    return out


ternary_encode.launches = 0
ternary_decode.launches = 0
