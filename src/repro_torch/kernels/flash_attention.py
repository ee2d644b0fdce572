"""Flash attention on Hopper: build, bind and launch
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::_fa_kernel``;
the source's header note gives the design and its bound. As the Pallas
kernel, it is forward only and self-attention only (Sq == Skv, q aligned to
kv): q ``[B, S, H, hd]``, k/v ``[B, S, Kv, hd]`` with H a multiple of Kv
(query head h reads kv head ``h // (H // Kv)``), causal and/or a sliding
window, output like q.

``flash_attention.launches`` counts the launches this wrapper made, so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"

_FNS = {torch.float32: "flash_attention_f32",
        torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128)
_GRID_YZ = 65535                   # CUDA's limit on gridDim.y and .z


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = kbuild.load(SOURCE)
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window):
    """Refuse what the kernel does not take; the device check comes last,
    so every other refusal shows without a card."""
    ts = {"q": q, "k": k, "v": v}
    if not all(isinstance(t, torch.Tensor) for t in ts.values()):
        raise TypeError("flash_attention kernel: takes torch tensors")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention kernel: q and k must be 4-D")
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    if tuple(k.shape) != (B, S, Kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want k and "
                         f"v [B, S, Kv, hd] with q's B, S and hd (Sq == Skv)")
    if min(B, S, H, Kv) < 1 or H % Kv:
        raise ValueError(f"flash_attention kernel: H={H} is not a positive "
                         f"multiple of Kv={Kv} (or a dimension is empty)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {hd} not "
                         f"supported {HEAD_DIMS}")
    if B > _GRID_YZ or Kv > _GRID_YZ or B * S * H * hd >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: B={B} S={S} H={H} "
                         f"hd={hd} is too large")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention kernel: window {window!r}, want "
                         f"an int >= 0")
    if q.dtype not in _FNS:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not "
                         f"supported (float32, bfloat16)")
    for name, t in ts.items():
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             f"contiguous")
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} on {t.device}, "
                             f"q on {q.device}")
    return B, S, H, Kv, hd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel on CUDA tensors q [B,S,H,hd], k/v [B,S,Kv,hd].
    Returns the attention output like q. Raises on any other input."""
    B, S, H, Kv, hd = _check(q, k, v, window)
    lib = build()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _FNS[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Kv, hd, int(bool(causal)), window, 1.0 / math.sqrt(hd),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={B} S={S} H={H} Kv={Kv} hd={hd} "
                           f"{q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
