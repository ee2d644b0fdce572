"""RMSNorm on Hopper: build, bind and launch ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``;
the source's header note gives the design and its bound. ``rmsnorm`` takes
x ``[..., D]`` and scale ``[D]`` (both float32 or both bfloat16) and
returns ``x * rsqrt(mean(x^2) + eps) * scale``, computed in fp32 and
stored in x's dtype.

``rmsnorm.launches`` counts the launches this wrapper made, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_FNS = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    lib = kbuild.load(SOURCE)
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, scale):
    """Refuse what the kernel does not take; the device check comes last,
    so every other refusal shows without a card."""
    if not isinstance(x, torch.Tensor) or not isinstance(scale, torch.Tensor):
        raise TypeError("rmsnorm kernel: takes torch tensors")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"rmsnorm kernel: x has shape {tuple(x.shape)}, "
                         f"want a non-empty [..., D]")
    D = x.shape[-1]
    rows = x.numel() // D
    if tuple(scale.shape) != (D,):
        raise ValueError(f"rmsnorm kernel: scale has shape "
                         f"{tuple(scale.shape)}, want ({D},)")
    if x.dtype not in _FNS:
        raise ValueError(f"rmsnorm kernel: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    if scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm kernel: scale is {scale.dtype}, x is "
                         f"{x.dtype}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel: x and scale must be contiguous")
    if rows >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel: {rows} rows of {D}, want fewer "
                         f"than 2**31 of each")
    for name, t in (("x", x), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"rmsnorm kernel: {name} is on {t.device}, not "
                             f"a CUDA device")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm kernel: scale on {scale.device}, x on "
                         f"{x.device}")
    return rows, D


def rmsnorm(x, scale, eps: float = 1e-6):
    """Launch the kernel on CUDA tensors x [..., D], scale [D]. Returns y
    like x. Raises on any other input."""
    rows, D = _check(x, scale)
    lib = build()
    y = torch.empty_like(x)
    # 16-byte loads when every row starts on a 16-byte boundary
    vec = D % (16 // x.element_size()) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scale, y))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _FNS[x.dtype])(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, D, eps,
            int(vec), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"(rows={rows} D={D} {x.dtype})")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
