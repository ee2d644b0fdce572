"""RMSNorm on Hopper: build, bind and launch ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``;
the source's header note gives the design and its bound. ``rmsnorm`` takes
x ``[..., D]`` and scale ``[D]`` (both float32 or both bfloat16) and
returns ``x * rsqrt(mean(x^2) + eps) * scale``, computed in fp32 and
stored in x's dtype.

``rmsnorm_bwd`` launches the backward for the cotangent dy of y: (dx like
x, dscale like scale), the formula's gradient in fp32, in one C call of two
launches (dx and each block's column partials of dscale, then the partials
added in a fixed order; no atomics, so two runs give the same bits). It
replaces ``jax.grad`` of ``repro/models/layers.py::apply_norm``, which the
JAX package runs as jnp. The C launcher picks the rows launch's tier and
grid, which fix its order of sums; the first backward kernels
(``rmsnorm_bwd_rows_*`` + ``rmsnorm_bwd_cols_*``) stay bound as its
yardstick (``build_bwd_yardstick``, ``rmsnorm_bwd_yardstick``).

``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count the launches each
wrapper made, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_FNS = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_BWD_FNS = {torch.float32: "rmsnorm_bwd_f32",
            torch.bfloat16: "rmsnorm_bwd_bf16"}
_YARDSTICK_BWD_FNS = {torch.float32: ("rmsnorm_bwd_rows_f32",
                                      "rmsnorm_bwd_cols_f32"),
                      torch.bfloat16: ("rmsnorm_bwd_rows_bf16",
                                       "rmsnorm_bwd_cols_bf16")}
_VEC = {torch.float32: 4, torch.bfloat16: 8}    # elements in 16 bytes
# the yardstick's blocks (at most; one a row below it): each walks a strip
# of rows and keeps one fp32 row of column partials
BWD_BLOCKS = 264
BWD_LAUNCHES = 2                   # kernel launches a backward call
# the rows of fp32 column partials the route's rows launch may write: the
# most blocks the C launcher gives any tier (csrc/rmsnorm.cu kBwdPartRows)
BWD_PART_ROWS = 396


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library; the
    bound C function of each dtype."""
    lib = kbuild.load(SOURCE)
    fns = {}
    for dtype, name in _FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


@functools.cache
def build_bwd() -> dict:
    """The backward's bound C function of each dtype."""
    lib = kbuild.load(SOURCE)
    fns = {}
    for dtype, name in _BWD_FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


@functools.cache
def build_bwd_yardstick() -> dict:
    """The yardstick's bound C functions of each dtype: (rows, cols)."""
    lib = kbuild.load(SOURCE)
    fns = {}
    for dtype, (rows_name, cols_name) in _YARDSTICK_BWD_FNS.items():
        rows_fn, cols_fn = getattr(lib, rows_name), getattr(lib, cols_name)
        rows_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        cols_fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        rows_fn.restype = cols_fn.restype = ctypes.c_int
        fns[dtype] = (rows_fn, cols_fn)
    return fns


def _check(x, scale):
    """Refuse what the kernel does not take, cheapest checks first; the
    device check comes last, so every other refusal shows without a card."""
    if not isinstance(x, torch.Tensor) or not isinstance(scale, torch.Tensor):
        raise TypeError("rmsnorm kernel: takes torch tensors")
    dtype = x.dtype
    if dtype not in _FNS:
        raise ValueError(f"rmsnorm kernel: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    if scale.dtype != dtype:
        raise ValueError(f"rmsnorm kernel: scale is {scale.dtype}, x is "
                         f"{dtype}")
    shape = x.shape
    n = x.numel()
    if not shape or n == 0:
        raise ValueError(f"rmsnorm kernel: x has shape {tuple(shape)}, "
                         f"want a non-empty [..., D]")
    D = shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm kernel: scale has shape "
                         f"{tuple(scale.shape)}, want ({D},)")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm kernel: x and scale must be contiguous")
    rows = n // D
    if rows >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel: {rows} rows of {D}, want fewer "
                         f"than 2**31 of each")
    if not x.is_cuda or not scale.is_cuda:
        for name, t in (("x", x), ("scale", scale)):
            if not t.is_cuda:
                raise ValueError(f"rmsnorm kernel: {name} is on {t.device}, "
                                 f"not a CUDA device")
    if scale.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel: scale on {scale.device}, x on "
                         f"{x.device}")
    return rows, D


def rmsnorm(x, scale, eps: float = 1e-6):
    """Launch the kernel on CUDA tensors x [..., D], scale [D]. Returns y
    like x. Raises on any other input.

    The launch path is lean, since at decode rows ([4, 8192]) the device
    works ~3 us and the call's cost is host time: the C function is bound
    once per dtype, y skips deterministic mode's NaN fill (a launch of its
    own), the stream is read raw (``torch.cuda.current_stream`` builds a
    Stream object), and the device context is entered only when x is not
    on the current device."""
    rows, D = _check(x, scale)
    fn = build()[x.dtype]
    y = kbuild.empty_like(x)
    xp, sp, yp = x.data_ptr(), scale.data_ptr(), y.data_ptr()
    # 16-byte loads when every row starts on a 16-byte boundary
    vec = D % _VEC[x.dtype] == 0 and (xp | sp | yp) % 16 == 0
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        err = fn(xp, sp, yp, rows, D, eps, vec,
                 torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(xp, sp, yp, rows, D, eps, vec,
                     torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"(rows={rows} D={D} {x.dtype})")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def _check_bwd(x, scale, dy):
    """``_check`` of x and scale, then dy: x's shape, dtype and device,
    contiguous; the device check last."""
    if not all(isinstance(t, torch.Tensor) for t in (x, scale, dy)):
        raise TypeError("rmsnorm backward kernel: takes torch tensors")
    if dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm backward kernel: dy is {dy.dtype}, x is "
                         f"{x.dtype}")
    if dy.shape != x.shape:
        raise ValueError(f"rmsnorm backward kernel: dy has shape "
                         f"{tuple(dy.shape)}, x {tuple(x.shape)}")
    if not dy.is_contiguous():
        raise ValueError("rmsnorm backward kernel: dy must be contiguous")
    rows, D = _check(x, scale)
    if not dy.is_cuda or dy.get_device() != x.get_device():
        raise ValueError(f"rmsnorm backward kernel: dy on {dy.device}, x on "
                         f"{x.device}")
    return rows, D


# the fp32 column partials of each (device, stream): reused call after
# call, since the launches of one stream run in order, and grown as needed
_PART = {}


def _part(dev: int, stream: int, n: int):
    buf = _PART.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = kbuild.empty(n, dtype=torch.float32, device=f"cuda:{dev}")
        _PART[dev, stream] = buf
    return buf


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """Launch the backward on CUDA tensors x [..., D], scale [D] and the
    cotangent dy like x: one C call, which launches the rows kernel of the
    row's tier (dx, and each block's fp32 column partials of dscale) and
    then the cols kernel (dscale). Returns (dx like x, dscale like scale).
    Raises on any other input or a failed launch.

    As ``rmsnorm``'s, the launch path is lean: two allocations (dx,
    dscale; the partials' buffer is the stream's, ``_part``), one ctypes
    call, and the device context entered only when x is not on the current
    device."""
    rows, D = _check_bwd(x, scale, dy)
    dtype = x.dtype
    fn = build_bwd()[dtype]
    dx, dscale = kbuild.empty_likes(x, scale)
    ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr())
    vec = D % _VEC[dtype] == 0 and (ptrs[0] | ptrs[1] | ptrs[2] |
                                    ptrs[3]) % 16 == 0
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    args = (*ptrs, dscale.data_ptr(),
            _part(dev, stream, BWD_PART_ROWS * D).data_ptr(), rows, D, eps,
            vec, stream)
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA "
                           f"error {err} (rows={rows} D={D} {x.dtype})")
    rmsnorm_bwd.launches += BWD_LAUNCHES
    return dx, dscale


rmsnorm_bwd.launches = 0


def rmsnorm_bwd_yardstick(x, scale, dy, eps: float = 1e-6):
    """The first backward kernels, kept as the route's yardstick:
    the rows launch (dx and min(rows, ``BWD_BLOCKS``) blocks' column
    partials), then the cols launch (dscale), two ctypes calls and three
    allocations, as the route ran until the redesign. For comparisons
    only: no path calls it, and it counts no launch."""
    rows, D = _check_bwd(x, scale, dy)
    rows_fn, cols_fn = build_bwd_yardstick()[x.dtype]
    dx = kbuild.empty_like(x)
    dscale = kbuild.empty_like(scale)
    blocks = min(rows, BWD_BLOCKS)
    part = kbuild.empty(blocks, D, dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr())
    vec = D % _VEC[x.dtype] == 0 and all(p % 16 == 0 for p in ptrs)
    with torch.cuda.device(x.device):
        stream = torch._C._cuda_getCurrentRawStream(x.get_device())
        err = rows_fn(*ptrs, part.data_ptr(), rows, D, blocks, eps, vec,
                      stream)
        if err == 0:
            err = cols_fn(part.data_ptr(), dscale.data_ptr(), blocks, D,
                          stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward yardstick launch failed: CUDA "
                           f"error {err} (rows={rows} D={D} {x.dtype})")
    return dx, dscale
