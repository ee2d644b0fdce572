"""Flash attention on Hopper: build, bind and launch
``csrc/flash_attention.cu`` (the forward) and ``csrc/flash_attention_bwd.cu``
(the backward).

``flash_attention`` replaces the Pallas kernel
``repro/kernels/flash_attention.py::_fa_kernel``; the source's header note
gives the design and its bound. As the Pallas kernel, it is self-attention
only (Sq == Skv, q aligned to kv): q ``[B, S, H, hd]``, k/v ``[B, S, Kv, hd]`` with H a multiple of Kv
(query head h reads kv head ``h // (H // Kv)``), causal and/or a sliding
window, output like q. With ``with_lse`` the launch also writes each row's
log-sum-exp, fp32 ``[B, H, S]``, for the backward
(``ops.FlashAttention``); without it the kernel gets a null pointer and
writes nothing more.

The dtype and the head width pick the kernel (``route``): bfloat16 up to
hd 192 runs on the tensor cores (``wgmma``, k/v tiles by TMA), float32 and
bfloat16 at 256 on the CUDA cores, whose fp32 products the fp32 tolerances
need, and any width above 256 on the CUDA-core kernel that sums over hd in
chunks. The kernels are built for the head widths ``HEAD_DIMS``; a width
between two of them is zero-padded to the next (``_padded``). Every element
offset is 64-bit, so one batch entry may hold 2^31 elements or more; a
batch is split into launches only past the grid's 65,535 entries
(``_batch_chunks``). ``flash_attention.launches`` counts the launches this
wrapper made, ``flash_attention.route_launches`` the same by route,
``flash_attention.padded_launches`` those on padded inputs and
``flash_attention.lse_launches`` those that wrote the log-sum-exp, so a run
can show that its path went through the kernel it expects.

``flash_attention_bwd`` is the backward (the kernel counterpart of
``repro/models/layers.py::_fa_bwd``, which the JAX package leaves to jnp):
from q, k, v, the forward's out and lse and the cotangent dout it gives dq,
dk and dv in two launches, dq (which also writes D = rowsum(dout * out))
then dk and dv, with no atomics. ``bwd_route`` picks the kernels by dtype
and head width: bfloat16 at hd 64 and 128 on the tensor cores (``wgmma``),
anything else on the CUDA cores, which take any width.
``flash_attention_bwd.launches`` counts its kernel launches (two a call) and
``flash_attention_bwd.route_launches`` the same by route.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / \
    "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

# the C function of each (dtype, route)
_FNS = {(torch.float32, "cuda_core"): "flash_attention_f32",
        (torch.float32, "hd_chunked"): "flash_attention_f32",
        (torch.bfloat16, "wgmma"): "flash_attention_bf16",
        (torch.bfloat16, "cuda_core"): "flash_attention_bf16_cc",
        (torch.bfloat16, "hd_chunked"): "flash_attention_bf16_cc"}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda_core"}  # hd <= 192
_ROUTE_NAMES = {"wgmma": "tensor-core kernel", "cuda_core": "CUDA-core kernel",
                "hd_chunked": "CUDA-core kernel, hd in chunks"}
HEAD_DIMS = (16, 32, 64, 128, 192, 256)  # the widths the kernels are built for
_WGMMA_DIMS = 192                  # the tensor-core kernel's widest
_GRID_YZ = 65535                   # CUDA's limit on gridDim.y and .z
# the tensor-core kernel keeps a (batch, kv head)'s folded rows in 32 bits,
# with room for a block's rounding past the last
_WGMMA_MAX_ROWS = 2 ** 31 - 256
# every kernel keeps positions in 32 bits, as the Pallas kernel does (its
# int32 iotas), with room for a tile's rounding past the last
_MAX_SEQ = 2 ** 31 - 1024
# the backward's C functions (dq launch, dk/dv launch) of each (dtype, route)
_BWD_FNS = {(torch.float32, "cuda_core"): ("flash_bwd_dq_f32",
                                           "flash_bwd_dkdv_f32"),
            (torch.bfloat16, "cuda_core"): ("flash_bwd_dq_bf16_cc",
                                            "flash_bwd_dkdv_bf16_cc"),
            (torch.bfloat16, "wgmma"): ("flash_bwd_dq_bf16",
                                        "flash_bwd_dkdv_bf16")}
BWD_WGMMA_DIMS = (64, 128)         # the tensor-core backward's widths
BWD_LAUNCHES = 2                   # kernel launches a backward call


@functools.cache
def build() -> dict:
    """Compile (once per source hash) and load the kernel library; the
    bound C function of each (dtype, route)."""
    lib = kbuild.load(SOURCE)
    fns = {}
    for key, name in _FNS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def route(dtype, hd: int, S: int, G: int) -> str:
    """The kernel a call of this dtype, head width, length and group size
    runs on: ``wgmma`` (bf16 up to hd 192 where its 32-bit rows hold the
    S * G folded rows of a kv head), ``cuda_core`` (any other width up to
    256) or ``hd_chunked`` (wider)."""
    if dtype == torch.bfloat16 and hd <= _WGMMA_DIMS and \
            S * G < _WGMMA_MAX_ROWS:
        return "wgmma"
    return "cuda_core" if hd <= HEAD_DIMS[-1] else "hd_chunked"


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
    if min(B, S, H, Kv, hd) < 1 or H % Kv:
        raise ValueError(f"flash_attention kernel: H={H} is not a positive "
                         f"multiple of Kv={Kv} (or a dimension is empty)")
    if S > _MAX_SEQ:
        raise ValueError(f"flash_attention kernel: S={S} positions; the "
                         f"kernels index positions in 32 bits, as the Pallas "
                         f"kernel does (at most {_MAX_SEQ})")
    if Kv > _GRID_YZ:
        raise ValueError(f"flash_attention kernel: Kv={Kv} is too large")
    path = route(q.dtype, hd, S, H // Kv)
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention kernel: window {window!r}, want "
                         f"an int >= 0")
    if q.dtype not in ROUTES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not "
                         f"supported (float32, bfloat16)")
    for name, t in ts.items():
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention kernel: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             f"contiguous")
    if path == "wgmma":
        # TMA reads k and v, 16-byte loads q; the output is allocated aligned
        for name, t in ts.items():
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention kernel: {name} is not "
                                 f"16-byte aligned ({q.dtype} runs the "
                                 f"{_ROUTE_NAMES[path]})")
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel ({q.dtype}: "
                             f"{_ROUTE_NAMES[path]}): {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} on {t.device}, "
                             f"q on {q.device}")
    return B, S, H, Kv, hd, path


def native_head_dim(hd: int) -> int:
    """The narrowest width in ``HEAD_DIMS`` that holds hd; above the widest,
    hd itself (the chunked kernel takes any width)."""
    return next((w for w in HEAD_DIMS if w >= hd), hd)


def _batch_chunks(B):
    """[(b0, b1), ...]: the launches that cover batch entries 0..B-1, at
    most CUDA's 65,535 grid rows each (the CUDA-core kernels' grid has one
    z per entry), as evenly split as they can be: one launch unless B is
    larger. Every offset in the kernels is 64-bit, so a launch may hold any
    number of elements; the rest of a grid (2^31 blocks along x) outgrows
    CUDA's limits only for tensors larger than an 80 GB card holds, and
    the C function refuses such a launch."""
    n = -(-B // _GRID_YZ)
    bounds = [B * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def _padded(attend, q, k, v, causal, window):
    """``attend(q, k, v, causal, window, scale)`` on q, k and v zero-padded
    along hd to ``native_head_dim(hd)``, with the true scale 1/sqrt(hd), and
    its output cut back to hd. The zero columns add exact zeros to every
    score (so a log-sum-exp is that of the unpadded scores), and the padded
    columns of v only reach the columns cut off."""
    hd = q.shape[-1]
    wide = native_head_dim(hd)
    scale = 1.0 / math.sqrt(hd)
    if wide == hd:
        return attend(q, k, v, causal, window, scale)
    q, k, v = (F.pad(t, (0, wide - hd)) for t in (q, k, v))
    return attend(q, k, v, causal, window, scale)[..., :hd].contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """Launch the kernel of q's dtype and head width on CUDA tensors q
    [B,S,H,hd], k/v [B,S,Kv,hd]. Returns the attention output like q, and
    with ``with_lse`` also each row's log-sum-exp, fp32 [B,H,S]. Raises on
    any other input."""
    B, S, H, Kv, hd, path = _check(q, k, v, window)
    fn = build()[q.dtype, path]
    padded = native_head_dim(hd) != hd
    lse = kbuild.empty(B, H, S, dtype=torch.float32, device=q.device) \
        if with_lse else None

    def attend(q, k, v, causal, window, scale):
        width = q.shape[-1]
        out = kbuild.empty_like(q)
        elem = q.element_size()
        q_entry, kv_entry = S * H * width * elem, S * Kv * width * elem
        lse_entry = H * S * 4
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            for b0, b1 in _batch_chunks(B):
                lse_p = None if lse is None else \
                    lse.data_ptr() + b0 * lse_entry
                err = fn(q.data_ptr() + b0 * q_entry,
                         k.data_ptr() + b0 * kv_entry,
                         v.data_ptr() + b0 * kv_entry,
                         out.data_ptr() + b0 * q_entry, lse_p, b1 - b0, S, H,
                         Kv, width, int(bool(causal)), window, scale, stream)
                if err != 0:
                    why = "CUDA error" if err > 0 else "TMA tensor map error"
                    raise RuntimeError(
                        f"flash_attention kernel launch failed: {why} {err} "
                        f"(batch {b0}..{b1 - 1} of B={B}, S={S} H={H} "
                        f"Kv={Kv} hd={hd} run at {width}, {q.dtype}, "
                        f"{_ROUTE_NAMES[path]})")
                flash_attention.launches += 1
                flash_attention.route_launches[path] += 1
                flash_attention.padded_launches += int(padded)
                flash_attention.lse_launches += int(with_lse)
        return out

    out = _padded(attend, q, k, v, causal, window)
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(_ROUTE_NAMES, 0)
flash_attention.padded_launches = 0
flash_attention.lse_launches = 0


@functools.cache
def build_bwd() -> dict:
    """Compile (once per source hash) and load the backward's library; the
    bound (dq, dk/dv) C functions of each (dtype, route)."""
    lib = kbuild.load(BWD_SOURCE)
    fns = {}
    for key, names in _BWD_FNS.items():
        pair = []
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
                [ctypes.c_longlong] + [ctypes.c_int] * 2 + \
                [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[key] = tuple(pair)
    return fns


def bwd_route(dtype, hd: int) -> str:
    """The backward kernels a call of this dtype and head width runs on:
    ``wgmma`` (bfloat16 at hd 64 or 128) or ``cuda_core`` (any other)."""
    if dtype == torch.bfloat16 and hd in BWD_WGMMA_DIMS:
        return "wgmma"
    return "cuda_core"


def _check_bwd(q, k, v, out, lse, dout, window):
    """Refuse what the backward kernels do not take; the device check comes
    last, so every other refusal shows without a card. Returns (B, S, H,
    Kv, hd, route)."""
    ts = {"q": q, "k": k, "v": v, "out": out, "dout": dout}
    if not all(isinstance(t, torch.Tensor) for t in (*ts.values(), lse)):
        raise TypeError("flash_attention_bwd kernel: takes torch tensors")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention_bwd kernel: q and k must be 4-D")
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    for name, want in (("k", (B, S, Kv, hd)), ("v", (B, S, Kv, hd)),
                       ("out", (B, S, H, hd)), ("dout", (B, S, H, hd)),
                       ("lse", (B, H, S))):
        t = lse if name == "lse" else ts[name]
        if tuple(t.shape) != want:
            raise ValueError(f"flash_attention_bwd kernel: {name} has shape "
                             f"{tuple(t.shape)}, want {want} (q "
                             f"{tuple(q.shape)}, Sq == Skv)")
    if min(B, S, H, Kv, hd) < 1 or H % Kv:
        raise ValueError(f"flash_attention_bwd kernel: H={H} is not a "
                         f"positive multiple of Kv={Kv} (or a dimension is "
                         f"empty)")
    if S > _MAX_SEQ:
        raise ValueError(f"flash_attention_bwd kernel: S={S} positions; the "
                         f"kernels index positions in 32 bits (at most "
                         f"{_MAX_SEQ})")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"flash_attention_bwd kernel: window {window!r}, "
                         f"want an int >= 0")
    if q.dtype not in ROUTES:
        raise ValueError(f"flash_attention_bwd kernel: dtype {q.dtype} not "
                         f"supported (float32, bfloat16)")
    for name, t in ts.items():
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd kernel: {name} is "
                             f"{t.dtype}, q is {q.dtype}")
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd kernel: lse is {lse.dtype}, "
                         f"want torch.float32")
    for name, t in (*ts.items(), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd kernel: {name} is not "
                             f"contiguous")
    path = bwd_route(q.dtype, hd)
    if path == "wgmma":
        # TMA reads q, k, v and dout, 16-byte loads out
        for name, t in ts.items():
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_bwd kernel: {name} is not "
                                 f"16-byte aligned ({q.dtype} hd {hd} runs "
                                 f"the {_ROUTE_NAMES[path]})")
    for name, t in (*ts.items(), ("lse", lse)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd kernel ({q.dtype} hd "
                             f"{hd}: {_ROUTE_NAMES[path]}): {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd kernel: {name} on "
                             f"{t.device}, q on {q.device}")
    return B, S, H, Kv, hd, path


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """Launch the backward kernels of q's dtype and head width on CUDA
    tensors q, out, dout [B,S,H,hd], k/v [B,S,Kv,hd] and the forward's lse
    fp32 [B,H,S]: the dq launch, then the dk/dv launch. Returns (dq, dk,
    dv) in q's, k's and v's dtype. Raises on any other input."""
    B, S, H, Kv, hd, path = _check_bwd(q, k, v, out, lse, dout, window)
    fn_dq, fn_dkdv = build_bwd()[q.dtype, path]
    dq, dk, dv = (kbuild.empty_like(t) for t in (q, k, v))
    dsum = kbuild.empty(B, H, S, dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for what, fn, ptrs in (
                ("dq", fn_dq, (q, k, v, out, dout, lse, dsum, dq)),
                ("dk/dv", fn_dkdv, (q, k, v, dout, lse, dsum, dk, dv))):
            err = fn(*(t.data_ptr() for t in ptrs), B, S, H, Kv, hd,
                     int(bool(causal)), window, scale, stream)
            if err != 0:
                why = "CUDA error" if err > 0 else "TMA tensor map error"
                raise RuntimeError(
                    f"flash_attention_bwd {what} kernel launch failed: {why} "
                    f"{err} (B={B} S={S} H={H} Kv={Kv} hd={hd}, {q.dtype}, "
                    f"{_ROUTE_NAMES[path]})")
            flash_attention_bwd.launches += 1
            flash_attention_bwd.route_launches[path] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = {"wgmma": 0, "cuda_core": 0}
