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
hd 256 runs on the tensor cores (``wgmma``, k/v tiles by TMA; at 33-192
on ``flash_kernel_wgmma_pipe``, warpgroups of 64 rows with no producer
warp, q by TMA too, each tile's softmax under the previous tile's P.V:
two warpgroups at hd 64 and 192, three at 128, where a kv head with one
query head keeps ``flash_kernel_wgmma<128, 64>``, which ran hd 33-192
before; that kernel at hd 64, 128 and 192 stays bound through a C
function of its own as the pipe's yardstick, ``wgmma_yardstick``, which
no route calls), and above 256 on
the tensor-core kernel that sums the scores over hd in 64-column chunks
and owns a block of 128 output columns (``wgmma_chunked``);
float32 runs on the tensor cores at every width (``tf32x3``): each fp32
operand split into TF32 hi and lo parts, each product as three TF32
products, hi hi' + hi lo' + lo hi', in short chains added in fp32, which
keeps the fp32 tolerances (one TF32 product would break them); q, k and v
stream in 32-column chunks, a block owns 64 rows of one query head and 128
to 512 output columns. The CUDA-core kernels that float32 ran on before
(``cuda_core`` up to 256, ``hd_chunked`` above) stay bound as its
yardstick, and bfloat16 whose kv head holds 2^31 - 256 folded rows or more
still takes them (the bfloat16 tensor-core kernels keep folded rows in 32
bits). The bfloat16 kernels are built for the head widths ``HEAD_DIMS`` up
to 256; a width between two of them is zero-padded to the next, a
bfloat16 width above 256 to the next multiple of 64 and a float32 width to
the next multiple of 32 (``_pad_call``). Every element offset is 64-bit,
so one batch entry may hold 2^31 elements or more; a batch is split into
launches only past the grid's 65,535 entries (``_batch_chunks``).
``flash_attention.launches`` counts the launches this
wrapper made, ``flash_attention.route_launches`` the same by route,
``flash_attention.padded_launches`` those on padded inputs and
``flash_attention.lse_launches`` those that wrote the log-sum-exp, so a run
can show that its path went through the kernel it expects.

``flash_attention_bwd`` is the backward (the kernel counterpart of
``repro/models/layers.py::_fa_bwd``, which the JAX package leaves to jnp):
from q, k, v, the forward's out and lse and the cotangent dout it gives dq,
dk and dv in two launches, dq (which also writes D = rowsum(dout * out))
then dk and dv, with no atomics. ``bwd_route`` picks the kernels by dtype
and head width: bfloat16 up to hd 256 on the tensor cores (``wgmma``,
built for the widths ``BWD_WGMMA_DIMS``; a width between two of them is
zero-padded to the next, ``_pad_call``; at hd 64 and 128 with G > 1 query
heads a kv head the dk/dv launch splits each kv tile's iterations between
two warpgroups, and between the two blocks of a cluster while the kv tiles
are fewer than the card's SMs, and at hd 128 the dq launch takes two (q
tile, query head) units a block over one stream of k and v; the
one-warpgroup pair they replaced stays bound as their yardstick,
``wgmma_yardstick``, which no route reaches), bfloat16 above 256 on the
tensor-core kernels that sum over hd in 64-column chunks and own a block
of output columns (``wgmma_chunked``; the width zero-padded to a multiple
of 64), float32 at every width on the tensor cores as well (``tf32x3``:
each fp32 operand split into TF32 hi and lo parts, each product as three
TF32 products, hi hi' + hi lo' + lo hi', summed in fp32 in short chains,
which keeps the fp32 tolerances; the width zero-padded to a multiple of
32, one 32-column chunk; the split is the forward's). The CUDA-core pair
that fp32 ran on before (``cuda_core``) stays bound as a yardstick; no
route reaches it.
``flash_attention_bwd.launches`` counts its kernel launches (two a call),
``flash_attention_bwd.route_launches`` the same by route and
``flash_attention_bwd.padded_launches`` those on zero-padded inputs.
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

# the C function of each (dtype, route); fp32's CUDA-core kernels (one C
# function, any width) are no route's since tf32x3, but stay bound as its
# yardstick, and so does flash_kernel_wgmma<HD, 64> at hd 64, 128 and 192
# (one C function of its own, those widths only), which bf16 ran on there
# before flash_kernel_wgmma_pipe
_FNS = {(torch.float32, "tf32x3"): "flash_attention_f32_tf32x3",
        (torch.float32, "cuda_core"): "flash_attention_f32",
        (torch.bfloat16, "wgmma"): "flash_attention_bf16",
        (torch.bfloat16, "wgmma_chunked"): "flash_attention_bf16",
        (torch.bfloat16, "cuda_core"): "flash_attention_bf16_cc",
        (torch.bfloat16, "hd_chunked"): "flash_attention_bf16_cc",
        (torch.bfloat16, "wgmma_yardstick"):
            "flash_attention_bf16_yardstick"}
# the widths flash_attention_bf16_yardstick takes
YARDSTICK_DIMS = (64, 128, 192)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}  # up to hd 256
_ROUTE_NAMES = {"wgmma": "tensor-core kernel",
                "wgmma_chunked": "tensor-core kernel, hd in column blocks",
                "tf32x3": "tensor-core kernel, fp32 as three TF32 products",
                "cuda_core": "CUDA-core kernel",
                "hd_chunked": "CUDA-core kernel, hd in chunks"}
_TC_ROUTES = ("wgmma", "wgmma_chunked", "tf32x3")
# the backward's routes (every one reads its inputs by TMA)
_BWD_ROUTE_NAMES = {key: _ROUTE_NAMES[key] for key in _TC_ROUTES}
HEAD_DIMS = (16, 32, 64, 128, 192, 256)  # the widths the kernels are built for
_WIDE_STEP = 64    # bf16 above 256: hd padded to a multiple of one q/k chunk
_X3_STEP = 32      # fp32 (tf32x3): hd padded to a multiple of one chunk
_GRID_YZ = 65535                   # CUDA's limit on gridDim.y and .z
# the tensor-core kernel keeps a (batch, kv head)'s folded rows in 32 bits,
# with room for a block's rounding past the last
_WGMMA_MAX_ROWS = 2 ** 31 - 256
# every kernel keeps positions in 32 bits, as the Pallas kernel does (its
# int32 iotas), with room for a tile's rounding past the last
_MAX_SEQ = 2 ** 31 - 1024
# the backward's C functions (dq launch, dk/dv launch) of each (dtype, route),
# and of the yardstick of bf16 at hd 64 and 128 (no route's): the
# one-warpgroup pair that the two-warpgroup kernels replaced
_BWD_FNS = {(torch.float32, "tf32x3"): ("flash_bwd_dq_f32_tf32x3",
                                        "flash_bwd_dkdv_f32_tf32x3"),
            (torch.float32, "cuda_core"): ("flash_bwd_dq_f32",
                                           "flash_bwd_dkdv_f32"),
            (torch.bfloat16, "cuda_core"): ("flash_bwd_dq_bf16_cc",
                                            "flash_bwd_dkdv_bf16_cc"),
            (torch.bfloat16, "wgmma"): ("flash_bwd_dq_bf16",
                                        "flash_bwd_dkdv_bf16"),
            (torch.bfloat16, "wgmma_chunked"): ("flash_bwd_dq_bf16",
                                                "flash_bwd_dkdv_bf16"),
            (torch.bfloat16, "wgmma_yardstick"): (
                "flash_bwd_dq_bf16_yardstick",
                "flash_bwd_dkdv_bf16_yardstick")}
BWD_WGMMA_DIMS = (64, 128, 192, 256)   # the tensor-core backward's widths
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
    runs on: fp32 on ``tf32x3`` at every width and length (its blocks take
    one query head's positions, which ``_check`` keeps within 32 bits, so
    it has no folded-row limit); bf16 where its 32-bit rows hold the S * G
    folded rows of a kv head on the tensor cores, ``wgmma`` up to hd 256
    and ``wgmma_chunked`` above, otherwise on the CUDA cores,
    ``cuda_core`` up to 256 and ``hd_chunked`` above."""
    if dtype != torch.bfloat16:
        return "tf32x3"
    narrow = hd <= HEAD_DIMS[-1]
    if S * G < _WGMMA_MAX_ROWS:
        return "wgmma" if narrow else "wgmma_chunked"
    return "cuda_core" if narrow else "hd_chunked"


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
    if path in _TC_ROUTES:
        # TMA reads k and v (fp32 and bf16 at 129-192: q too), 16-byte loads
        # q; the output is allocated aligned
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


def native_head_dim(hd: int, dtype=torch.float32) -> int:
    """The width a call of this dtype runs hd at: float32 the next multiple
    of 32 (``tf32x3`` streams hd in 32-column chunks); bfloat16 the
    narrowest width in ``HEAD_DIMS`` that holds hd, above the widest the
    next multiple of 64 (the column-block kernel streams q and k in
    64-column chunks)."""
    if dtype != torch.bfloat16:
        return -(-hd // _X3_STEP) * _X3_STEP
    if hd > HEAD_DIMS[-1]:
        return -(-hd // _WIDE_STEP) * _WIDE_STEP
    return next(w for w in HEAD_DIMS if w >= hd)


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


def _pad_call(fn, ins, wide, *rest):
    """``fn(*ins, *rest, scale)`` on the tensors ``ins`` zero-padded along
    their last dimension, hd, to ``wide``, with the true scale 1/sqrt(hd),
    and every tensor it returns cut back to hd. The zero columns add exact
    zeros to every score, to dP and to D = rowsum(dout * out), so a
    log-sum-exp and every P and dS are the unpadded ones; the padded
    columns of v, dout and q or k only reach the output columns cut off.
    The forward pads to ``native_head_dim``, the backward to
    ``bwd_head_dim``."""
    hd = ins[0].shape[-1]
    scale = 1.0 / math.sqrt(hd)
    if wide == hd:
        return fn(*ins, *rest, scale)
    res = fn(*(F.pad(t, (0, wide - hd)) for t in ins), *rest, scale)
    if isinstance(res, torch.Tensor):
        return res[..., :hd].contiguous()
    return tuple(t[..., :hd].contiguous() for t in res)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    with_lse: bool = False):
    """Launch the kernel of q's dtype and head width on CUDA tensors q
    [B,S,H,hd], k/v [B,S,Kv,hd]. Returns the attention output like q, and
    with ``with_lse`` also each row's log-sum-exp, fp32 [B,H,S]. Raises on
    any other input."""
    B, S, H, Kv, hd, path = _check(q, k, v, window)
    fn = build()[q.dtype, path]
    padded = native_head_dim(hd, q.dtype) != hd
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

    out = _pad_call(attend, (q, k, v), native_head_dim(hd, q.dtype), causal,
                    window)
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
    ``wgmma`` (bfloat16 up to hd 256), ``wgmma_chunked`` (bfloat16 above
    256) or ``tf32x3`` (float32, every width)."""
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "wgmma" if hd <= BWD_WGMMA_DIMS[-1] else "wgmma_chunked"


def bwd_head_dim(hd: int, dtype) -> int:
    """The width the backward's kernels run hd at: on ``wgmma`` the
    narrowest of ``BWD_WGMMA_DIMS`` that holds it, on ``wgmma_chunked`` the
    next multiple of 64 (the kernels stream hd in 64-column chunks), on
    ``tf32x3`` the next multiple of 32 (32-column chunks)."""
    path = bwd_route(dtype, hd)
    if path == "wgmma":
        return next(w for w in BWD_WGMMA_DIMS if w >= hd)
    step = _WIDE_STEP if path == "wgmma_chunked" else _X3_STEP
    return -(-hd // step) * step


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
    if bwd_head_dim(hd, q.dtype) == hd:
        # TMA reads q, k, v and dout, 16-byte loads out (a padded width
        # reads the padded copies, which are allocated aligned)
        for name, t in ts.items():
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_bwd kernel: {name} is not "
                                 f"16-byte aligned ({q.dtype} hd {hd} runs "
                                 f"the {_BWD_ROUTE_NAMES[path]})")
    for name, t in (*ts.items(), ("lse", lse)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd kernel ({q.dtype} hd "
                             f"{hd}: {_BWD_ROUTE_NAMES[path]}): {name} is on "
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
    padded = bwd_head_dim(hd, q.dtype) != hd
    dsum = kbuild.empty(B, H, S, dtype=torch.float32, device=q.device)

    def backward(q, k, v, out, dout, lse, causal, window, scale):
        width = q.shape[-1]
        dq, dk, dv = (kbuild.empty_like(t) for t in (q, k, v))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            for what, fn, ptrs in (
                    ("dq", fn_dq, (q, k, v, out, dout, lse, dsum, dq)),
                    ("dk/dv", fn_dkdv, (q, k, v, dout, lse, dsum, dk, dv))):
                err = fn(*(t.data_ptr() for t in ptrs), B, S, H, Kv, width,
                         int(bool(causal)), window, scale, stream)
                if err != 0:
                    why = "CUDA error" if err > 0 else "TMA tensor map error"
                    raise RuntimeError(
                        f"flash_attention_bwd {what} kernel launch failed: "
                        f"{why} {err} (B={B} S={S} H={H} Kv={Kv} hd={hd} run "
                        f"at {width}, {q.dtype}, {_BWD_ROUTE_NAMES[path]})")
                flash_attention_bwd.launches += 1
                flash_attention_bwd.route_launches[path] += 1
                flash_attention_bwd.padded_launches += int(padded)
        return dq, dk, dv

    return _pad_call(backward, (q, k, v, out, dout),
                     bwd_head_dim(hd, q.dtype), lse, causal, window)


flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(_BWD_ROUTE_NAMES, 0)
flash_attention_bwd.padded_launches = 0
