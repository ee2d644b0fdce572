"""The fused LSTM cell on Hopper: build, bind and launch ``csrc/lstm_cell.cu``.

Replaces the Pallas kernel ``repro/kernels/lstm_cell.py::_cell_kernel``; the
source's header note gives the design and its bound. Three entry points:
``lstm_cell`` runs one step (the Pallas kernel's own contract),
``lstm_seq`` runs a whole sequence of steps in one launch, bit-equal to
chained ``lstm_cell`` launches, and ``lstm_seq_bwd`` runs the sequence's
backpropagation through time in one launch (the backward of the JAX
package's ``lax.scan``, ``repro/models/lstm.py:68``); the model runs
``lstm_seq`` forward and ``lstm_seq_bwd`` backward. The backward runs
``lstm_seq_bwd_staged_kernel`` on the register tier (``bwd_tier``: the
paper's layers) and ``lstm_seq_bwd_kernel`` above it; the latter stays
bound at every width as the yardstick (``lstm_seq_bwd_yardstick``), and
``lstm_seq_bwd_stamps`` times either one's steps by the SM's clock. The
shared library is compiled with ``nvcc`` for ``sm_90a`` at first use
(``kernels/build.py``) and bound with ``ctypes`` through a plain C
interface.

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
_BWD_YARDSTICK_FNS = {torch.float32: "lstm_seq_bwd_yardstick_f32",
                      torch.bfloat16: "lstm_seq_bwd_yardstick_bf16"}
_BWD_STAMPS_FN = "lstm_seq_bwd_stamps_f32"
# the backward's register tier (csrc/lstm_cell.cu bwd_reg_tier): the 4H
# columns, rounded up to a warp, fit one block of 256 threads and H <= 64
BWD_REG_THREADS, BWD_REG_COLS = 256, 64
# the stamps of a step (csrc/lstm_cell.cu kStampPhases): its start, the gate
# update done, past the barrier, the dh_next chains done, the shuffles done
STAMP_PHASES = ("start", "gate update", "barrier", "dh_next chains",
                "shuffles")
# and the launch's (csrc/lstm_cell.cu kStampEnds): its entry and exit, and
# the staged kernel's prologue (the yardstick leaves these 0)
STAMP_ENDS = ("entry", "exit", "copies issued", "first window landed",
              "W_h in registers", "first window's factors")
# the shared memory a block may opt in to (csrc/lstm_cell.cu kMaxSmem); each
# launcher refuses a launch past it with CUDA error 1, so the wrappers
# refuse such inputs first, with the launcher's formula
MAX_SMEM = 232_448


def smem_bytes(what: str, Din: int, H: int) -> tuple[int, str]:
    """The bytes of shared memory a launch of ``what`` needs at least, and
    the launcher's formula for them: ``lstm_cell`` stages 8 batch rows of
    [x, h] in fp32; ``lstm_seq`` holds the state, the bias and its staging
    of [x, h] (rows rounded up to 4 floats) and at least one step of x;
    ``lstm_seq_bwd`` (Din unused) holds 8 rows of H rounded up to 4 floats
    and the carried dh and dc."""
    r4 = lambda n: (n + 3) // 4 * 4      # noqa: E731
    if what == "lstm_cell":
        return 4 * 8 * (Din + H), "4 * 8 * (Din + H)"
    if what == "lstm_seq":
        return 4 * (2 * r4(Din + H) + 5 * H + Din), \
            "4 * (2 * ceil4(Din + H) + 5 * H + Din)"
    return 4 * (8 * r4(H) + 2 * H), "4 * (8 * ceil4(H) + 2 * H)"


def _check_smem(what, Din, H):
    need, formula = smem_bytes(what, Din, H)
    if need > MAX_SMEM:
        shape = f"H={H}" if what == "lstm_seq_bwd" else f"Din={Din} H={H}"
        raise ValueError(f"{what} kernel: {shape} needs {need:,} bytes of "
                         f"shared memory ({formula}), over the {MAX_SMEM:,} "
                         f"a block may opt in to")


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
    for name in (*_BWD_FNS.values(), *_BWD_YARDSTICK_FNS.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = getattr(lib, _BWD_STAMPS_FN)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def bwd_tier(H: int) -> str:
    """The backward route's kernel for hidden width H: ``staged``
    (``lstm_seq_bwd_staged_kernel``) on the register tier, else ``global``
    (``lstm_seq_bwd_kernel`` reading W_h from global memory)."""
    cols = (4 * H + 31) // 32 * 32
    return "staged" if cols <= BWD_REG_THREADS and H <= BWD_REG_COLS \
        else "global"


def _check(x, h, c, kernel, bias, what="lstm_cell"):
    """Refuse what the kernel does not take: x [B,Din] (``lstm_seq``:
    [T,B,Din]), h/c [B,H], kernel [Din+H,4H], bias [4H], one dtype,
    contiguous, within the launcher's shared memory (``smem_bytes``), on
    one CUDA device (checked last). Returns (B, Din, H)."""
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
    _check_smem(what, Din, H)
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
    [T,B,4H] float32, contiguous, within the launcher's shared memory
    (``smem_bytes``), on one CUDA device (checked last). Returns (T, B,
    H)."""
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
    _check_smem("lstm_seq_bwd", 0, H)
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"lstm_seq_bwd kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != dhs.device:
            raise ValueError(f"lstm_seq_bwd kernel: {name} on {t.device}, "
                             f"dhs on {dhs.device}")
    return n_t, B, H


def _bwd_call(fns, dhs, gates, cs, c0, w_h, *extra):
    """Check, allocate (dz, dh0, dc0: float32) and call the C function
    ``fns[dtype]`` with ``extra`` before the stream."""
    n_t, B, H = _check_bwd(dhs, gates, cs, c0, w_h)
    name = fns[dhs.dtype]
    lib = build()
    dev = dhs.device
    dz = kbuild.empty(n_t, B, 4 * H, dtype=torch.float32, device=dev)
    dh0 = kbuild.empty(B, H, dtype=torch.float32, device=dev)
    dc0 = kbuild.empty(B, H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            dhs.data_ptr(), gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            w_h.data_ptr(), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            n_t, B, H, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(T={n_t} B={B} H={H} {dhs.dtype})")
    return dz, dh0, dc0


def lstm_seq_bwd(dhs, gates, cs, c0, w_h):
    """Launch the backpropagation-through-time kernel on CUDA tensors: the
    cotangent dhs [T,B,H] of the forward's hs, its saved gates [T,B,4H]
    (float32) and cs [T,B,H], c0 [B,H] and w_h = kernel[Din:] [H,4H].
    Returns (dz [T,B,4H], dh0 [B,H], dc0 [B,H]), all float32: the gate
    pre-activations' gradients of every step and the gradients of the
    initial state. Raises on any other input."""
    out = _bwd_call(_BWD_FNS, dhs, gates, cs, c0, w_h)
    lstm_seq_bwd.launches += 1
    return out


lstm_seq_bwd.launches = 0


def lstm_seq_bwd_yardstick(dhs, gates, cs, c0, w_h):
    """``lstm_seq_bwd`` on the first backward kernel at every
    width, kept as the staged kernel's yardstick: the same arguments and
    outputs. For comparisons only: no path calls it, and it counts no
    launch."""
    return _bwd_call(_BWD_YARDSTICK_FNS, dhs, gates, cs, c0, w_h)


def lstm_seq_bwd_stamps(dhs, gates, cs, c0, w_h, staged: bool):
    """One launch of the stamp instantiation of the staged kernel
    (``staged``) or of the yardstick, float32 on the register tier: (dz,
    dh0, dc0, stamps, ends), stamps [T, len(STAMP_PHASES)] int64, the SM
    clock of block 0's thread 0 at each step's phase boundaries, and ends
    [len(STAMP_ENDS)] at the launch's (``STAMP_ENDS``; the yardstick
    writes the entry and the exit only). For timing probes only; it counts
    no launch."""
    if dhs.dtype != torch.float32 or bwd_tier(dhs.shape[-1]) != "staged":
        raise ValueError("lstm_seq_bwd stamps: float32 on the register "
                         "tier only")
    n_t, steps = dhs.shape[0], dhs.shape[0] * len(STAMP_PHASES)
    stamps = torch.zeros(steps + len(STAMP_ENDS), dtype=torch.int64,
                         device=dhs.device)
    out = _bwd_call({torch.float32: _BWD_STAMPS_FN}, dhs, gates, cs, c0,
                    w_h, stamps.data_ptr(), int(staged))
    return (*out, stamps[:steps].view(n_t, len(STAMP_PHASES)),
            stamps[steps:])
