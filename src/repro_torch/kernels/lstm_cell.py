"""The fused LSTM cell on Hopper: build, bind and launch ``csrc/lstm_cell.cu``.

Replaces the Pallas kernel ``repro/kernels/lstm_cell.py::_cell_kernel``; the
source's header note gives the design and its bound. The shared library is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/kernels/`` at
the repository root (named by the source's hash, so an edited source is
rebuilt) and bound with ``ctypes`` through a plain C interface.

``lstm_cell.launches`` counts the launches this wrapper made, so a run can
show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "lstm_cell.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_FNS = {torch.float32: "lstm_cell_f32", torch.bfloat16: "lstm_cell_bf16"}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the lstm_cell kernel is built "
                           "from source and needs the CUDA toolkit")
    return found


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library. The
    compiler's ``-Xptxas -v`` report is kept beside it as ``<name>.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lstm_cell_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name in _FNS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, h, c, kernel, bias):
    ts = {"x": x, "h": h, "c": c, "kernel": kernel, "bias": bias}
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("lstm_cell kernel: x and h must be 2-D")
    B, Din = x.shape
    H = h.shape[1]
    if B < 1 or Din < 1 or H < 1:
        raise ValueError(f"lstm_cell kernel: empty shape B={B} Din={Din} "
                         f"H={H}")
    want = {"h": (B, H), "c": (B, H), "kernel": (Din + H, 4 * H),
            "bias": (4 * H,)}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"lstm_cell kernel: {name} has shape "
                             f"{tuple(ts[name].shape)}, want {shape}")
    if x.dtype not in _FNS:
        raise ValueError(f"lstm_cell kernel: dtype {x.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in ts.items():
        if t.dtype != x.dtype:
            raise ValueError(f"lstm_cell kernel: {name} is {t.dtype}, "
                             f"x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell kernel: {name} is not contiguous")
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"lstm_cell kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"lstm_cell kernel: {name} on {t.device}, "
                             f"x on {x.device}")
    return B, Din, H


def lstm_cell(x, h, c, kernel, bias):
    """Launch the kernel on CUDA tensors: x [B,Din], h/c [B,H],
    kernel [Din+H, 4H], bias [4H], all float32 or all bfloat16, contiguous.
    Returns (h_new, c_new) in the input dtype. Raises on any other input."""
    B, Din, H = _check(x, h, c, kernel, bias)
    lib = build()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
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
