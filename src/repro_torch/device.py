"""Device resolution for the port's entry points.

An entry point runs on the card unless its caller passes ``device="cpu"``.
With no device given and no card present it raises: a run never drops to the
CPU on its own.

On the card the bit-equality contracts (Coordinator == sequential reference)
need every product to keep one summation order run to run, the property the
JAX package gets from compiling each step once (``core/mapreduce.py``):
TF32 off, deterministic algorithms on, and cuBLAS restricted to a fixed
workspace. ``CUBLAS_WORKSPACE_CONFIG`` is read when cuBLAS starts, so the
port resolves its device before it touches the card.
"""
from __future__ import annotations

import os

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the card, or raise when there is none; else as given.
    Resolving a CUDA device switches the process to deterministic kernels
    (the cuBLAS part only if cuBLAS has not started yet in this process)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' (CLI: "
                "--device cpu) to run the port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    return dev
