"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes`` by its
wrapper module. The library goes into ``build/kernels/`` at the repository
root, named by the hash of the source and of the headers beside it, so an
edited source or header is rebuilt and an unchanged one is built once. The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside it as ``<name>.log``.

``compile_sources`` starts one ``nvcc`` per missing library, all at once, and
waits for them together; ``load`` builds one source if needed and loads it.
``empty``, ``empty_like`` and ``empty_likes`` allocate a kernel's outputs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Iterable, List, Tuple

import torch
import torch.utils.deterministic as _det

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source and need the CUDA toolkit")
    return found


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The library of ``source``, named by the hash of the source and of
    every header beside it (``csrc/*.cuh``), so an edit to either rebuilds
    it."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def log_path(source: pathlib.Path) -> pathlib.Path:
    return library_path(source).with_suffix(".log")


def compile_sources(sources: Iterable[pathlib.Path]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Raises with the compiler's output on a failure."""
    jobs: List[Tuple[pathlib.Path, pathlib.Path, pathlib.Path,
                     subprocess.Popen]] = []
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, so, tmp, proc))
    failed = []
    for source, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source.name}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(source: pathlib.Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if needed."""
    compile_sources([source])
    return ctypes.CDLL(str(library_path(source)))


def _unfilled(make, *args, **kwargs):
    """``make(*args, **kwargs)`` (``torch.empty`` or ``torch.empty_like``)
    for an output that a kernel writes in full. Under deterministic
    algorithms (``device.resolve`` turns them on for the card) PyTorch fills
    every fresh tensor with NaN, a launch and a full write of the tensor;
    here nothing can read the memory before the kernel has written it, so
    the fill is skipped."""
    if not (torch.are_deterministic_algorithms_enabled() and
            _det.fill_uninitialized_memory):
        return make(*args, **kwargs)
    _det.fill_uninitialized_memory = False
    try:
        return make(*args, **kwargs)
    finally:
        _det.fill_uninitialized_memory = True


def empty(*shape, dtype, device):
    """A kernel's output of this shape, not filled (``_unfilled``)."""
    return _unfilled(torch.empty, *shape, dtype=dtype, device=device)


def empty_like(x):
    """A kernel's output like x, not filled (``_unfilled``)."""
    return _unfilled(torch.empty_like, x)


def empty_likes(*ts):
    """Outputs like each of ts, none filled, with one switch of the fill
    (``_unfilled``) for all of them."""
    return _unfilled(lambda: tuple(torch.empty_like(t) for t in ts))
