"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, bound with ``ctypes`` by its
wrapper module. The library goes into ``build/kernels/`` at the repository
root, named by the source's hash, so an edited source is rebuilt and an
unchanged one is built once. The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside it as ``<name>.log``.

``compile_sources`` starts one ``nvcc`` per missing library, all at once, and
waits for them together; ``load`` builds one source if needed and loads it.
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
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


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
