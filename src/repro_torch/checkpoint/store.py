"""Versioned checkpoint store — the durable form of the paper's DataServer,
as ``repro.checkpoint.store``.

Each version is one file ``v{N:08d}.ckpt`` (msgpack + zstd, or zlib where
``zstandard`` is missing: the first byte says which), written atomically
(a temporary file in the same directory, then ``os.replace``). The store
is append-only with optional retention; ``latest()`` resumes training. The
payload and its leaves are the JAX package's (``checkpoint/serialize.py``),
so either package loads the other's files: a tensor leaf (on the card, or
bfloat16) is copied to the host first, and loads as a numpy array, or as a
CPU bfloat16 tensor, bit for bit.
"""
from __future__ import annotations

import os
import pathlib
import tempfile
from typing import Any, List, Optional, Tuple

from repro_torch.checkpoint.serialize import dumps, loads


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 0):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, version: int) -> pathlib.Path:
        return self.dir / f"v{version:08d}.ckpt"

    def save(self, version: int, tree: Any, meta: Optional[dict] = None) -> str:
        payload = {"meta": meta or {}, "tree": tree, "version": version}
        # atomic write
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            f.write(dumps(payload))
        os.replace(tmp, self._path(version))
        if self.keep:
            for v in self.versions()[:-self.keep]:
                self._path(v).unlink(missing_ok=True)
        return str(self._path(version))

    def load(self, version: int) -> Tuple[Any, dict]:
        payload = loads(self._path(version).read_bytes())
        return payload["tree"], payload["meta"]

    def versions(self) -> List[int]:
        return sorted(int(p.stem[1:]) for p in self.dir.glob("v*.ckpt"))

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None
