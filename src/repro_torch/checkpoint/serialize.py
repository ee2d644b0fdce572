"""Pytree <-> bytes via msgpack (+ optional compression): the byte codec of
the protocol's wire messages (gradient/model messages). The file, op-log and
checkpoint-store helpers of the reference module come with the port's
durable store.

Leaves use the JAX package's leaf format (``{"__nd__", "d", "s", "b"}``:
dtype name, shape, raw bytes), so either package reads the other's blobs. A
``torch.Tensor`` leaf — on the card, requiring grad, or bfloat16 — is
detached and copied to the host first. A bfloat16 leaf ships its raw 16-bit
words under the dtype name ``bfloat16`` and decodes to a CPU bfloat16 tensor
(numpy has no bfloat16 of its own, and the port does not need
``ml_dtypes``); every other leaf decodes to a numpy array, as in the JAX
package.

The first byte of every blob is the codec header, so either side can decode
regardless of which codecs it has installed:

- ``Z`` zstandard (preferred when the optional ``zstandard`` package exists)
- ``D`` stdlib zlib/deflate (always available fallback)
- ``R`` raw / uncompressed
"""
from __future__ import annotations

import zlib
from typing import Any, Optional

import msgpack
import numpy as np
import torch

try:  # optional: zstd compresses better/faster, but the stdlib must suffice
    import zstandard
    _CTX = zstandard.ZstdCompressor(level=3)
    _DCTX = zstandard.ZstdDecompressor()
except ImportError:
    zstandard = None
    _CTX = _DCTX = None

_ARR = "__nd__"

DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"


_BF16 = "bfloat16"


def _pack_leaf(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {_ARR: True, "d": _BF16, "s": list(t.shape),
                    "b": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
        a = np.asarray(x)
        return {_ARR: True, "d": a.dtype.name, "s": list(a.shape),
                "b": a.tobytes()}
    return x


def _unpack_leaf(x):
    if isinstance(x, dict) and x.get(_ARR):
        if x["d"] == _BF16:
            words = np.frombuffer(x["b"], np.int16).reshape(x["s"]).copy()
            return torch.from_numpy(words).view(torch.bfloat16)
        return np.frombuffer(x["b"], np.dtype(x["d"])).reshape(x["s"]).copy()
    return x


def _walk(tree, fn):
    if isinstance(tree, dict) and not tree.get(_ARR):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def dumps(tree: Any, compress: bool = True,
          codec: Optional[str] = None) -> bytes:
    """Serialize. ``codec`` forces "zstd"/"zlib"; default picks zstd when
    installed, zlib otherwise. The choice is recorded in the header byte."""
    raw = msgpack.packb(_walk(tree, _pack_leaf), use_bin_type=True)
    if not compress:
        return b"R" + raw
    codec = codec or DEFAULT_CODEC
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "codec='zstd' requested but the zstandard package is not "
                "installed; use codec='zlib' or install zstandard")
        return b"Z" + _CTX.compress(raw)
    if codec == "zlib":
        return b"D" + zlib.compress(raw, 6)
    raise ValueError(f"unknown codec {codec!r}")


def loads(data: bytes) -> Any:
    tag, body = data[:1], data[1:]
    if tag == b"Z":
        if _DCTX is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the zstandard package "
                "is not installed on this side")
        body = _DCTX.decompress(body)
    elif tag == b"D":
        body = zlib.decompress(body)
    elif tag != b"R":
        raise ValueError(f"unknown serialization header {tag!r}")
    tree = msgpack.unpackb(body, raw=False, strict_map_key=False)
    return _walk(tree, _unpack_leaf)
