"""Pytree <-> bytes via msgpack (+ optional compression). Used by the
DataServer wire protocol (gradient/model messages), the gateway's snapshots
and its append-only op log (framed records, ``append_record`` /
``iter_records``).

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

import os
import struct
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

# op-log record header: payload length + crc32 of the payload
_REC = struct.Struct(">II")

DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"


_BF16 = "bfloat16"


def _dtype_of(name: str) -> np.dtype:
    """Resolve a leaf's dtype name. ``bfloat16`` never reaches here (it
    decodes to a torch tensor); any other name numpy does not know is an
    extension type the port does not read (it has no ``ml_dtypes``)."""
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError(f"leaf dtype {name!r} is not a numpy dtype") from None


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
        return np.frombuffer(x["b"], _dtype_of(x["d"])).reshape(x["s"]).copy()
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


def atomic_write(path: str, data: bytes) -> int:
    """Write bytes to a file ATOMICALLY (tmp + fsync + rename): a reader —
    e.g. a gateway restarting from its latest snapshot — can never observe a
    half-written blob, even if the writer is kill -9'd mid-write. Returns the
    byte size written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(data)


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def dump_path(tree: Any, path: str, compress: bool = True,
              codec: Optional[str] = None) -> int:
    """``dumps`` straight to a file, atomically."""
    return atomic_write(path, dumps(tree, compress=compress, codec=codec))


def load_path(path: str) -> Any:
    return loads(read_bytes(path))


def pack_record(data: bytes) -> bytes:
    """Frame one op-log record: 8-byte header (u32 length, u32 crc32 of the
    payload, both big-endian) + payload. The crc makes a torn or bit-rotted
    tail detectable, so an append-only log survives kill -9 mid-write."""
    return _REC.pack(len(data), zlib.crc32(data) & 0xFFFFFFFF) + data


def append_record(path: str, data: bytes, *, fsync: bool = True) -> int:
    """Append one framed record to an append-only log file, creating it if
    needed. ``fsync=True`` (the default) makes the record durable before
    returning — the op-log contract: an operation acknowledged to a client
    is recoverable after kill -9. Returns bytes written."""
    rec = pack_record(data)
    with open(path, "ab") as f:
        f.write(rec)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    return len(rec)


def iter_records(data: bytes):
    """Yield the framed record payloads in ``data`` in order, stopping at the
    first incomplete or corrupt record. A torn tail (the writer was killed
    mid-append) is EXPECTED, not an error: every record before it is intact
    by construction (appends are sequential), so replay simply ends there."""
    off, n = 0, len(data)
    while off + _REC.size <= n:
        length, crc = _REC.unpack_from(data, off)
        body = data[off + _REC.size:off + _REC.size + length]
        if len(body) < length or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            return
        yield body
        off += _REC.size + length


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
