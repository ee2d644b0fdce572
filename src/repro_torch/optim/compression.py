"""Gradient compression for the paper's bandwidth bottleneck (§III / §VI).

Port of ``repro/optim/compression.py``. The paper identifies
gradient-synchronization bandwidth as the central threat to validity and
cites the standard fixes; both are invertible codecs with error feedback:

- ``topk``    — magnitude sparsification (Aji & Heafield 2017): keep the k
  largest |g| entries per tensor; the residual is fed back next step.
- ``ternary`` — TernGrad (Wen et al. 2017): g -> s * sign(g) * b with
  s = max|g|, b = 1 iff |g| >= s/2 (the deterministic threshold variant), or
  b ~ Bernoulli(|g|/s) when a ``torch.Generator`` is given.

Codecs work leaf-wise on gradient trees and report exact wire byte counts.
The ternary codec runs through the port's kernels (``kernels/ops.py``): on
the card every leaf's encode and decode is one launch of the hand-written
``ternary_encode``/``ternary_decode``, on the CPU their plain versions. Its
payload leaf is ``{"packed": uint8 [ceil(n/4)], "s": fp32, "shape"}`` — the
2-bit byte stream whose size the JAX package's byte count already states
(``ceil(n/4) + 4`` per leaf) — where the JAX package ships unpacked int8
codes. The decoded gradient, the error-feedback residual and the byte count
equal the JAX package's bit for bit; the payload's layout need not.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import dense_bytes


# ---------------------------------------------------------------------------
# codecs (encode returns (payload tree, nbytes); decode returns dense grads)
# ---------------------------------------------------------------------------

def _is_payload(x) -> bool:
    """Payload-dict leaf marker (grads trees are dicts too, so a bare
    isinstance check would stop tree traversal at the root)."""
    return isinstance(x, dict) and "shape" in x and \
        ("packed" in x or "idx" in x)


def _tensor(x, device) -> torch.Tensor:
    """A payload leaf as a tensor on ``device`` (None: where it lies). A
    payload decoded off the wire carries numpy arrays, which have no device:
    they need one named, so a run on the card never decodes on the CPU."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if device is None:
        raise ValueError("a payload decoded off the wire holds numpy arrays; "
                         "decode it with device= set")
    return torch.from_numpy(np.array(x)).to(device)


def _leaf_bytes(x) -> int:
    return x.numel() * x.element_size()


def topk_encode(g, fraction: float):
    """Keep ceil(fraction * n) largest-|g| entries. Returns (payload, nbytes)."""
    def enc(leaf):
        flat = leaf.reshape(-1)
        k = max(int(np.ceil(fraction * flat.numel())), 1)
        idx = torch.topk(flat.abs(), k).indices
        return {"idx": idx.to(torch.int32), "val": flat[idx],
                "shape": tuple(leaf.shape)}
    payload = tree.map(enc, g)
    nbytes = sum(_leaf_bytes(p["idx"]) + _leaf_bytes(p["val"])
                 for p in tree.leaves(payload, is_leaf=_is_payload))
    return payload, nbytes


def topk_decode(payload, device=None):
    """Dense gradients on ``device`` (None: the payload's own)."""
    def dec(p):
        idx, val = _tensor(p["idx"], device), _tensor(p["val"], device)
        flat = torch.zeros(math.prod(p["shape"]), dtype=val.dtype,
                           device=val.device)
        flat[idx.long()] = val            # distinct indices: no accumulation
        return flat.reshape(tuple(p["shape"]))
    return tree.map(dec, payload, is_leaf=_is_payload)


def ternary_encode(g, generator: Optional[torch.Generator] = None):
    """TernGrad: per-leaf scale s = max|g| (at least 1e-12), 2-bit codes.

    Deterministic when ``generator`` is None: b = 1 iff |g| >= s/2 (the
    threshold variant). With a generator, b ~ Bernoulli(|g|/s) from its
    stream; the drawn codes then go through the same encode kernel as
    ``sign(g) * s * b``. Each leaf is flattened and zero-padded to a multiple
    of 4 (zeros encode as 0b00 and are dropped on decode). Wire size: ceil(n/4)
    bytes + one fp32 scale per leaf."""
    def enc(leaf):
        flat = leaf.reshape(-1).float()
        n = flat.numel()
        s = torch.clamp_min(flat.abs().max(), 1e-12)
        if generator is not None:
            u = torch.rand(n, generator=generator, device=generator.device)
            keep = u.to(flat.device) < flat.abs() / s
            flat = torch.where(keep, torch.sign(flat) * s, 0.0)
        pad = -n % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return {"packed": ops.ternary_encode(flat, s), "s": s,
                "shape": tuple(leaf.shape)}
    payload = tree.map(enc, g)
    nbytes = sum(-(-math.prod(p["shape"]) // 4) + 4
                 for p in tree.leaves(payload, is_leaf=_is_payload))
    return payload, nbytes


def ternary_decode(payload, device=None):
    """Dense gradients on ``device`` (None: the payload's own)."""
    def dec(p):
        shape = tuple(p["shape"])
        flat = ops.ternary_decode(_tensor(p["packed"], device),
                                  _tensor(p["s"], device))
        return flat[:math.prod(shape)].reshape(shape)
    return tree.map(dec, payload, is_leaf=_is_payload)


# ---------------------------------------------------------------------------
# error feedback wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Codec:
    name: str
    encode: Callable  # (grads) -> (payload, nbytes)
    decode: Callable  # (payload, device=None) -> grads


def make_codec(name: str, **kw) -> Codec:
    if name == "none":
        return Codec("none", lambda g: (g, dense_bytes(g)),
                     lambda p, device=None: p if device is None
                     else tree.to_device(p, device))
    if name == "topk":
        frac = kw.get("fraction", 0.01)
        return Codec(f"topk({frac})",
                     lambda g: topk_encode(g, frac), topk_decode)
    if name == "ternary":
        return Codec("ternary", lambda g: ternary_encode(g), ternary_decode)
    raise KeyError(name)


def ef_init(params):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress(codec: Codec, grads, residual):
    """Error feedback: compress (g + residual); carry the quantization error.

    Returns (decoded_grads, new_residual, nbytes)."""
    corrected = tree.map(lambda g, r: g.float() + r, grads, residual)
    payload, nbytes = codec.encode(corrected)
    decoded = codec.decode(payload)
    new_residual = tree.map(lambda c, d: c - d.float(), corrected, decoded)
    return decoded, new_residual, nbytes
