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
The ternary codec runs through the port's gradient-level kernels
(``kernels/ops.py``): on the card a whole gradient's encode is one scale
pass and one encode launch, its decode one launch, and its error feedback
(``Codec.ef``, which ``ef_compress`` takes when a codec has it) one scale
pass and one launch that writes the codes, the decoded gradient and the
residual; on the CPU their plain versions, leaf by leaf. Its payload leaf is
``{"packed": uint8 [ceil(n/4)], "s": fp32, "shape"}`` — the 2-bit byte
stream whose size the JAX package's byte count already states
(``ceil(n/4) + 4`` per leaf) — where the JAX package ships unpacked int8
codes; on the card the leaves' ``packed`` are views into one buffer. The
decoded gradient, the error-feedback residual and the byte count equal the
JAX package's on every input (NaN where it gives NaN: a leaf whose scale is
inf or NaN decodes to NaN), every other value bit for bit; the payload's
layout need not.
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


def _ternary_nbytes(sizes) -> int:
    return sum(-(-n // 4) + 4 for n in sizes)


def _fp32(leaf) -> torch.Tensor:
    """The leaf as contiguous fp32 (itself where it already is)."""
    return leaf.float().contiguous()


def ternary_encode(g, generator: Optional[torch.Generator] = None):
    """TernGrad: per-leaf scale s = max|g| (at least 1e-12), 2-bit codes.

    Deterministic when ``generator`` is None: b = 1 iff |g| >= s/2 (the
    threshold variant). With a generator, b ~ Bernoulli(|g|/s) from its
    stream; the drawn codes then go through the same encode kernel as
    ``sign(g) * s * b`` with the scales given. Every code is 0 where s is
    inf or NaN. Wire size: ceil(n/4) bytes + one fp32 scale per leaf."""
    leaves = tree.leaves(g)
    flats = [_fp32(leaf) for leaf in leaves]
    scales = None
    if generator is not None:
        scales = [torch.clamp_min(f.abs().max(), 1e-12) for f in flats]
        drawn = []
        for f, s in zip(flats, scales):
            u = torch.rand(f.shape, generator=generator,
                           device=generator.device)
            keep = u.to(f.device) < f.abs() / s
            drawn.append(torch.where(keep, torch.sign(f) * s, 0.0))
        flats = drawn
    packed, s = ops.ternary_encode_leaves(flats, scales)
    payload = tree.unflatten(g, [
        {"packed": p, "s": sv, "shape": tuple(leaf.shape)}
        for p, sv, leaf in zip(packed, s, leaves)])
    return payload, _ternary_nbytes(f.numel() for f in flats)


def ternary_decode(payload, device=None):
    """Dense gradients on ``device`` (None: the payload's own)."""
    ps = tree.leaves(payload, is_leaf=_is_payload)
    dec = ops.ternary_decode_leaves(
        [_tensor(p["packed"], device) for p in ps],
        [_tensor(p["s"], device) for p in ps],
        [tuple(p["shape"]) for p in ps])
    out = {id(p): d for p, d in zip(ps, dec)}
    return tree.map(lambda p: out[id(p)], payload, is_leaf=_is_payload)


def ternary_ef(grads, residual):
    """``ef_compress`` of the ternary codec over the whole gradient at once:
    (decoded, new residual, nbytes), equal to encode-then-decode with the
    residual carried, and on the card two launches."""
    leaves = tree.leaves(grads)
    dec, res = ops.ternary_ef([_fp32(leaf) for leaf in leaves],
                              tree.leaves(residual))
    return tree.unflatten(grads, dec), tree.unflatten(grads, res), \
        _ternary_nbytes(leaf.numel() for leaf in leaves)


# ---------------------------------------------------------------------------
# error feedback wrapper
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Codec:
    name: str
    encode: Callable  # (grads) -> (payload, nbytes)
    decode: Callable  # (payload, device=None) -> grads
    # (grads, residual) -> (decoded, new residual, nbytes) in one pass,
    # where the codec has one; else ef_compress encodes, then decodes
    ef: Optional[Callable] = None


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
        return Codec("ternary", lambda g: ternary_encode(g), ternary_decode,
                     ternary_ef)
    raise KeyError(name)


def ef_init(params):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress(codec: Codec, grads, residual):
    """Error feedback: compress (g + residual); carry the quantization error.

    Returns (decoded_grads, new_residual, nbytes)."""
    if codec.ef is not None:
        return codec.ef(grads, residual)
    corrected = tree.map(lambda g, r: g.float() + r, grads, residual)
    payload, nbytes = codec.encode(corrected)
    decoded = codec.decode(payload)
    new_residual = tree.map(lambda c, d: c - d.float(), corrected, decoded)
    return decoded, new_residual, nbytes
