"""Synthetic token pipeline for the assigned LM architectures, as
``repro.data.tokens``.

Deterministic (seed, step) -> global batch; sharded loading gives each data-
parallel host only its slice (the pattern a real multi-pod input pipeline uses).
Batches are numpy arrays, drawn with the JAX package's ``RandomState``
calls, so both packages see the same tokens.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig


def lm_batch(cfg: ArchConfig, batch: int, seq: int, seed: int, step: int
             ) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31 - 1))
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "encdec":
        out["frames"] = rng.randn(batch, cfg.encoder_seq, cfg.d_model).astype(
            np.float32) * 0.02
        out["tokens"] = rng.randint(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    elif cfg.family == "vlm":
        st = seq - cfg.vision_prefix
        out["patches"] = rng.randn(batch, cfg.vision_prefix, cfg.d_model).astype(
            np.float32) * 0.02
        out["tokens"] = rng.randint(0, cfg.vocab, (batch, st + 1)).astype(np.int32)
    else:
        out["tokens"] = rng.randint(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    return out


def shard_slice(batch: Dict[str, np.ndarray], shard: int, num_shards: int):
    """Per-host slice of the global batch along the batch dim."""
    def sl(x):
        n = x.shape[0]
        if n % num_shards:
            raise ValueError(f"batch of {n} does not split into {num_shards} "
                             f"shards")
        per = n // num_shards
        return x[shard * per:(shard + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
