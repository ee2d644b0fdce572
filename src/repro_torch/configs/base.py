"""Architecture configuration: the part of ``repro.configs.base`` the LSTM
family reads.

``ArchConfig`` is a frozen dataclass so a config cannot be mutated after
lookup; ``replace`` derives variants. The transformer families' fields and
sub-configs (MoE, SSM, hybrid, encoder, vision, RoPE) come with the port's
transformer stack.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # rnn in this slice
    source: str                   # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    dtype: str = "bfloat16"
    notes: str = ""

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Shrink a config to a smoke-test variant of the same family."""
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // 2)
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=min(cfg.d_model, 128),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 256),
        vocab=min(cfg.vocab, 512),
        dtype="float32",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
