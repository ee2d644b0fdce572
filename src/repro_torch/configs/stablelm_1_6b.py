"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

24L, d_model=2048, 32 heads (MHA kv=32), d_ff=5632, vocab=100352.
LayerNorm, partial RoPE (25% of head_dim), SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    mlp="swiglu",
    norm="layernorm",
    rope_fraction=0.25,
    sliding_window=8192,      # sub-quadratic variant used for long_500k decode
    notes="MHA; partial rotary 25%; LayerNorm",
)


def smoke():
    return reduced(CONFIG)
