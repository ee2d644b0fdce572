"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family scaled].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=49152, vocab=152064, SwiGLU, QKV bias.
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    source="hf:Qwen/Qwen1.5-110B (card); bias convention per Qwen1.5 series",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    sliding_window=8192,
    notes="QKV bias; GQA kv=8",
)


def smoke():
    return reduced(CONFIG)
