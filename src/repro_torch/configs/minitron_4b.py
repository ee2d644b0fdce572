"""minitron-4b [dense] — pruned Nemotron [arXiv:2407.14679].

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000, squared-ReLU MLP.
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679 (Minitron)",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    mlp="squared_relu",
    norm="layernorm",
    rope_fraction=0.5,
    sliding_window=8192,
    notes="Nemotron family: squared-ReLU, partial RoPE, huge vocab",
)


def smoke():
    return reduced(CONFIG)
