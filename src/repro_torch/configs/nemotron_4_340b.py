"""nemotron-4-340b [dense] — [arXiv:2402.16819 / 2406.11704].

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab=256000, squared-ReLU.
The memory-pressure stress case of the assignment.
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819 (Nemotron-4)",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp="squared_relu",
    norm="layernorm",
    rope_fraction=0.5,
    sliding_window=8192,
    notes="squared-ReLU, no gating; largest assigned dense model",
)


def smoke():
    return reduced(CONFIG)
