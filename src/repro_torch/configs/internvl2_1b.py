"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B-like LM backbone [arXiv:2404.16821].

LM backbone: 24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab=151655.
The InternViT vision encoder + MLP projector are STUBBED per the assignment:
input_specs() supplies 256 projected patch embeddings [B, 256, 896] prepended to
the token sequence.
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2); LM = Qwen2-0.5B backbone",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    vision_prefix=256,
    sliding_window=8192,
    notes="ViT frontend stubbed -> 256 patch embeddings prefix; GQA kv=2",
)


def smoke():
    return reduced(CONFIG)
