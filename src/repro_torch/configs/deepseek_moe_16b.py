"""deepseek-moe-16b [moe] — fine-grained expert segmentation [arXiv:2401.06066].

28L, d_model=2048, 16 heads (MHA kv=16), expert d_ff=1408, vocab=102400,
2 shared experts + 64 routed experts top-6.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, reduced

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE)",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # per-expert width (fine-grained)
    vocab=102400,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_expert=1408,
                  every_k_layers=1),
    notes="2 shared + 64 routed top-6 fine-grained experts; first layer dense in the "
          "original model — we apply MoE on all layers for uniform scan",
)


def smoke():
    return reduced(CONFIG)
