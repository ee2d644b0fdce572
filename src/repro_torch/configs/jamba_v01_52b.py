"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE [arXiv:2403.19887].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536, MoE 16 experts
top-2. Repeating 8-layer block: attention at in-block index 4, MoE every 2nd layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, HybridConfig, reduced

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    mlp="swiglu",
    norm="rmsnorm",
    rope_fraction=0.0,       # Jamba uses no positional encoding (Mamba carries order)
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, every_k_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(period=8, attn_index=4, moe_every=2),
    notes="1 attn per 8 layers; MoE on odd layers; Mamba-1 mixer elsewhere",
)


def smoke() -> ArchConfig:
    return reduced(CONFIG)
