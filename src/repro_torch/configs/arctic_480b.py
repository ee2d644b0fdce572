"""arctic-480b [moe] — dense-MoE hybrid residual [hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56 heads (GQA kv=8), dense d_ff=4864 residual in PARALLEL with a
128-expert top-2 MoE (expert d_ff=4864) on every layer, vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, reduced

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,               # dense residual branch width
    vocab=32000,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=128, top_k=2, d_expert=4864, dense_residual=True,
                  every_k_layers=1),
    notes="dense FFN + 128e top-2 MoE summed per layer (Arctic dense-MoE hybrid)",
)


def smoke() -> ArchConfig:
    return reduced(CONFIG)
