"""falcon-mamba-7b [ssm] — attention-free Mamba-1 [arXiv:2410.05355].

64L, d_model=4096, d_inner=8192 (expand=2), d_state=16, d_conv=4, vocab=65024.
No attention anywhere; decode state is O(1) — long_500k is its native regime.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, reduced

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355 (Falcon Mamba)",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                   # Mamba block subsumes the MLP
    vocab=65024,
    norm="rmsnorm",
    rope_fraction=0.0,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    notes="pure Mamba-1; RMSNorm; tied embeddings off",
)


def smoke():
    return reduced(CONFIG)
