"""whisper-base [audio] — encoder-decoder transformer [arXiv:2212.04356].

6L enc + 6L dec, d_model=512, 8 heads (MHA, kv=8), d_ff=2048, vocab=51865.
The mel-spectrogram + conv frontend is STUBBED per the assignment: input_specs()
supplies precomputed frame embeddings [B, 1500, 512] (30 s of audio at 50 Hz).
"""
from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    source="arXiv:2212.04356 (Whisper)",
    n_layers=6,              # decoder layers
    n_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    qkv_bias=True,           # whisper uses biases on q/v (we apply to all qkv)
    rope_fraction=0.0,       # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
    notes="conv+mel frontend stubbed; sinusoidal positions; cross-attention decoder",
)


def smoke() -> ArchConfig:
    return reduced(CONFIG)
