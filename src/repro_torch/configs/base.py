"""Architecture / input-shape configuration, as ``repro.configs.base``.

Every architecture has one module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the published configuration) and ``smoke()`` (a reduced variant
of the same family: <=2 layers, d_model<=128, <=4 experts) used by the CPU
tests. The files are copies of the JAX package's, so both packages name the
same architectures with the same numbers.

``ArchConfig`` is a frozen dataclass so a config cannot be mutated after
lookup; ``replace`` derives variants (``get("qwen1.5-110b").replace(
n_layers=4)`` is the depth cut the chip smoke serves).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Input shapes (assigned; fixed across architectures)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts (0 = dense model)
    top_k: int = 0
    num_shared: int = 0           # always-on shared experts (DeepSeek-MoE)
    d_expert: int = 0             # per-expert hidden size
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    every_k_layers: int = 1       # MoE applied on layers where (i % k == k-1)
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 => ceil(d_model/16)
    chunk: int = 128              # chunked associative-scan block length


@dataclass(frozen=True)
class HybridConfig:
    period: int = 8               # repeating block length (Jamba: 8)
    attn_index: int = 4           # which layer inside the period is attention
    moe_every: int = 2            # MoE on layers where (i % moe_every == 1)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | rnn
    source: str                   # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    # block flavour
    mlp: str = "swiglu"           # swiglu | gelu | squared_relu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_fraction: float = 1.0    # fraction of head_dim that is rotated
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    sliding_window: int = 0       # 0 = full attention; >0 = window (decode)
    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0          # frame count supplied by the stubbed frontend
    # vlm
    vision_prefix: int = 0        # patch-embedding prefix tokens (stubbed ViT)
    # numerics
    dtype: str = "bfloat16"
    # embedding-table padding (0 = published size); the padded logit tail is
    # masked, so semantics are those of the published vocab
    vocab_pad_to: int = 0
    notes: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab
        p = self.vocab_pad_to
        return -(-self.vocab // p) * p

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for mixer of layer i (hybrid interleaving)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if (i % self.hybrid.period) == \
                self.hybrid.attn_index else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe.num_experts == 0:
            return False
        k = self.moe.every_k_layers
        if self.family == "hybrid":
            k = self.hybrid.moe_every
        return (i % k) == (k - 1)

    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    def dt_rank(self) -> int:
        r = self.ssm.dt_rank
        return r if r else -(-self.d_model // 16)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Shrink a config to a smoke-test variant of the same family."""
    d_model = min(cfg.d_model, 128)
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    # keep GQA structure when the full config has it
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // 2)
    moe = cfg.moe
    if moe.num_experts:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, 4),
            top_k=min(moe.top_k, 2), num_shared=min(moe.num_shared, 1),
            d_expert=min(moe.d_expert, 64) if moe.d_expert else 0)
    hybrid = cfg.hybrid
    n_layers = min(cfg.n_layers, 2)
    if cfg.family == "hybrid":
        # keep one attn + one ssm layer in the reduced block
        hybrid = dataclasses.replace(hybrid, period=2, attn_index=1,
                                     moe_every=2)
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 256),
        vocab=min(cfg.vocab, 512),
        head_dim=0,
        moe=moe,
        hybrid=hybrid,
        ssm=dataclasses.replace(cfg.ssm, chunk=16),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        vision_prefix=min(cfg.vision_prefix, 8) if cfg.vision_prefix else 0,
        dtype="float32",
    )
    kw.update(overrides)
    return cfg.replace(**kw)
