"""The paper's own workload: 2x50-cell stacked LSTM char model (JSDoop §V.A).

Training parameters reproduce Table 2/3 exactly:
batch 128 = 16 mini-batches of 8; 2048 examples/epoch; 5 epochs; lr 0.1; RMSprop;
sample length 40; categorical cross-entropy.
"""
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="paper-lstm",
    family="rnn",
    source="JSDoop (IEEE Access 2019) §V.A, Tables 2-3",
    n_layers=2,
    d_model=50,               # LSTM cells per layer
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=0,                  # set from the corpus at runtime
    norm="layernorm",
    dtype="float32",
    notes="2 stacked LSTM layers of 50 cells + dense softmax head",
)


@dataclass(frozen=True)
class TrainParams:
    """Paper Table 2 + Table 3."""
    batch_size: int = 128
    examples_per_epoch: int = 2048
    learning_rate: float = 0.1
    num_epochs: int = 5
    sample_len: int = 40
    mini_batch_size: int = 8
    mini_batches_to_accumulate: int = 16

    @property
    def batches_per_epoch(self) -> int:
        return self.examples_per_epoch // self.batch_size  # 16

    def __post_init__(self):
        if self.mini_batch_size * self.mini_batches_to_accumulate != \
                self.batch_size:
            raise ValueError("mini_batch_size * mini_batches_to_accumulate "
                             "must equal batch_size")


PAPER_PARAMS = TrainParams()


def smoke():
    return reduced(CONFIG, d_model=16, vocab=64)
