"""Optimizers and gradient codecs of the port (pure functions over trees of
tensors)."""
from repro_torch.optim.optimizers import Optimizer, rmsprop, dense_bytes  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    Codec, ef_compress, ef_init, make_codec, ternary_decode, ternary_encode,
    topk_decode, topk_encode)
