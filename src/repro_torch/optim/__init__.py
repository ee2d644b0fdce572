"""Optimizers and gradient codecs of the port (pure functions over trees of
tensors)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    REGISTRY, Optimizer, adamw, dense_bytes, make, rmsprop, sgd)
from repro_torch.optim.compression import (  # noqa: F401
    Codec, ef_compress, ef_init, make_codec, ternary_decode, ternary_encode,
    topk_decode, topk_encode)
