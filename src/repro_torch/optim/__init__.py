"""Optimizers of the port (pure functions over trees of tensors)."""
from repro_torch.optim.optimizers import Optimizer, rmsprop, dense_bytes  # noqa: F401
