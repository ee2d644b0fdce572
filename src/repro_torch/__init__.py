"""PyTorch/CUDA port of the JSDoop reproduction.

The package mirrors ``src/repro/`` module for module (the JAX package stays
the reference) and imports ``torch``, ``numpy`` and ``msgpack`` only — never
``jax`` and nothing of ``repro``. Every hot kernel of the ported path is a
hand-written Hopper kernel under ``kernels/`` with its plain PyTorch version
beside it.

Entry points take an explicit ``device``: they run on ``cuda`` unless the
caller passes ``device="cpu"``, and they raise, never fall back, when no card
is present (see ``repro_torch.device``).
"""
