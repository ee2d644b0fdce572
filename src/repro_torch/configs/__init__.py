"""Config registry: ``get(name)`` / ``get_smoke(name)`` / ``ARCH_IDS``, as
``repro.configs``. Each architecture file is a copy of the JAX package's."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ArchConfig, InputShape,  # noqa: F401
                                      INPUT_SHAPES, reduced)

# assigned architecture id -> module name
_MODULES: Dict[str, str] = {
    "whisper-base": "whisper_base",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "arctic-480b": "arctic_480b",
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "minitron-4b": "minitron_4b",
    "qwen1.5-110b": "qwen15_110b",
    "nemotron-4-340b": "nemotron_4_340b",
    "internvl2-1b": "internvl2_1b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    # the paper's own workload
    "paper-lstm": "paper_lstm",
}

ARCH_IDS = [k for k in _MODULES if k != "paper-lstm"]


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
