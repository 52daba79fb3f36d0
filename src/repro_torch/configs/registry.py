"""Registry mapping --arch ids to config modules."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen1.5-32b": "qwen15_32b",
    "granite-3-2b": "granite3_2b",
    "yi-9b": "yi_9b",
    "minitron-8b": "minitron_8b",
    "internvl2-26b": "internvl2_26b",
    "grok-1-314b": "grok1_314b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "mamba2-780m": "mamba2_780m",
    "zamba2-7b": "zamba2_7b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
