"""Assigned-architecture registry: ``get_config(name)`` / ``get_reduced(name)``.

Each module defines the EXACT published configuration (``CONFIG``) plus a
``REDUCED`` family-preserving miniature for CPU smoke tests.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import (ModelConfig, SHAPES,  # noqa: F401
                                       ShapeSpec, cell_is_runnable)

ARCH_IDS = [
    "deepseek_v2_236b",
    "olmoe_1b_7b",
    "smollm_360m",
    "phi4_mini_3_8b",
    "minitron_4b",
    "qwen2_5_3b",
    "zamba2_1_2b",
    "paligemma_3b",
    "musicgen_large",
    "mamba2_1_3b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _resolve(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name in ARCH_IDS:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_resolve(name)}").CONFIG


def get_reduced(name: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{_resolve(name)}").REDUCED
