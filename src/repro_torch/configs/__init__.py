"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, MoEConfig, SSMConfig, XLSTMConfig
from .shapes import SHAPES, SHAPES_BY_NAME, ShapeConfig, cells_for

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-67b": "deepseek_67b",
    "olmo-1b": "olmo_1b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-8b": "qwen3_8b",
    "internvl2-1b": "internvl2_1b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES: List[str] = list(_MODULES)

__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "ShapeConfig",
    "SHAPES",
    "SHAPES_BY_NAME",
    "cells_for",
    "ARCH_NAMES",
    "get_config",
    "all_configs",
]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; options: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}
