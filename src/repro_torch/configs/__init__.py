"""Architecture registry: ``--arch <id>`` resolution.

A copy of the reference's ``repro/configs`` (pure Python): every
architecture, ``get_config`` with its ``-smoke`` suffix, and ``reduced``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (
    SHAPES,
    EncoderSpec,
    MLASpec,
    MoESpec,
    ModelConfig,
    ParallelSpec,
    RecurrentSpec,
    ShapeSpec,
    reduced,
    shape_applicable,
)

_ARCH_MODULES = {
    "whisper-large-v3":   "repro_torch.configs.whisper_large_v3",
    "qwen2-7b":           "repro_torch.configs.qwen2_7b",
    "stablelm-3b":        "repro_torch.configs.stablelm_3b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "smollm-135m":        "repro_torch.configs.smollm_135m",
    "kimi-k2-1t-a32b":    "repro_torch.configs.kimi_k2_1t_a32b",
    "deepseek-v3-671b":   "repro_torch.configs.deepseek_v3_671b",
    "phi-3-vision-4.2b":  "repro_torch.configs.phi_3_vision_4_2b",
    "recurrentgemma-2b":  "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-1.6b":         "repro_torch.configs.rwkv6_1_6b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = [
    "ARCH_NAMES", "SHAPES", "ShapeSpec", "ModelConfig", "MoESpec", "MLASpec",
    "EncoderSpec", "RecurrentSpec", "ParallelSpec", "get_config",
    "all_configs", "reduced", "shape_applicable",
]
