"""Architecture config registry: one module per assigned architecture.

``get_config(name)`` returns the full published config; ``get_smoke(name)``
returns the reduced same-family variant used by CPU smoke tests. The
port's copy of ``repro.configs``: the same names, widths and aliases.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, runnable_shapes

ARCHS = (
    "hubert_xlarge",
    "llama32_vision_90b",
    "internlm2_1_8b",
    "qwen25_14b",
    "phi3_medium_14b",
    "qwen3_32b",
    "jamba15_large_398b",
    "arctic_480b",
    "qwen3_moe_235b",
    "mamba2_1_3b",
)

# canonical ids from the assignment -> module names
ALIASES = {
    "hubert-xlarge": "hubert_xlarge",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2.5-14b": "qwen25_14b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-32b": "qwen3_32b",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "arctic-480b": "arctic_480b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mamba2-1.3b": "mamba2_1_3b",
}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = [
    "ARCHS", "ALIASES", "SHAPES", "ModelConfig", "ShapeSpec",
    "get_config", "get_smoke", "runnable_shapes",
]
