"""Assigned architecture registry: `get_config(arch_id)`.

A copy of `repro.configs` (framework-free dataclasses), kept in the port
so that `repro_torch` imports nothing of the JAX package."""

from typing import Dict

from .base import SHAPES, SUBQUADRATIC_FAMILIES, ModelConfig, ShapeSpec
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .gemma2_27b import CONFIG as gemma2_27b
from .internvl2_1b import CONFIG as internvl2_1b
from .llama3_405b import CONFIG as llama3_405b
from .llama3_8b import CONFIG as llama3_8b
from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .qwen3_32b import CONFIG as qwen3_32b
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .xlstm_1p3b import CONFIG as xlstm_1p3b
from .zamba2_1p2b import CONFIG as zamba2_1p2b

CONFIGS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        internvl2_1b,
        whisper_large_v3,
        llama3_405b,
        gemma2_27b,
        qwen3_32b,
        llama3_8b,
        zamba2_1p2b,
        deepseek_v3_671b,
        olmoe_1b_7b,
        xlstm_1p3b,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch '{arch}'; available: {sorted(CONFIGS)}")
    return CONFIGS[arch]


def applicable_shapes(cfg: ModelConfig):
    """The benchmark cells that apply to this arch (long_500k only for
    sub-quadratic families; see DESIGN.md §Arch-applicability)."""
    out = []
    for s in SHAPES.values():
        if s.kind == "long_decode" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue
        out.append(s)
    return out


__all__ = [
    "CONFIGS",
    "get_config",
    "applicable_shapes",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
]
