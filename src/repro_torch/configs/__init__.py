"""Architecture registry of the port, a copy of ``repro/configs``:
``--arch <id>`` resolves the same names as in the JAX package.

``get_config(name)`` / ``get_smoke_config(name)`` return the full published
config / the CPU-runnable reduced config.  ``applicable_shapes(cfg)`` applies
the assignment's skip rules (encoder-only has no decode; ``long_500k`` only
for sub-quadratic archs).
"""

from __future__ import annotations

from repro_torch.configs import (
    codeqwen1_5_7b,
    gemma2_9b,
    gemma_2b,
    hubert_xlarge,
    llama3_2_vision_90b,
    moonshot_v1_16b_a3b,
    paper,
    qwen3_moe_30b_a3b,
    starcoder2_3b,
    xlstm_1_3b,
    zamba2_7b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, human

_MODULES = {
    "hubert-xlarge": hubert_xlarge,
    "xlstm-1.3b": xlstm_1_3b,
    "gemma-2b": gemma_2b,
    "gemma2-9b": gemma2_9b,
    "starcoder2-3b": starcoder2_3b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "zamba2-7b": zamba2_7b,
    "llama-3.2-vision-90b": llama3_2_vision_90b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].config()


def get_smoke_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].smoke_config()


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """Assignment skip rules; skipped cells are documented in DESIGN.md SS5."""
    out = []
    for shape in SHAPES.values():
        if cfg.encoder_only and shape.kind == "decode":
            continue  # encoder-only: no decode step
        if shape.name == "long_500k" and not cfg.subquadratic:
            continue  # pure full attention: 500k decode skipped
        out.append(shape)
    return out


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) dry-run cell."""
    cells = []
    for arch in ARCH_IDS:
        for shape in applicable_shapes(get_config(arch)):
            cells.append((arch, shape.name))
    return cells


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_cells",
    "applicable_shapes",
    "get_config",
    "get_smoke_config",
    "human",
    "paper",
]
