"""Architecture registry: ``--arch <id>`` lookup for all assigned configs
(port of ``repro/configs/registry.py``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, InputShape, ModelConfig,
                                      shape_applicable)

_MODULES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "chameleon-34b": "chameleon_34b",
    "qwen3-0.6b": "qwen3_0_6b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-34b": "granite_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def iter_cells(include_inapplicable: bool = False):
    """Yield every assigned (arch, shape) dry-run cell."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if include_inapplicable or shape_applicable(cfg, shape):
                yield cfg, shape
