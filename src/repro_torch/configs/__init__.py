"""Assigned architecture configs + shape registry (port of
:mod:`repro.configs`)."""
from repro_torch.configs.base import (SHAPES, BlockKind, InputShape,
                                      MixerKind, ModelConfig, TrainConfig,
                                      shape_applicable)
from repro_torch.configs.registry import (ARCH_IDS, get_config, get_shape,
                                          iter_cells)

__all__ = ["SHAPES", "BlockKind", "InputShape", "MixerKind", "ModelConfig",
           "TrainConfig", "shape_applicable", "ARCH_IDS", "get_config",
           "get_shape", "iter_cells"]
