"""Model configuration — the port of ``repro/configs/base.py`` without jax.

Same fields, defaults and :meth:`ModelConfig.smoke` reduction as the
reference; ``activation_dtype`` maps the dtype name to a ``torch.dtype``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import torch


class BlockKind(enum.Enum):
    ATTN = "attn"
    MAMBA = "mamba"
    MLSTM = "mlstm"
    SLSTM = "slstm"


class MixerKind(enum.Enum):
    MLP = "mlp"      # dense SwiGLU
    MOE = "moe"      # top-k mixture of experts
    NONE = "none"    # block has no separate channel mixer (xLSTM)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qk_norm: bool = False
    mlp_variant: str = "swiglu"        # swiglu (llama-family) | gelu (bigcode)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # one period of (block, mixer) pairs, tiled num_layers / period times
    pattern: tuple[tuple[BlockKind, MixerKind], ...] = (
        (BlockKind.ATTN, MixerKind.MLP),)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # Mamba
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int | None = None
    subquadratic: bool = False
    frontend: str = "token"
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def num_stages(self) -> int:
        if self.num_layers % self.period:
            raise ValueError(
                f"{self.name}: layers {self.num_layers} % period {self.period}")
        return self.num_layers // self.period

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        period = self.period
        n_layers = max(period, 2 if period == 1 else period)
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(4, self.num_kv_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.num_experts else 0,
            ssm_state_dim=8,
            ssm_dt_rank=8,
            dtype="float32",
        )
