"""Shared model components: RMSNorm, RoPE, SwiGLU MLP, embedding, LM head.

Port of ``repro/models/common.py``. Weights keep the reference's layout
(``x @ w`` with ``w`` of shape ``(d_in, d_out)``) so parameters convert one
to one; initialisation draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense_init(shape: tuple[int, ...], gen: torch.Generator,
               fan_in: int | None = None, dtype=torch.float32) -> nn.Parameter:
    """Normal(0, 1/fan_in) weights, drawn in float32 on ``gen``'s device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * (1.0 / fan_in) ** 0.5
    return nn.Parameter(w.to(dtype), requires_grad=False)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * gamma.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs               # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP, embedding
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU (llama family) or GELU (bigcode) channel mixer."""

    def __init__(self, d_model: int, d_ff: int, gen: torch.Generator,
                 dtype=torch.float32, variant: str = "swiglu"):
        super().__init__()
        self.w_up = dense_init((d_model, d_ff), gen, dtype=dtype)
        self.w_down = dense_init((d_ff, d_model), gen, fan_in=d_ff,
                                 dtype=dtype)
        self.w_gate = dense_init((d_model, d_ff), gen, dtype=dtype) \
            if variant == "swiglu" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_gate is not None:
            h = F.silu(x @ self.w_gate) * (x @ self.w_up)
        else:       # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(x @ self.w_up, approximate="tanh")
        return h @ self.w_down


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.table = dense_init((vocab, d_model), gen, fan_in=d_model,
                                dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32. logits (B, S, V); labels (B, S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
