"""Shared model components: RMSNorm, RoPE, SwiGLU MLP, embedding, LM head.

Port of ``repro/models/common.py``. Weights keep the reference's layout
(``x @ w`` with ``w`` of shape ``(d_in, d_out)``) so parameters convert one
to one; initialisation draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import axis_size, constraint


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


def split_heads(t: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(..., h·dh) -> (..., h, dh). With a mesh whose model axis does not
    divide ``h``, the last dim is gathered first: a sharded dim splits
    only into a multiple of its shards."""
    if h % axis_size("model"):
        t = constraint(t, "data", *(None,) * (t.dim() - 1))
    return t.reshape(*t.shape[:-1], h, dh)


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
        return apply_mlp(self, x)


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The MLP of weights ``p.w_up``, ``p.w_down`` and ``p.w_gate`` (None
    for the GELU variant): an :class:`MLP`, or a namespace of a parameter
    tree's tensors (the training path's)."""
    if getattr(p, "w_gate", None) is not None:
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:       # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p.w_up, approximate="tanh")
    return constraint(h, "data", None, "model") @ p.w_down


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.table = dense_init((vocab, d_model), gen, fan_in=d_model,
                                dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


def apply_embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` from the tree's ``{"table"}``."""
    return p["table"][tokens]


def apply_lm_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Untied LM head ``x @ p["w"]``, vocab over 'model'."""
    logits = x @ p["w"]
    spec = ("data",) + (None,) * (logits.dim() - 2) + ("model",)
    return constraint(logits, *spec)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in float32. logits (B, S, V); labels (B, S) int.

    The gold logit is a masked sum over the vocabulary, as the reference
    takes it: it partitions with vocab-sharded logits, where a gather would
    collect them whole."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    return (logz - gold).mean()
