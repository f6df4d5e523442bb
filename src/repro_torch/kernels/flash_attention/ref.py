"""Plain PyTorch version of flash attention (causal, GQA-aware)."""
from __future__ import annotations

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """q (B, Hq, S, D); k, v (B, Hkv, S, D) with Hq % Hkv == 0.

    Returns (B, Hq, S, D) in q's dtype; the softmax and both products in
    float32. Holds the whole (B, Hq, S, S) logits tensor.
    """
    s, d = q.shape[2], q.shape[3]
    groups = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kx = k.repeat_interleave(groups, dim=1).float()
    vx = v.repeat_interleave(groups, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)
