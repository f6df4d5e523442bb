"""Top-k mixture of experts with capacity-based scatter dispatch.

Port of ``repro/models/moe.py``. Each (token, choice) gets a *slot* =
expert·C + its position in the expert's queue, the tokens are
scatter-added into an (E·C, d) expert buffer, the experts run as three
batched products over that buffer, and the outputs are gathered back
weighted by the renormalised router gates. Routing is float32; a
Switch-style load-balance loss comes back for the trainer. Overflow past
the capacity C falls through to the residual stream.

The semantics are the reference's, batch dependence included: C grows
with the tokens of the call, and queue positions are first come in the
flattened (token, choice) order, so a token's output depends on which
tokens share its call. Ties in the router's probabilities go to the lower
expert index first, as ``jax.lax.top_k`` orders them (a stable descending
sort; ``torch.topk``'s tie order on CUDA is unspecified).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constraint
from repro_torch.models.common import dense_init


class MoE(nn.Module):
    """Router (d, E) in float32; expert weights (E, d, f) / (E, f, d) in
    the activation dtype, at the reference's ``dense_init`` scales."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.router = dense_init((d, e), gen, dtype=torch.float32)
        self.w_gate = dense_init((e, d, f), gen, fan_in=d, dtype=dtype)
        self.w_up = dense_init((e, d, f), gen, fan_in=d, dtype=dtype)
        self.w_down = dense_init((e, f, d), gen, fan_in=f, dtype=dtype)


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    cap = int(cfg.capacity_factor * tokens * cfg.experts_per_token
              / cfg.num_experts)
    return max(1, min(cap, tokens))


def route(p, cfg: ModelConfig, xt: torch.Tensor):
    """Router of ``xt`` (T, d) -> (probs (T, E) float32, top-k expert ids
    (T, k), their renormalised gates (T, k))."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.experts_per_token]
    gates = probs.gather(1, idx)
    return probs, idx, gates / gates.sum(dim=-1, keepdim=True)


def dispatch(cfg: ModelConfig, idx: torch.Tensor, c: int):
    """Queue slots of the flattened (token, choice) pairs: ``(slot, keep)``
    each (T·k,), ``slot`` = expert·C + queue position for a kept pair and
    the pad slot E·C for an overflowing one. Positions are first come in
    the flattened order: a stable sort by expert and an exclusive prefix
    of the per-expert counts."""
    e = cfg.num_experts
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    keep = pos < c
    return torch.where(keep, flat * c + pos, e * c), keep


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar).

    ``p`` holds ``router``, ``w_gate``, ``w_up`` and ``w_down``: a
    :class:`MoE`, or a namespace of a parameter tree's tensors (the
    training path's)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, idx, gates = route(p, cfg, xt)

    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    fe = torch.bincount(idx[:, 0], minlength=e).float() / t
    aux = e * torch.sum(fe * probs.mean(dim=0))

    c = moe_capacity(cfg, t)
    slot, keep = dispatch(cfg, idx, c)
    # the pad slot e*c absorbs the overflow and is dropped
    expert_in = torch.zeros((e * c + 1, d), dtype=x.dtype,
                            device=x.device).index_add(
        0, slot, xt.repeat_interleave(k, dim=0))[:-1].reshape(e, c, d)
    expert_in = constraint(expert_in, "model", "data", None)
    h = F.silu(torch.bmm(expert_in, p.w_gate)) \
        * torch.bmm(expert_in, p.w_up)
    h = constraint(h, "model", "data", None)
    flat_out = torch.bmm(h, p.w_down).reshape(e * c, d)

    # gather back, weighted by the gates; dropped pairs contribute zero
    picked = flat_out[torch.where(keep, slot, 0)] \
        * (gates.reshape(t * k, 1) * keep[:, None]).to(x.dtype)
    return picked.reshape(t, k, d).sum(dim=1).reshape(b, s, d), aux
