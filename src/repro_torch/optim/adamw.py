"""AdamW with gradient clipping and optional int8 gradient compression.

Port of ``repro/optim/adamw.py``. Functional, as the reference: ``init ->
state``, ``update(grads, state, params) -> (new_params, new_state)``, over
trees of tensors (:mod:`repro_torch.distributed.sharding`). Moments are
float32 whatever the parameter dtype; the update runs in float32 and casts
back to the parameter's dtype. The step counter and the learning rate stay
on the parameters' device (no host round trip a step). The trainer can
snapshot the moments into a SECDED CREAM pool (fault tolerance).

Data parallelism (:func:`average_over_replicas`): each replica's gradients
and loss are averaged over the replicas with one all-reduce before the
norm, the clipping and the update, so every replica applies the same
update to the same parameters.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.sharding import (tree_leaves, tree_map,
                                              tree_unflatten)


@dataclass
class AdamWState:
    step: torch.Tensor     # () int32
    m: Any
    v: Any


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=tree_map(torch.clone, zeros))


def cosine_schedule(cfg: TrainConfig):
    """step (int tensor) -> learning rate (float32): linear warmup, then a
    half cosine to 0 at ``total_steps``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        return cfg.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


# -- gradient compression (distributed-optimization trick) -------------------


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: (q, scale)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8), \
        scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def maybe_compress_grads(grads, mode: str):
    """Compress -> decompress: on one card there is no reduction and the
    round trip's rounding is the effect; data-parallel replicas quantise
    their own gradients so, before :func:`average_over_replicas` (the
    values reduced are the quantised ones; the wire carries float32)."""
    if mode == "none":
        return grads
    if mode == "int8":
        def roundtrip(g):
            q, s = compress_int8(g.float())
            return decompress_int8(q, s)
        return tree_map(roundtrip, grads)
    raise ValueError(mode)


@torch.no_grad()
def average_over_replicas(replicas, loss: torch.Tensor, grads
                          ) -> tuple[torch.Tensor, Any]:
    """The mean over data-parallel ``replicas``
    (:class:`repro_torch.distributed.sharding.Replicas`) of each replica's
    loss and gradients: one float32 buffer, one SUM all-reduce, one
    division. Every replica gets the same bits back; the gradients come
    back float32."""
    import torch.distributed as dist
    leaves = tree_leaves(grads)
    flat = torch.cat([loss.detach().float().reshape(1)]
                     + [g.float().reshape(-1) for g in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=replicas.group)
    flat /= replicas.size
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return flat[0], tree_unflatten(grads, out)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: TrainConfig
           ) -> tuple[Any, AdamWState]:
    """Returns (new_params, new_state); new tensors, the inputs unchanged."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_schedule(cfg)(step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    c1 = 1 - torch.pow(b1, stepf)
    c2 = 1 - torch.pow(b2, stepf)

    def upd(g, m, v, p):
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay \
            * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, grads, state.m, state.v, params)
    return _pick(out, 0), AdamWState(step=step, m=_pick(out, 1),
                                     v=_pick(out, 2))


def _pick(tree, i: int):
    """Element ``i`` of every ``(param, m, v)`` triple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(t, i) for t in tree]
    return tree[i]
