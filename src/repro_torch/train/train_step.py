"""The training step: loss -> grads -> (compressed) update.

Port of ``repro/train/train_step.py``. The gradient is taken with
``torch.autograd.grad`` of :func:`repro_torch.models.transformer.loss_fn`
with respect to every parameter leaf. Gradient accumulation runs the
microbatches in turn (activation memory bound by one microbatch): the
losses and the gradients are summed in float32 and then scaled by
``1/n_micro``, as the reference's scan does. ``grad_compression='int8'``
quantises and dequantises the gradients before the norm and the update.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed.sharding import (tree_leaves, tree_map,
                                              tree_unflatten)
from repro_torch.models import transformer
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    attn_impl: str = "xla"):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); the inputs are left as they were."""

    def grad_fn(params, tokens, labels):
        # the step's own aliases of the leaves take the gradient; the
        # caller's parameters stay grad-free
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(tree)
        with torch.enable_grad():
            loss = transformer.loss_fn(tree, cfg, tokens, labels,
                                       attn_impl=attn_impl,
                                       remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(tree, grads)

    def whole_batch_grads(params, batch):
        return grad_fn(params, batch["tokens"], batch["labels"])

    def microbatched_grads(params, batch, n_micro: int):
        b = batch["tokens"].shape[0]
        assert b % n_micro == 0
        mb = b // n_micro
        toks = batch["tokens"].reshape(n_micro, mb, -1)
        labs = batch["labels"].reshape(n_micro, mb, -1)
        loss_acc = torch.zeros((), dtype=torch.float32, device=toks.device)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(n_micro):
            loss, g = grad_fn(params, toks[i], labs[i])
            g_acc = tree_map(lambda a, b_: a + b_.float(), g_acc, g)
            loss_acc = loss_acc + loss
        scale = 1.0 / n_micro
        return loss_acc * scale, tree_map(lambda g: g * scale, g_acc)

    def train_step(params, opt_state, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            loss, grads = microbatched_grads(params, batch, tcfg.microbatch)
        else:
            loss, grads = whole_batch_grads(params, batch)
        grads = adamw.maybe_compress_grads(grads, tcfg.grad_compression)
        gnorm = adamw.global_norm(grads)
        params, opt_state = adamw.update(grads, opt_state, params, tcfg)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step
