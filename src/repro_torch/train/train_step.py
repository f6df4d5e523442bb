"""The training step: loss -> grads -> (compressed) update.

Port of ``repro/train/train_step.py``. The gradient is taken with
``torch.autograd.grad`` of :func:`repro_torch.models.transformer.loss_fn`
with respect to every parameter leaf. Gradient accumulation runs the
microbatches in turn (activation memory bound by one microbatch): the
losses and the gradients are summed in float32 and then scaled by
``1/n_micro``, as the reference's scan does. ``grad_compression='int8'``
quantises and dequantises the gradients before the norm and the update.

With data-parallel ``replicas`` (a host mesh, :func:`repro_torch.
distributed.sharding.data_replicas`) each replica computes the loss and
the gradients of its rows of the batch on plain tensors (microbatches
accumulated locally first), quantises them with ``int8`` compression,
and one all-reduce averages loss and gradients
(:func:`repro_torch.optim.adamw.average_over_replicas`) before the norm,
the clipping and AdamW: every replica applies the same update. The
reference gets the same from GSPMD's reduction of the gradients over its
``data`` axis.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed.sharding import (tree_leaves, tree_map,
                                              tree_unflatten, use_mesh)
from repro_torch.models import transformer
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    attn_impl: str = "xla", replicas=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); the inputs are left as they were. With ``replicas``,
    ``batch`` is this replica's rows and the step is data-parallel."""

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
        # a replica's rows are its own plain tensors: no mesh constraint
        with use_mesh(None) if replicas else contextlib.nullcontext():
            if tcfg.microbatch and tcfg.microbatch > 1:
                loss, grads = microbatched_grads(params, batch,
                                                 tcfg.microbatch)
            else:
                loss, grads = whole_batch_grads(params, batch)
        grads = adamw.maybe_compress_grads(grads, tcfg.grad_compression)
        if replicas:
            loss, grads = adamw.average_over_replicas(replicas, loss, grads)
        gnorm = adamw.global_norm(grads)
        params, opt_state = adamw.update(grads, opt_state, params, tcfg)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step
