"""Model facade: build a decoder, count its parameters, and move its
weights to and from the reference's parameter tree.

Port of ``repro/models/model.py``'s ``build_model``, ``count_params``
and ``model_flops_per_token``, plus :func:`load_jax_params`, which lets
a test make both packages compute the same function from one set of
weights, and its inverse
:func:`params_tree`, the model's weights as the reference's tree — the
tree the training path (:func:`repro_torch.models.transformer.loss_fn`),
the moment pool and the checkpoints work on.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig
from repro_torch.models import xlstm
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, attn_impl: str = "xla", seed: int = 0,
                device=None, remat: str = "none") -> Transformer:
    """A decoder with weights drawn from ``seed`` on ``device`` whose
    prefill and forward attend with ``attn_impl`` (``"xla"`` or
    ``"flash"``); ``remat`` is kept as the model's ``remat``, the
    reference's default for its forward and loss."""
    return Transformer(cfg, seed=seed, device=device, attn_impl=attn_impl,
                       remat=remat)


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.tensor(src))


def _weights(module) -> dict:
    """A block's or mixer's own tensors by the reference's names."""
    return dict(module.named_parameters(recurse=False))


@torch.no_grad()
def load_jax_params(model: Transformer, np_tree: dict) -> Transformer:
    """Copy the reference's parameter tree (numpy leaves) into ``model``.

    The reference stacks each pattern position's parameters over stages on
    a leading axis (``repro/models/transformer.py`` ``init_params``); layer
    ``s * period + i`` takes stage ``s`` of position ``i``. Every block and
    mixer weight must be in the tree, and nothing else.
    """
    cfg = model.cfg
    _copy(model.embed.table, np_tree["embed"]["table"])
    _copy(model.final_norm.weight, np_tree["final_norm"])
    if model.lm_head is not None:
        _copy(model.lm_head, np_tree["lm_head"]["w"])
    for s in range(cfg.num_stages):
        for i in range(cfg.period):
            blk = model.layers[s * cfg.period + i]
            entry = np_tree["stages"][f"pos{i}"]
            _copy(blk.norm1.weight, entry["norm1"][s])
            parts = [("block", blk.block)]
            if blk.mixer is not None:
                _copy(blk.norm2.weight, entry["norm2"][s])
                parts.append(("mixer", blk.mixer))
            for part, module in parts:
                own = _weights(module)
                if set(own) != set(entry[part]):
                    raise ValueError(f"pos{i}/{part}: {sorted(entry[part])}"
                                     f" != {sorted(own)}")
                for name, w in own.items():
                    _copy(w, entry[part][name][s])
    return model


def _sorted(d: dict) -> dict:
    return {k: d[k] for k in sorted(d)}


@torch.no_grad()
def params_tree(model: Transformer) -> dict:
    """The model's weights as the reference's parameter tree: the inverse
    of :func:`load_jax_params`.

    ``embed/table``, ``final_norm``, ``lm_head/w`` (untied heads), and
    ``stages/pos{i}/{norm1,block,norm2,mixer}/...`` with each pattern
    position's tensors stacked over stages on axis 0. Every dict has its
    keys sorted, as ``jax.tree.map`` leaves the reference's trees, so the
    leaves come in the reference's order. The leaves are new tensors (the
    model's own parameters are not shared).
    """
    cfg = model.cfg

    def stacked(tensors):
        return torch.stack(list(tensors))

    stages = {}
    for i in range(cfg.period):
        layers = [model.layers[s * cfg.period + i]
                  for s in range(cfg.num_stages)]
        entry = {"norm1": stacked(b.norm1.weight for b in layers),
                 "block": _sorted({n: stacked(_weights(b.block)[n]
                                              for b in layers)
                                   for n in _weights(layers[0].block)})}
        if layers[0].mixer is not None:
            entry["norm2"] = stacked(b.norm2.weight for b in layers)
            entry["mixer"] = _sorted({n: stacked(_weights(b.mixer)[n]
                                                 for b in layers)
                                      for n in _weights(layers[0].mixer)})
        stages[f"pos{i}"] = _sorted(entry)
    tree = {"embed": {"table": model.embed.table.detach().clone()},
            "final_norm": model.final_norm.weight.detach().clone(),
            "stages": _sorted(stages)}
    if model.lm_head is not None:
        tree["lm_head"] = {"w": model.lm_head.detach().clone()}
    return _sorted(tree)


def _block_params(kind: BlockKind, cfg: ModelConfig) -> int:
    d = cfg.d_model
    if kind == BlockKind.ATTN:
        hd = cfg.head_dim_
        return d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2 \
            + (2 * hd if cfg.qk_norm else 0)
    if kind == BlockKind.MAMBA:
        di, n, r = cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank_
        # in_proj, conv_w, x_bc, x_dt, dt_proj, dt_bias, a_log, d_skip,
        # out_proj
        return d * 2 * di + cfg.ssm_conv_dim * di + di * 2 * n + di * r \
            + r * di + di + di * n + di + di * d
    h = cfg.num_heads
    if kind == BlockKind.MLSTM:
        dc, dh = xlstm.PF * d, xlstm.PF * d // h
        # w_up, conv_w, wq/wk/wv, wi/wf, gn, w_down
        return d * 2 * dc + xlstm.CONV_K * dc + 3 * h * dh * dh \
            + 2 * dc * h + dh + dc * d
    dh = d // h
    # four gate matrices and their head-wise recurrences, gn, w_out
    return 4 * (d * d + h * dh * dh) + dh + d * d


def _mixer_params(kind: MixerKind, cfg: ModelConfig) -> int:
    d = cfg.d_model
    if kind == MixerKind.MLP:
        return d * cfg.d_ff * (3 if cfg.mlp_variant == "swiglu" else 2)
    if kind == MixerKind.MOE:
        return d * cfg.num_experts \
            + 3 * cfg.num_experts * d * cfg.moe_d_ff
    return 0


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of the reference's ``init_params`` tree, from
    the shapes alone (no allocation). ``active_only`` counts the
    parameters one token touches: an MoE layer's top-k experts, not all
    E."""
    d = cfg.d_model
    per_stage = sum(
        d + _block_params(bk, cfg)
        + (d + _mixer_params(mk, cfg) if mk != MixerKind.NONE else 0)
        for bk, mk in cfg.pattern)
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    total = cfg.vocab_size * d + d + head + cfg.num_stages * per_stage
    if not active_only or not cfg.num_experts:
        return total
    moe_layers = cfg.num_stages * sum(1 for _, mk in cfg.pattern
                                      if mk == MixerKind.MOE)
    idle = 3 * d * cfg.moe_d_ff * (cfg.num_experts - cfg.experts_per_token)
    return total - moe_layers * idle


def model_flops_per_token(cfg: ModelConfig, active_only: bool = True
                          ) -> float:
    """The roofline's MODEL_FLOPS: 6·N per token (N = active params)."""
    return 6.0 * count_params(cfg, active_only=active_only)
