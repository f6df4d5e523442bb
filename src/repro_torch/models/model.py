"""Model facade: build a decoder, count its parameters, and move its
weights to and from the reference's parameter tree.

Port of ``repro/models/model.py``'s ``build_model`` and ``count_params``,
plus :func:`load_jax_params`, which lets a test make both packages compute
the same function from one set of weights, and its inverse
:func:`params_tree`, the model's weights as the reference's tree — the
tree the training path (:func:`repro_torch.models.transformer.loss_fn`),
the moment pool and the checkpoints work on.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import MixerKind, ModelConfig
from repro_torch.models.transformer import Transformer, check_ported


def build_model(cfg: ModelConfig, attn_impl: str = "xla", seed: int = 0,
                device=None) -> Transformer:
    """A decoder with weights drawn from ``seed`` on ``device`` whose
    prefill and forward attend with ``attn_impl`` (``"xla"`` or
    ``"flash"``)."""
    return Transformer(cfg, seed=seed, device=device, attn_impl=attn_impl)


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.tensor(src))


@torch.no_grad()
def load_jax_params(model: Transformer, np_tree: dict) -> Transformer:
    """Copy the reference's parameter tree (numpy leaves) into ``model``.

    The reference stacks each pattern position's parameters over stages on
    a leading axis (``repro/models/transformer.py`` ``init_params``); layer
    ``s * period + i`` takes stage ``s`` of position ``i``.
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
            for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
                if name in entry["block"]:
                    _copy(getattr(blk.attn, name), entry["block"][name][s])
            if blk.mlp is not None:
                _copy(blk.norm2.weight, entry["norm2"][s])
                for name in ("w_gate", "w_up", "w_down"):
                    if name in entry["mixer"]:
                        _copy(getattr(blk.mlp, name), entry["mixer"][name][s])
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

    def stacked(get, i):
        return torch.stack([get(model.layers[s * cfg.period + i])
                            for s in range(cfg.num_stages)])

    stages = {}
    for i in range(cfg.period):
        blk = model.layers[i]
        names = [n for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
                 if hasattr(blk.attn, n)]
        entry = {"norm1": stacked(lambda b: b.norm1.weight, i),
                 "block": _sorted({n: stacked(
                     lambda b, n=n: getattr(b.attn, n), i) for n in names})}
        if blk.mlp is not None:
            names = [n for n in ("w_gate", "w_up", "w_down")
                     if getattr(blk.mlp, n) is not None]
            entry["norm2"] = stacked(lambda b: b.norm2.weight, i)
            entry["mixer"] = _sorted({n: stacked(
                lambda b, n=n: getattr(b.mlp, n), i) for n in names})
        stages[f"pos{i}"] = _sorted(entry)
    tree = {"embed": {"table": model.embed.table.detach().clone()},
            "final_norm": model.final_norm.weight.detach().clone(),
            "stages": _sorted(stages)}
    if model.lm_head is not None:
        tree["lm_head"] = {"w": model.lm_head.detach().clone()}
    return _sorted(tree)


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of the reference's ``init_params`` tree,
    from the shapes alone (no allocation). Only the families the port
    builds (attention blocks with MLP or no mixers, all of whose
    parameters are active) are counted; others raise as
    :class:`Transformer` does."""
    check_ported(cfg)
    d, hd = cfg.d_model, cfg.head_dim_
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2 \
        + (2 * hd if cfg.qk_norm else 0)
    mlp = d * cfg.d_ff * (3 if cfg.mlp_variant == "swiglu" else 2)
    per_stage = sum(d + attn + (d + mlp if mk == MixerKind.MLP else 0)
                    for _, mk in cfg.pattern)
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    return cfg.vocab_size * d + d + head + cfg.num_stages * per_stage
