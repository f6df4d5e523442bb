"""Model facade: build a decoder, or load the reference's parameters into it.

Port of ``repro/models/model.py``'s ``build_model``, plus
:func:`load_jax_params`, which lets a test make both packages compute the
same function from one set of weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


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
