"""The program under test, as the benchmark builds it: the port's
``Engine`` on one card, its configuration taken from the benchmark's
file and its weights drawn by :mod:`reference.weights`."""
from __future__ import annotations

import math

import torch

from reference import weights


def port_config(cfg: dict):
    """The port's ``ModelConfig`` from the file's ``port`` block, whose
    widths must equal the file's published ones."""
    from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig
    p = dict(cfg["port"])
    mixer = MixerKind[p.pop("mixer")]
    mc = ModelConfig(pattern=((BlockKind.ATTN, mixer),), **p)
    same = {"num_layers": cfg["num_hidden_layers"],
            "d_model": cfg["hidden_size"],
            "num_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"],
            "vocab_size": cfg["vocab_size"],
            "head_dim_": weights.head_dim(cfg),
            "rope_theta": cfg["rope_theta"]}
    if mixer == MixerKind.MOE:
        same.update(num_experts=cfg["num_experts"],
                    experts_per_token=cfg["num_experts_per_tok"],
                    moe_d_ff=cfg["intermediate_size"],
                    capacity_factor=cfg["capacity_factor"])
    else:
        same.update(d_ff=cfg["intermediate_size"])
    for key, want in same.items():
        if getattr(mc, key) != want:
            raise ValueError(f"port config {key} = {getattr(mc, key)}, "
                             f"the file says {want}")
    if mc.qk_norm != (cfg.get("qk_norm") == "per_head"):
        raise ValueError("port qk_norm differs from the file's")
    return mc


def pool_rows(work: dict, cfg: dict, block_tokens: int) -> tuple[int, int]:
    """(num_rows, secded_rows): SECDED rows for the paid sessions' pages,
    InterWrap rows (9 pages for 8 rows) for the batch sessions' and the
    engine's scratch page, each a multiple of 8."""
    p = work["pool"]
    per = math.ceil(p["session_tokens"] / block_tokens) * cfg[
        "num_hidden_layers"]
    batch = p["batch_sessions"] * per + 1
    paid = p["paid_sessions"] * per
    cream = 8 * math.ceil(math.ceil(batch * 8 / 9) / 8)
    secded = 8 * math.ceil(paid / 8)
    return cream + secded, secded


def build(cfg: dict, work: dict, device):
    """The engine of a cell, its weights still the program's own."""
    from repro_torch.serve import Engine
    from repro_torch.serve.paged_kv import token_words_for
    mc = port_config(cfg)
    tw = token_words_for(mc.num_kv_heads, mc.head_dim_, torch.float32)
    rows, secded = pool_rows(work, cfg, 8 * work["row_words"] // tw)
    return Engine(mc, max_batch=work["max_batch"], max_len=work["max_len"],
                  mode="cream", num_rows=rows, row_words=work["row_words"],
                  max_sessions=work["max_sessions"], secded_rows=secded,
                  device=device)


@torch.no_grad()
def load_weights(model, cfg: dict, seed: int) -> None:
    """Write the benchmark's seeded weights into every parameter of the
    port's model; a parameter the benchmark does not name is an error."""
    dev = model.embed.table.device
    outer = weights.outer(cfg, seed, dev)
    named = {"embed": model.embed.table, "lm_head": model.lm_head,
             "final_norm": model.final_norm.weight}
    for name, dst in named.items():
        dst.copy_(outer[name])
    del outer
    for i, blk in enumerate(model.layers):
        w = weights.layer(cfg, seed, i, dev)
        dst = {"attn_norm": blk.norm1.weight, "mlp_norm": blk.norm2.weight}
        dst.update(dict(blk.block.named_parameters()))
        dst.update(dict(blk.mixer.named_parameters()))
        if set(dst) != set(w):
            raise ValueError(f"layer {i}: the port holds {sorted(dst)}, "
                             f"the benchmark draws {sorted(w)}")
        for name, t in w.items():
            dst[name].copy_(t)
        del w
