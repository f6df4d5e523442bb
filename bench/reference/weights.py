"""Seeded weights, made by the benchmark and handed to both sides.

Every tensor is named by the benchmark (``x @ w`` layout: ``(d_in,
d_out)``) and drawn on ``device`` from the run's seed: one ``randn`` call
for each layer and one for the embedding, the LM head and the final norm
together. A matrix is Normal(0, 1/fan_in); a norm's gain is 1 + 0.1 *
Normal(0, 1), so that a norm left out shows. The harness writes them into
the program's parameters; the reference draws them again at check time.
"""
from __future__ import annotations

import importlib

import torch

_GOLD = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9


def family(cfg: dict):
    """The reference module of the configuration's model family."""
    return importlib.import_module(f"reference.{cfg['model_type']}")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg[
        "num_attention_heads"]


def layer_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], int | None]]:
    """``(name, shape, fan_in)`` of one layer's tensors; fan_in None is a
    norm gain."""
    d, hq, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    hd = head_dim(cfg)
    spec = [("attn_norm", (d,), None), ("wq", (d, hq * hd), d),
            ("wk", (d, hkv * hd), d), ("wv", (d, hkv * hd), d),
            ("wo", (hq * hd, d), hq * hd)]
    if cfg.get("qk_norm") == "per_head":
        spec += [("q_norm", (hd,), None), ("k_norm", (hd,), None)]
    spec.append(("mlp_norm", (d,), None))
    return spec + family(cfg).mixer_spec(cfg)


def outer_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], int | None]]:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return [("embed", (v, d), d), ("lm_head", (d, v), d),
            ("final_norm", (d,), None)]


def _generator(seed: int, stream: int, device) -> torch.Generator:
    mixed = (int(seed) * _GOLD + (stream + 1) * _MIX) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _draw(spec, seed: int, stream: int, device) -> dict[str, torch.Tensor]:
    total = sum(int(torch.Size(shape).numel()) for _, shape, _ in spec)
    flat = torch.randn(total, generator=_generator(seed, stream, device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, fan_in in spec:
        n = int(torch.Size(shape).numel())
        part = flat[at:at + n].view(shape)
        at += n
        out[name] = part.mul_(fan_in ** -0.5) if fan_in else \
            part.mul_(0.1).add_(1.0)
    return out


def layer(cfg: dict, seed: int, index: int, device) -> dict[str, torch.Tensor]:
    """Layer ``index``'s tensors (views into one buffer)."""
    return _draw(layer_spec(cfg), seed, index, device)


def outer(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The embedding, LM head and final norm."""
    return _draw(outer_spec(cfg), seed, -1, device)
