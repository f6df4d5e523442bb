"""StarCoder2 (arXiv:2402.19173): a dense GELU MLP after each attention
block, ``gelu_tanh(x Wu) Wd``."""
from __future__ import annotations

import torch

from reference.decoder import gelu_tanh, mm


def mixer_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [("w_up", (d, f), d), ("w_down", (f, d), f)]


def mixer(w: dict, cfg: dict, x: torch.Tensor, tf32: bool,
          theirs=None) -> tuple[torch.Tensor, int]:
    """x (T, d), already normed -> (mixer output (T, d), 0)."""
    return mm(gelu_tanh(mm(x, w["w_up"], tf32)), w["w_down"], tf32), 0
