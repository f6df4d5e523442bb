"""OLMoE (arXiv:2409.02060): a sparse mixture of experts after each
attention block.

The router's softmax in float32 picks each token's top-k experts (ties to
the lower index); the gates are the chosen probabilities renormalised to
sum 1. Each expert takes at most C = max(1, min(int(capacity_factor * T *
k / E), T)) of the T tokens of one call, first come in token order; a
token past its expert's capacity gets nothing from it. An expert is a
SwiGLU: (silu(x Wg) * (x Wu)) Wd.

The program's routing may be handed in: where its expert set differs
from the reference's own only by experts whose probabilities lie within
``TIE`` of the reference's k-th largest, the program's set is taken (a
tie the two sides broke differently by rounding), and counted.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.decoder import mm

#: The widest probability gap the reference accepts as a tie.
TIE = 1e-5


def mixer_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    d, e, f = (cfg["hidden_size"], cfg["num_experts"],
               cfg["intermediate_size"])
    return [("router", (d, e), d), ("w_gate", (e, d, f), d),
            ("w_up", (e, d, f), d), ("w_down", (e, f, d), f)]


def capacity(cfg: dict, tokens: int) -> int:
    cap = int(cfg["capacity_factor"] * tokens * cfg["num_experts_per_tok"]
              / cfg["num_experts"])
    return max(1, min(cap, tokens))


def choose(probs: torch.Tensor, k: int, theirs: torch.Tensor | None
           ) -> tuple[torch.Tensor, int]:
    """Top-k expert ids (T, k) of ``probs``, and how many tokens took the
    program's tied choice ``theirs``."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    mine = order[:, :k]
    if theirs is None:
        return mine, 0
    theirs = theirs.to(mine.device).long()
    same = (torch.sort(mine, dim=-1).values
            == torch.sort(theirs, dim=-1).values).all(dim=-1)
    kth = probs.gather(1, mine[:, -1:]).squeeze(1)
    chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, theirs, True)
    lowest = torch.where(chosen, probs, float("inf")).amin(dim=-1)
    highest = torch.where(chosen, float("-inf"), probs).amax(dim=-1)
    tied = ~same & (kth - lowest <= TIE) & (highest - kth <= TIE)
    return torch.where(tied[:, None], theirs, mine), int(tied.sum())


def mixer(w: dict, cfg: dict, x: torch.Tensor, tf32: bool,
          theirs: torch.Tensor | None = None) -> tuple[torch.Tensor, int]:
    """x (T, d), already normed -> (mixer output (T, d), ties taken)."""
    t, k, e = x.shape[0], cfg["num_experts_per_tok"], cfg["num_experts"]
    probs = torch.softmax(mm(x, w["router"], tf32), dim=-1)
    idx, ties = choose(probs, k, theirs)
    gates = probs.gather(1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = capacity(cfg, t)
    out = torch.zeros_like(x)
    for ex in range(e):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)   # token order
        tok, slot = tok[:cap], slot[:cap]
        if not len(tok):
            continue
        xe = x[tok]
        h = F.silu(mm(xe, w["w_gate"][ex], tf32)) * mm(xe, w["w_up"][ex],
                                                        tf32)
        out.index_add_(0, tok, gates[tok, slot, None] * mm(h, w["w_down"][ex],
                                                           tf32))
    return out, ties
