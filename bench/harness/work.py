"""Counted work: model FLOPs from the configuration's shapes, the bytes a
pool read or write must move, and the card's published peaks."""
from __future__ import annotations

#: NVIDIA H100 SXM5 (80 GB HBM3) data sheet, dense, at the 700 W limit:
#: float32 outside the tensor cores and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}}


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def _layer_token_flops(cfg: dict) -> float:
    """Matrix FLOPs of one token through one layer, attention's keys
    apart (2 per multiply-add; only the experts a token is routed to)."""
    d, hq, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                  cfg["num_key_value_heads"])
    hd = cfg.get("head_dim") or d // hq
    f = cfg["intermediate_size"]
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    if cfg.get("num_experts"):
        mixer = 2 * d * cfg["num_experts"] + \
            cfg["num_experts_per_tok"] * 3 * 2 * d * f
    else:
        mixer = 2 * 2 * d * f
    return proj + mixer


def _attn_flops(cfg: dict, keys: float) -> float:
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // hq
    return 2 * 2 * hq * hd * keys


def prefill_flops(cfg: dict, prompt: int) -> float:
    """A prompt of ``prompt`` tokens, causal, and its last position's
    logits."""
    L = cfg["num_hidden_layers"]
    keys = prompt * (prompt + 1) / 2
    return L * (prompt * _layer_token_flops(cfg) + _attn_flops(cfg, keys)) \
        + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def decode_flops(cfg: dict, keys: int) -> float:
    """One token attending to ``keys`` positions (itself included), and
    its logits."""
    L = cfg["num_hidden_layers"]
    return L * (_layer_token_flops(cfg) + _attn_flops(cfg, keys)) \
        + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def gather_bytes(n: int, unique: int, secded: int, row_words: int) -> float:
    """A mixed read of ``n`` pages, ``unique`` of them distinct and
    ``secded`` of those SECDED: each distinct page's 8 data lanes and a
    SECDED page's code lane read once, every page written once."""
    page = 8 * row_words * 4
    return unique * page + secded * row_words * 4 + n * page


def scatter_bytes(n: int, unique: int, secded: int, row_words: int) -> float:
    """A pool write of ``n`` pages: the data read once, each distinct
    page's slices written once, a SECDED page's code lane written once."""
    page = 8 * row_words * 4
    return n * page + unique * page + secded * row_words * 4
