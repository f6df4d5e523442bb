"""Tests of the benchmark's harness. They put ``bench/`` and the port's
``src/`` on the path, register the ``card`` marker (tests that need a
CUDA device; they skip here) and build tiny cells that run whole on the
CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_OLMOE = {
    "model_type": "olmoe", "hidden_size": 64, "intermediate_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_experts": 8, "num_experts_per_tok": 2,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "qk_norm": "per_head", "capacity_factor": 1.25,
    "port": {"name": "tiny-olmoe", "family": "moe", "num_layers": 2,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 32,
             "vocab_size": 256, "qk_norm": True, "mixer": "MOE",
             "num_experts": 8, "experts_per_token": 2, "moe_d_ff": 32,
             "capacity_factor": 1.25, "rope_theta": 10000.0,
             "norm_eps": 1e-5, "dtype": "float32"}}
TINY_STARCODER2 = {
    "model_type": "starcoder2", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "vocab_size": 256, "rope_theta": 10000.0,
    "norm_epsilon": 1e-5, "sliding_window": 4096,
    "port": {"name": "tiny-starcoder2", "family": "dense", "num_layers": 2,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
             "vocab_size": 256, "mlp_variant": "gelu", "mixer": "MLP",
             "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32"}}
TINY_WORK = {
    "max_batch": 4, "max_len": 64, "row_words": 64, "max_sessions": 16,
    "pool": {"batch_sessions": 3, "paid_sessions": 1, "session_tokens": 64},
    "warmup_polls": 2, "drain_seconds": 20,
    "trace": {"skip_polls": 1, "polls": 4},
    "audit": {"steps": 3, "prefills": 1, "max_polls": 12, "base": 3},
    "limits": {"gather_mismatch": 0, "store_mismatch": 0, "len_mismatch": 0,
               "kv_err": 1e-4, "logit_err": 1e-4, "token_gap": 1e-4}}
TINY_SINGLE = {"kind": "single", "clients": 4, "paid_share": 0.25,
               "turns": 256,
               "prompt": {"median": 12, "sigma": 0.5, "min": 4, "max": 40,
                          "block": 16},
               "output": {"median": 6, "sigma": 0.4, "min": 3, "max": 20,
                          "block": 16}}
TINY_SESSIONS = {"kind": "sessions", "clients": 4, "sessions": 8,
                 "zipf": 0.8, "pick_block": 64, "paid_share": 0.25,
                 "turns": 256,
                 "first_prompt": {"min": 8, "max": 16, "block": 8},
                 "output": {"min": 3, "max": 8, "block": 8}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")


def tiny_cell(family: str = "olmoe", mix: str = "single", **work):
    """A whole cell at a size the CPU runs in seconds."""
    from harness import spec
    cfg = copy.deepcopy(TINY_OLMOE if family == "olmoe" else TINY_STARCODER2)
    wk = copy.deepcopy(TINY_WORK)
    wk.update(work)
    if mix == "sessions":
        wk["pool"] = {"batch_sessions": 3, "paid_sessions": 2,
                      "session_tokens": 48}
        wk["audit"] = dict(wk["audit"], prefills=0)
    traffic = copy.deepcopy(TINY_SINGLE if mix == "single"
                            else TINY_SESSIONS)
    return spec.Cell(name=f"tiny.{family}.{mix}", chips=1, config=cfg,
                     traffic=traffic, workload=wk, end_to_end=[],
                     per_layer=[])
