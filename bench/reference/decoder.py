"""The plain decoder shared by the model families: pre-norm layers of
grouped-query attention with RoPE, then the family's channel mixer.

Straight from the published descriptions, with the departures the
configuration file states: RMSNorm everywhere, no biases, per-head
qk-norm where ``qk_norm`` is ``"per_head"``. Everything is float32 and
computed position by position where that is plainer than batching. With
``tf32=True`` every matrix product rounds its operands to TF32 (10
mantissa bits) first: the benchmark's control, the precision one step
below the configuration's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.weights import head_dim


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10-bit mantissa (to nearest, ties to
    even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (n, h, hd) at positions ``pos`` (n,): the first and
    second halves of each head are the pairs (GPT-NeoX order)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _eps(cfg: dict) -> float:
    return cfg.get("rms_norm_eps", cfg.get("norm_epsilon", 1e-5))


def qkv(w: dict, cfg: dict, h: torch.Tensor, pos: torch.Tensor, tf32: bool):
    """Normed hidden ``h`` (n, d) at ``pos`` -> q (n, hq, hd), k, v (n, hkv,
    hd)."""
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   head_dim(cfg))
    q = mm(h, w["wq"], tf32).view(-1, hq, hd)
    k = mm(h, w["wk"], tf32).view(-1, hkv, hd)
    v = mm(h, w["wv"], tf32).view(-1, hkv, hd)
    if cfg.get("qk_norm") == "per_head":
        q = rms_norm(q, w["q_norm"], _eps(cfg))
        k = rms_norm(k, w["k_norm"], _eps(cfg))
    theta = cfg["rope_theta"]
    return rope(q, pos, theta), rope(k, pos, theta), v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: torch.Tensor, window: int | None, tf32: bool) -> torch.Tensor:
    """Causal attention of queries ``q`` (n, hq, hd) at ``qpos`` over keys
    and values ``k``/``v`` (m, hkv, hd) at positions 0..m-1; KV head j
    serves query heads j*g .. j*g + g - 1."""
    hq, hkv, hd = q.shape[1], k.shape[1], q.shape[2]
    g = hq // hkv
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    scores = mm(q.transpose(0, 1), kk.permute(1, 2, 0), tf32) / hd ** 0.5
    kpos = torch.arange(k.shape[0], device=q.device)
    allowed = kpos[None, :] <= qpos[:, None]
    if window:
        allowed &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~allowed[None], float("-inf"))
    out = mm(torch.softmax(scores, dim=-1), vv.transpose(0, 1), tf32)
    return out.transpose(0, 1).reshape(q.shape[0], hq * hd)


def mixer_in(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, w["mlp_norm"], _eps(cfg))


def attn_in(w: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, w["attn_norm"], _eps(cfg))


def logits(outer: dict, cfg: dict, x: torch.Tensor, tf32: bool
           ) -> torch.Tensor:
    return mm(rms_norm(x, outer["final_norm"], _eps(cfg)), outer["lm_head"],
              tf32)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
