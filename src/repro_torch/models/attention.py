"""GQA attention (RoPE, optional qk-norm): full-sequence, dense decode and
paged decode.

Port of ``repro/models/attention.py``. The full-sequence path is plain
einsum attention in float32 by default (``impl="xla"``: the reference
leaves it to XLA) or the flash-attention kernel (``impl="flash"``,
:mod:`repro_torch.kernels.flash_attention`), which never holds the
``(S, S)`` logits and serves long-context prefill. Both decode paths are
einsum attention over one new token.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import active_mesh, axis_size, constraint
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                      split_heads)


class Attention(nn.Module):
    """Projection weights (reference layout) and qk-norm scales."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim_)
        self.wq = dense_init((d, hq * hd), gen, dtype=dtype)
        self.wk = dense_init((d, hkv * hd), gen, dtype=dtype)
        self.wv = dense_init((d, hkv * hd), gen, dtype=dtype)
        self.wo = dense_init((hq * hd, d), gen, fan_in=hq * hd, dtype=dtype)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, device=gen.device),
                                       requires_grad=False)
            self.k_norm = nn.Parameter(torch.ones(hd, device=gen.device),
                                       requires_grad=False)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = split_heads(x @ p.wq, hq, hd)
    k = split_heads(x @ p.wk, hkv, hd)
    v = split_heads(x @ p.wv, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return (constraint(q, "data", None, "model", None),
            constraint(k, "data", None, "model", None),
            constraint(v, "data", None, "model", None))


def _sdpa(q, k, v, causal: bool) -> torch.Tensor:
    """einsum attention; q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D).

    GQA under tensor parallelism, as the reference: when Hkv doesn't
    divide the model axis but Hq does, K/V are repeated to Hq heads first
    so every attention tensor shards over 'model'. With a mesh, q, k and v
    are then split by batch and heads alike, and each rank attends over
    its own shards (Megatron's attention: no collective inside).
    """
    hq, hkv = q.shape[2], k.shape[2]
    g = hq // hkv
    tp = axis_size("model")
    if g > 1 and hkv % tp and hq % tp == 0:
        k = constraint(torch.repeat_interleave(k, g, dim=2),
                       "data", None, "model", None)
        v = constraint(torch.repeat_interleave(v, g, dim=2),
                       "data", None, "model", None)
    if active_mesh() is None:
        return _attend(q, k, v, causal)
    from torch.distributed.tensor import DTensor
    placements = q.placements
    k, v = (t.redistribute(q.device_mesh, placements) for t in (k, v))
    return DTensor.from_local(
        _attend(q.to_local(), k.to_local(), v.to_local(), causal),
        q.device_mesh, placements, run_check=False)


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """The einsum attention of :func:`_sdpa` on plain tensors."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / (hd ** 0.5)
    if causal:
        ii = torch.arange(s, device=q.device)
        mask = ii[:, None] >= ii[None, :]
        logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def apply_attn(p: Attention, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor | None = None, causal: bool = True,
               impl: str = "xla", return_kv: bool = False):
    """Full-sequence attention (prefill). x: (B, S, d_model).

    ``impl="flash"`` runs the flash-attention kernel on ``(B, H, S, D)``
    transposes of q, k and v; ``"xla"`` the einsum version.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if impl == "flash":
        out = fa.attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(),
                           causal=causal).transpose(1, 2)
    elif impl == "xla":
        out = _sdpa(q, k, v, causal)
    else:
        raise ValueError(f"attention impl {impl!r} is not 'xla' or 'flash'")
    out = constraint(out, "data", None, "model", None)
    y = constraint(out.reshape(b, s, -1) @ p.wo, "data", None, None)
    return (y, (k, v)) if return_kv else y


def _project_one(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor):
    """q (B, 1, Hq, D), k / v (B, 1, Hkv, D) of one token at ``pos`` (B,)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = split_heads(x @ p.wq, hq, hd)
    k_new = split_heads(x @ p.wk, hkv, hd)
    v_new = split_heads(x @ p.wv, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k_new = rms_norm(k_new, p.k_norm, cfg.norm_eps)
    return (apply_rope(q, pos[:, None], cfg.rope_theta),
            apply_rope(k_new, pos[:, None], cfg.rope_theta), v_new)


def apply_attn_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                      kv_cache: tuple[torch.Tensor, torch.Tensor],
                      cache_len: torch.Tensor):
    """One-token decode against a dense cache this layer owns.

    x: (B, 1, d_model); cache k / v: (B, S_max, Hkv, D); ``cache_len`` (B,)
    is where the new token goes. Returns ``(y, (k, v))`` with the new
    token's K/V written at ``cache_len`` in place: the caller's cache is
    updated, where the reference returns an updated copy. A sequence whose
    ``cache_len`` has reached ``S_max`` writes nothing, as in the reference.
    With a mesh active the cache is not written: the reference's masked
    update makes new K/V, sharded on S_max as the cache is (over 'model',
    both axes at B == 1), so no shard leaves its rank.
    """
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pos = cache_len                                    # (B,) current lengths
    q, k_new, v_new = _project_one(p, cfg, x, pos)
    ck, cv = kv_cache
    span = torch.arange(ck.shape[1], device=x.device)[None, :]
    bax = None if b == 1 else "data"
    seq_ax = ("data", "model") if b == 1 else "model"
    if active_mesh() is None:
        rows = torch.arange(b, device=x.device)
        at = pos.clamp(max=ck.shape[1] - 1)
        fits = (pos < ck.shape[1])[:, None, None]
        ck[rows, at] = torch.where(fits, k_new[:, 0].to(ck.dtype),
                                   ck[rows, at])
        cv[rows, at] = torch.where(fits, v_new[:, 0].to(cv.dtype),
                                   cv[rows, at])
    else:
        at_pos = constraint(span == pos[:, None], bax, seq_ax)
        at_pos = at_pos[:, :, None, None]
        ck = constraint(torch.where(at_pos, k_new.to(ck.dtype), ck),
                        bax, seq_ax, None, None)
        cv = constraint(torch.where(at_pos, v_new.to(cv.dtype), cv),
                        bax, seq_ax, None, None)

    # the cache is split along S_max, so every rank needs all of q's heads
    q = constraint(q, bax, None, None, None)
    qg = q.reshape(b, hkv, hq // hkv, hd)
    valid = constraint(span <= pos[:, None], bax, seq_ax)      # (B, S_max)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          ck.float()) / (hd ** 0.5)
    logits = torch.where(valid[:, None, None, :], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, cv.float())
    y = out.reshape(b, 1, hq * hd).to(x.dtype) @ p.wo
    return y, (ck, cv)


def apply_attn_decode_paged(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                            kv: tuple[torch.Tensor, torch.Tensor],
                            cache_len: torch.Tensor):
    """One-token decode against a paged-KV view (the CREAM-Serve read path).

    ``kv`` is (k, v), each ``(B, S_pad, Hkv, D)`` — a dense view the serving
    tier gathered from pool pages. The new token's (k, v) are inserted at
    ``cache_len`` for this computation only and returned as ``(B, Hkv, D)``
    pairs for the block-table owner to scatter back. Positions past
    ``cache_len`` may hold arbitrary pool bits and are masked out.
    """
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    pos = cache_len                                    # (B,) current lengths
    q, k_new, v_new = _project_one(p, cfg, x, pos)

    ck, cv = kv
    smax = ck.shape[1]
    span = torch.arange(smax, device=x.device)[None, :]
    at_pos = (span == pos[:, None])[:, :, None, None]          # (B, S_pad)
    ck = torch.where(at_pos, k_new.to(ck.dtype), ck)
    cv = torch.where(at_pos, v_new.to(cv.dtype), cv)

    qg = q.reshape(b, hkv, hq // hkv, hd)
    valid = span <= pos[:, None]                               # (B, S_pad)
    # pool garbage can bit-cast to NaN/Inf; a NaN value would survive the
    # softmax mask as 0 * NaN, so zero the masked positions outright
    cv = torch.where(valid[:, :, None, None], cv, 0)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          ck.float()) / (hd ** 0.5)
    logits = torch.where(valid[:, None, None, :], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, cv.float())
    y = out.reshape(b, 1, hq * hd).to(x.dtype) @ p.wo
    return y, (k_new.reshape(b, hkv, hd), v_new.reshape(b, hkv, hd))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_attn: int,
                  dtype, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked ``(n_attn_layers, B, S_max, Hkv, D)`` zeroed cache pair."""
    shape = (n_attn, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
