"""Decoder LM for paged serving: attention blocks with MLP mixers.

Port of the serving half of ``repro/models/transformer.py``: the parameter
layout of ``init_params``, :meth:`Transformer.prefill` and
:meth:`Transformer.decode_step_paged`. The reference stacks each pattern
position's parameters over stages and scans; here the layers are one
``ModuleList`` in the same stage-major order (stage 0's pattern positions
first), which is also the order of the paged-KV layer axis.

Only attention blocks with MLP (or no) mixers are ported — the pattern
CREAM-Serve pages; MoE, Mamba and xLSTM blocks are queued in ROADMAP.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention
from repro_torch.models.common import MLP, Embedding, RMSNorm, dense_init


def attn_pattern_positions(cfg: ModelConfig) -> list[int]:
    """Pattern indices whose block is attention (= has a KV cache)."""
    return [i for i, (bk, _) in enumerate(cfg.pattern)
            if bk == BlockKind.ATTN]


def num_attn_layers(cfg: ModelConfig) -> int:
    """Total attention layers = stages x attention positions per period
    (stage-major) — the leading axis of the paged-KV tensors."""
    return cfg.num_stages * len(attn_pattern_positions(cfg))


class Block(nn.Module):
    """One (attention, mixer) pattern position of one stage."""

    def __init__(self, cfg: ModelConfig, mixer: MixerKind,
                 gen: torch.Generator, dtype):
        super().__init__()
        dev = gen.device
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.attn = attention.Attention(cfg, gen, dtype)
        self.norm2 = self.mlp = None
        if mixer == MixerKind.MLP:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, dtype,
                           variant=cfg.mlp_variant)

    def mix(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mlp is None else x + self.mlp(self.norm2(x))


class Transformer(nn.Module):
    """The decoder, with weights drawn from ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None):
        super().__init__()
        unsupported = [(bk.value, mk.value) for bk, mk in cfg.pattern
                       if bk != BlockKind.ATTN or mk == MixerKind.MOE]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: blocks {unsupported} are not ported yet "
                "(ROADMAP, queue 1: models/moe.py, ssm.py, xlstm.py)")
        self.cfg = cfg
        dtype = cfg.activation_dtype
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen, dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, gen.device)
        self.lm_head = None if cfg.tie_embeddings else dense_init(
            (cfg.d_model, cfg.vocab_size), gen, dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, mk, gen, dtype)
            for _ in range(cfg.num_stages) for _, mk in cfg.pattern)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.lm_head is None:
            return x @ self.embed.table.T
        return x @ self.lm_head

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """tokens (B, S) -> (logits (B, S, V), (k, v) each
        (n_attn, B, S, Hkv, D)) — every layer's KV for the prompt."""
        x = self.embed(tokens)
        ks, vs = [], []
        for blk in self.layers:
            y, (k, v) = attention.apply_attn(blk.attn, self.cfg,
                                             blk.norm1(x), return_kv=True)
            ks.append(k)
            vs.append(v)
            x = blk.mix(x + y)
        return self._logits(x), (torch.stack(ks), torch.stack(vs))

    @torch.no_grad()
    def decode_step_paged(self, state: dict, tokens: torch.Tensor,
                          kv: tuple[torch.Tensor, torch.Tensor]):
        """One decode step against externally gathered paged KV.

        ``kv`` = (k, v), each ``(n_attn, B, S_pad, Hkv, D)``; ``state``
        carries only ``cache_len`` (B,). Returns ``(logits (B, V),
        {"cache_len": cache_len + 1}, (k_new, v_new))`` with k_new/v_new
        ``(n_attn, B, Hkv, D)``, the token of KV this step produced.
        """
        x = self.embed(tokens[:, None])
        cache_len = state["cache_len"]
        k_all, v_all = kv
        news_k, news_v = [], []
        for layer, blk in enumerate(self.layers):
            y, (kn, vn) = attention.apply_attn_decode_paged(
                blk.attn, self.cfg, blk.norm1(x), (k_all[layer], v_all[layer]),
                cache_len)
            news_k.append(kn)
            news_v.append(vn)
            x = blk.mix(x + y)
        return (self._logits(x)[:, 0], {"cache_len": cache_len + 1},
                (torch.stack(news_k), torch.stack(news_v)))
