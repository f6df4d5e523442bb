"""Decoder LM: attention blocks with MLP mixers.

Port of ``repro/models/transformer.py`` for inference: the parameter
layout of ``init_params``, :meth:`Transformer.forward` and
:meth:`Transformer.loss`, the dense decode path
(:meth:`Transformer.init_decode_state`, :meth:`Transformer.prefill_state`,
:meth:`Transformer.decode_step`) and the paged one CREAM-Serve drives
(:meth:`Transformer.prefill`, :meth:`Transformer.decode_step_paged`). The
reference stacks each pattern position's parameters over stages and scans;
here the layers are one ``ModuleList`` in the same stage-major order
(stage 0's pattern positions first), which is also the order of the
paged-KV layer axis. The dense decode state keeps the reference's tree:
``{"cache_len": (B,), "pos{i}": {"k", "v"}}`` with K/V stacked over stages,
``(num_stages, B, max_len, Hkv, D)``.

``attn_impl`` picks the full-sequence attention of every prefill and
forward: ``"xla"`` (einsum) or ``"flash"`` (the flash-attention kernel).
Nothing here takes a gradient: the reference has no backward for its flash
kernel, and the port adds none.

Only attention blocks with MLP (or no) mixers are ported — the pattern
CREAM-Serve pages; MoE, Mamba and xLSTM blocks are queued in ROADMAP.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention
from repro_torch.models.common import (MLP, Embedding, RMSNorm,
                                      cross_entropy, dense_init)

ATTN_IMPLS = ("xla", "flash")
AUX_WEIGHT = 0.01          # the reference loss_fn's MoE balance weight


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

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.attn_impl = attn_impl
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

    def _head(self, x: torch.Tensor, logits_mode: str) -> torch.Tensor:
        """Logits of every position (``"all"``) or of the last (``"last"``:
        no sequence-long vocab tensor)."""
        if logits_mode not in ("all", "last"):
            raise ValueError(f"logits_mode {logits_mode!r}")
        return self._logits(x if logits_mode == "all" else x[:, -1, :])

    def _run(self, tokens: torch.Tensor, keep_kv):
        """The layers over a full sequence; ``keep_kv(layer, k, v)`` takes
        each layer's (B, S, Hkv, D) K/V. Returns the final hidden state."""
        x = self.embed(tokens)
        for layer, blk in enumerate(self.layers):
            y, (k, v) = attention.apply_attn(blk.attn, self.cfg,
                                             blk.norm1(x),
                                             impl=self.attn_impl,
                                             return_kv=True)
            keep_kv(layer, k, v)
            x = blk.mix(x + y)
        return x

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, logits_mode: str = "all"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits, aux loss).

        ``logits_mode="all"`` gives (B, S, V); ``"last"`` gives (B, V) for
        the final position only. The aux loss is the MoE balance term, 0
        here (no MoE block is ported).
        """
        x = self._run(tokens, lambda *_: None)
        return self._head(x, logits_mode), torch.zeros((), device=x.device)

    @torch.no_grad()
    def loss(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean token NLL of ``labels`` (B, S) plus the weighted aux loss."""
        logits, aux = self.forward(tokens)
        return cross_entropy(logits, labels) + AUX_WEIGHT * aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """tokens (B, S) -> (logits (B, S, V), (k, v) each
        (n_attn, B, S, Hkv, D)) — every layer's KV for the prompt."""
        ks, vs = [], []

        def keep(_, k, v):
            ks.append(k)
            vs.append(v)
        x = self._run(tokens, keep)
        return self._logits(x), (torch.stack(ks), torch.stack(vs))

    # -- the dense decode path -----------------------------------------------

    def _stage_pos(self, layer: int) -> tuple[int, int]:
        return divmod(layer, self.cfg.period)

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        """Zeroed decode state: ``cache_len`` (B,) int32 and, per attention
        position ``i``, ``pos{i}`` K/V of (num_stages, B, max_len, Hkv, D)."""
        cfg = self.cfg
        dev = self.embed.table.device
        shape = (cfg.num_stages, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        state = {"cache_len": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)}
        for i in attn_pattern_positions(cfg):
            state[f"pos{i}"] = {
                "k": torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=dev),
                "v": torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=dev)}
        return state

    @torch.no_grad()
    def prefill_state(self, tokens: torch.Tensor, max_len: int,
                      logits_mode: str = "all"
                      ) -> tuple[torch.Tensor, dict]:
        """tokens (B, S) -> (logits, the decode state at position S): K/V
        padded with zeros to ``max_len``, ``cache_len`` = S. Logits as
        :meth:`forward` gives them for ``logits_mode``."""
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
        state = self.init_decode_state(b, max_len)

        def keep(layer, k, v):
            st, i = self._stage_pos(layer)
            state[f"pos{i}"]["k"][st, :, :s] = k
            state[f"pos{i}"]["v"][st, :, :s] = v
        x = self._run(tokens, keep)
        state["cache_len"].fill_(s)
        return self._head(x, logits_mode), state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One token per sequence against the dense state: tokens (B,)
        -> (logits (B, V), new state). The state's K/V are written in place
        and shared with the new state, whose ``cache_len`` is one more."""
        x = self.embed(tokens[:, None])
        cache_len = state["cache_len"]
        for layer, blk in enumerate(self.layers):
            st, i = self._stage_pos(layer)
            kv = (state[f"pos{i}"]["k"][st], state[f"pos{i}"]["v"][st])
            y, _ = attention.apply_attn_decode(blk.attn, self.cfg,
                                               blk.norm1(x), kv, cache_len)
            x = blk.mix(x + y)
        new_state = dict(state, cache_len=cache_len + 1)
        return self._logits(x)[:, 0], new_state

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
