"""Decoder LM: a period of (block, mixer) pairs tiled over stages.

Port of ``repro/models/transformer.py``. A config's ``pattern`` is one
period of (block, mixer) pairs — attention, Mamba, mLSTM or sLSTM blocks
with MLP, MoE or no mixers (jamba's attention + Mamba×7 with interleaved
MoE, xLSTM's mLSTM×7 + sLSTM) — tiled ``num_stages`` times. The
reference stacks each pattern position's parameters over stages and
scans; here the layers are one ``ModuleList`` in the same stage-major
order (stage 0's pattern positions first), which is also the order of the
paged-KV layer axis.

:meth:`Transformer.forward` and :meth:`Transformer.loss` give logits and
the MoE balance loss; the dense decode path
(:meth:`Transformer.init_decode_state`, :meth:`Transformer.prefill_state`,
:meth:`Transformer.decode_step`) keeps the reference's state tree:
``{"cache_len": (B,), "pos{i}": ...}`` with every leaf stacked over stages
on axis 0 — ``{"k", "v"}`` of ``(num_stages, B, max_len, Hkv, D)`` for
attention, ``{"conv", "h"}`` for Mamba, ``{"c", "n", "m", "conv"}`` for
mLSTM and ``{"c", "n", "h", "m"}`` for sLSTM. The paged path CREAM-Serve
drives (:meth:`Transformer.prefill`, :meth:`Transformer.decode_step_paged`)
keeps only KV in pool pages, so it takes attention-only patterns (MLP or
MoE mixers) and refuses the others, as the reference does.

``attn_impl`` picks the full-sequence attention of every prefill and
forward: ``"xla"`` (einsum) or ``"flash"`` (the flash-attention kernel).
The module's methods serve and take no gradient (they run under
``torch.no_grad``). Training takes its gradient through :func:`loss_fn`,
the reference's ``loss_fn`` over its ``forward``: a function of the
reference's parameter tree (``embed/table``, ``final_norm``, ``stages/
pos{i}/{norm1,block,norm2,mixer}/...`` stacked over stages;
:func:`repro_torch.models.model.params_tree` makes it from a model), with
``remat`` recomputing each stage's activations in the backward pass
(``torch.utils.checkpoint``; the reference's ``jax.checkpoint`` of each
stage). The reference trains with einsum attention: the flash kernel has
no backward there or here, and its wrapper raises under autograd.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.common import (MLP, Embedding, RMSNorm, apply_mlp,
                                      cross_entropy, dense_init, rms_norm)

ATTN_IMPLS = ("xla", "flash")
REMATS = ("none", "block", "full")
AUX_WEIGHT = 0.01          # the reference loss_fn's MoE balance weight

_BLOCKS = {BlockKind.ATTN: attention.Attention, BlockKind.MAMBA: ssm.SSM,
           BlockKind.MLSTM: xlstm.MLSTM, BlockKind.SLSTM: xlstm.SLSTM}
_DECODES = {BlockKind.MAMBA: ssm.apply_ssm_decode,
            BlockKind.MLSTM: xlstm.apply_mlstm_decode,
            BlockKind.SLSTM: xlstm.apply_slstm_decode}


def attn_pattern_positions(cfg: ModelConfig) -> list[int]:
    """Pattern indices whose block is attention (= has a KV cache)."""
    return [i for i, (bk, _) in enumerate(cfg.pattern)
            if bk == BlockKind.ATTN]


def num_attn_layers(cfg: ModelConfig) -> int:
    """Total attention layers = stages x attention positions per period
    (stage-major) — the leading axis of the paged-KV tensors."""
    return cfg.num_stages * len(attn_pattern_positions(cfg))


def _require_attention_only(cfg: ModelConfig) -> None:
    """Raise, with the reference's message, for a pattern the paged path
    cannot hold: its recurrent blocks' state would not live in pages."""
    apos = attn_pattern_positions(cfg)
    if len(apos) != len(cfg.pattern):
        raise ValueError(
            f"{cfg.name}: paged decode supports attention-only patterns; "
            f"pattern has non-attention blocks at "
            f"{[i for i in range(len(cfg.pattern)) if i not in apos]}")


def _add(total, aux):
    """The running MoE aux loss plus ``aux`` (None: no MoE mixer yet)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _block_full(kind: BlockKind, p, cfg: ModelConfig, h: torch.Tensor,
                attn_impl: str, with_state: bool):
    """A block over a full sequence ``h`` (B, S, d) -> (y, its decode state
    at S if ``with_state``): ``(k, v)`` (B, S, Hkv, D) for attention, the
    recurrent state's dict for the others."""
    if kind == BlockKind.ATTN:
        if with_state:
            return attention.apply_attn(p, cfg, h, impl=attn_impl,
                                        return_kv=True)
        return attention.apply_attn(p, cfg, h, impl=attn_impl), None
    if kind == BlockKind.MAMBA:
        y, st = ssm.apply_ssm_prefill(p, cfg, h)
    elif kind == BlockKind.MLSTM:
        if not with_state:
            return xlstm.apply_mlstm(p, cfg, h), None
        y, st = xlstm.apply_mlstm_prefill(p, cfg, h)
    else:
        y, st = xlstm.apply_slstm(p, cfg, h)
    return y, st if with_state else None


def _mix(kind: MixerKind, norm2, p, cfg: ModelConfig, x: torch.Tensor):
    """``x`` plus its channel mixer's output, and the MoE aux loss (None
    for other mixers)."""
    if kind == MixerKind.NONE:
        return x, None
    h = rms_norm(x, norm2, cfg.norm_eps)
    if kind == MixerKind.MLP:
        return x + apply_mlp(p, h), None
    y, aux = moe.apply_moe(p, cfg, h)
    return x + y, aux


class Block(nn.Module):
    """One (block, mixer) pattern position of one stage: ``block`` holds
    the block's weights under the reference's names, ``mixer`` the MLP or
    MoE weights (None with no mixer)."""

    def __init__(self, cfg: ModelConfig, kind: BlockKind, mixer: MixerKind,
                 gen: torch.Generator, dtype):
        super().__init__()
        dev = gen.device
        self.kind, self.mixer_kind = kind, mixer
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.block = _BLOCKS[kind](cfg, gen, dtype)
        self.norm2 = self.mixer = None
        if mixer != MixerKind.NONE:
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            self.mixer = moe.MoE(cfg, gen, dtype) if mixer == MixerKind.MOE \
                else MLP(cfg.d_model, cfg.d_ff, gen, dtype,
                         variant=cfg.mlp_variant)

    def mix(self, cfg: ModelConfig, x: torch.Tensor):
        return _mix(self.mixer_kind,
                    None if self.norm2 is None else self.norm2.weight,
                    self.mixer, cfg, x)


class Transformer(nn.Module):
    """The decoder, with weights drawn from ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        self.attn_impl = attn_impl
        self.cfg = cfg
        dtype = cfg.activation_dtype
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen, dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, gen.device)
        self.lm_head = None if cfg.tie_embeddings else dense_init(
            (cfg.d_model, cfg.vocab_size), gen, dtype=dtype)
        self.layers = nn.ModuleList(
            Block(cfg, bk, mk, gen, dtype)
            for _ in range(cfg.num_stages) for bk, mk in cfg.pattern)

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

    def _run(self, tokens: torch.Tensor, keep=None):
        """The layers over a full sequence -> (final hidden state, MoE aux
        loss or None). ``keep(layer, state)``, if given, takes each layer's
        decode state at S (``(k, v)`` of (B, S, Hkv, D) for attention)."""
        cfg = self.cfg
        x = self.embed(tokens)
        aux = None
        for layer, blk in enumerate(self.layers):
            y, st = _block_full(blk.kind, blk.block, cfg, blk.norm1(x),
                                self.attn_impl, keep is not None)
            if keep is not None:
                keep(layer, st)
            x, a = blk.mix(cfg, x + y)
            aux = _add(aux, a)
        return x, aux

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, logits_mode: str = "all"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (logits, aux loss).

        ``logits_mode="all"`` gives (B, S, V); ``"last"`` gives (B, V) for
        the final position only. The aux loss is the MoE balance term
        summed over MoE layers (0 without any).
        """
        x, aux = self._run(tokens)
        if aux is None:
            aux = torch.zeros((), device=x.device)
        return self._head(x, logits_mode), aux

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
        (n_attn, B, S, Hkv, D)) — every layer's KV for the prompt, the
        paged path's prefill (attention-only patterns)."""
        _require_attention_only(self.cfg)
        ks, vs = [], []

        def keep(_, kv):
            ks.append(kv[0])
            vs.append(kv[1])
        x, _ = self._run(tokens, keep)
        return self._logits(x), (torch.stack(ks), torch.stack(vs))

    # -- the dense decode path -----------------------------------------------

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        """Zeroed decode state: ``cache_len`` (B,) int32 and, per pattern
        position ``i``, ``pos{i}``: K/V of (num_stages, B, max_len, Hkv, D)
        for attention, the recurrent block's initial state stacked over
        stages for the others."""
        cfg = self.cfg
        dev = self.embed.table.device
        ns, dtype = cfg.num_stages, cfg.activation_dtype
        state = {"cache_len": torch.zeros((batch,), dtype=torch.int32,
                                          device=dev)}
        for i, (bk, _) in enumerate(cfg.pattern):
            if bk == BlockKind.ATTN:
                shape = (ns, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
                one = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
            else:
                if bk == BlockKind.MAMBA:
                    one = ssm.init_ssm_state(cfg, batch, dtype, dev)
                elif bk == BlockKind.MLSTM:
                    one = xlstm.init_mlstm_state(cfg, batch, dev)
                else:
                    one = xlstm.init_slstm_state(cfg, batch, dev)
                one = {n: t.expand(ns, *t.shape).clone()
                       for n, t in one.items()}
            state[f"pos{i}"] = one
        return state

    @torch.no_grad()
    def prefill_state(self, tokens: torch.Tensor, max_len: int,
                      logits_mode: str = "all"
                      ) -> tuple[torch.Tensor, dict]:
        """tokens (B, S) -> (logits, the decode state at position S): K/V
        padded with zeros to ``max_len``, each recurrent block's state at
        S, ``cache_len`` = S. Logits as :meth:`forward` gives them for
        ``logits_mode``. An mLSTM block needs S >= 3."""
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
        state = self.init_decode_state(b, max_len)

        def keep(layer, st):
            stage, i = divmod(layer, self.cfg.period)
            pos = state[f"pos{i}"]
            if self.layers[layer].kind == BlockKind.ATTN:
                pos["k"][stage, :, :s] = st[0]
                pos["v"][stage, :, :s] = st[1]
            else:
                for name, t in st.items():
                    pos[name][stage] = t
        x, _ = self._run(tokens, keep)
        state["cache_len"].fill_(s)
        return self._head(x, logits_mode), state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One token per sequence against the dense state: tokens (B,)
        -> (logits (B, V), new state). The state's K/V and recurrent
        states are written in place and shared with the new state, whose
        ``cache_len`` is one more."""
        cfg = self.cfg
        x = self.embed(tokens[:, None])
        cache_len = state["cache_len"]
        for layer, blk in enumerate(self.layers):
            stage, i = divmod(layer, cfg.period)
            pos = state[f"pos{i}"]
            h = blk.norm1(x)
            if blk.kind == BlockKind.ATTN:
                y, _ = attention.apply_attn_decode(
                    blk.block, cfg, h, (pos["k"][stage], pos["v"][stage]),
                    cache_len)
            else:
                y, new = _DECODES[blk.kind](
                    blk.block, cfg, h, {n: t[stage] for n, t in pos.items()})
                for name, t in new.items():
                    pos[name][stage] = t
            x, _ = blk.mix(cfg, x + y)
        new_state = dict(state, cache_len=cache_len + 1)
        return self._logits(x)[:, 0], new_state

    @torch.no_grad()
    def decode_step_paged(self, state: dict, tokens: torch.Tensor,
                          kv: tuple[torch.Tensor, torch.Tensor]):
        """One decode step against externally gathered paged KV
        (attention-only patterns).

        ``kv`` = (k, v), each ``(n_attn, B, S_pad, Hkv, D)``; ``state``
        carries only ``cache_len`` (B,). Returns ``(logits (B, V),
        {"cache_len": cache_len + 1}, (k_new, v_new))`` with k_new/v_new
        ``(n_attn, B, Hkv, D)``, the token of KV this step produced.
        """
        cfg = self.cfg
        _require_attention_only(cfg)
        x = self.embed(tokens[:, None])
        cache_len = state["cache_len"]
        k_all, v_all = kv
        news_k, news_v = [], []
        for layer, blk in enumerate(self.layers):
            y, (kn, vn) = attention.apply_attn_decode_paged(
                blk.block, cfg, blk.norm1(x), (k_all[layer], v_all[layer]),
                cache_len)
            news_k.append(kn)
            news_v.append(vn)
            x, _ = blk.mix(cfg, x + y)
        return (self._logits(x)[:, 0], {"cache_len": cache_len + 1},
                (torch.stack(news_k), torch.stack(news_v)))


# ---------------------------------------------------------------------------
# The training path: a grad-enabled loss over the reference's parameter tree
# ---------------------------------------------------------------------------


def _stage(cfg: ModelConfig, attn_impl: str, x: torch.Tensor, stage: dict):
    """One stage (one period of the pattern) over ``x``: ``stage`` is the
    stage's slice of ``params["stages"]``. Returns (x, the stage's MoE aux
    loss or None)."""
    aux = None
    for i, (bk, mk) in enumerate(cfg.pattern):
        entry = stage[f"pos{i}"]
        h = rms_norm(x, entry["norm1"], cfg.norm_eps)
        y, _ = _block_full(bk, SimpleNamespace(**entry["block"]), cfg, h,
                           attn_impl, False)
        mixer = entry.get("mixer")
        x, a = _mix(mk, entry.get("norm2"),
                    None if mixer is None else SimpleNamespace(**mixer),
                    cfg, x + y)
        aux = _add(aux, a)
    return x, aux


def _unstack(tree: dict, n: int) -> list[dict]:
    """A tree of stacked leaves -> ``n`` trees of their slices (one
    ``unbind`` a leaf, whose backward is one stack)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(n)]
    return list(tree.unbind(0))


def forward_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               attn_impl: str = "xla", remat: str = "none"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux loss), grad-enabled: the
    reference's ``forward`` over its parameter tree. ``remat`` ``"block"``
    or ``"full"`` recomputes each stage in the backward pass."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} not in {REMATS}")
    x = params["embed"]["table"][tokens]
    aux = None
    for stage in _unstack(params["stages"], cfg.num_stages):
        if remat == "none":
            x, a = _stage(cfg, attn_impl, x, stage)
        else:
            x, a = torch.utils.checkpoint.checkpoint(
                lambda h, st=stage: _stage(cfg, attn_impl, h, st), x,
                use_reentrant=False)
        aux = _add(aux, a)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = x @ params["lm_head"]["w"]
    return logits, torch.zeros((), device=x.device) if aux is None else aux


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, aux_weight: float = AUX_WEIGHT,
            attn_impl: str = "xla", remat: str = "none") -> torch.Tensor:
    """Mean token NLL of ``labels`` plus the weighted aux loss, with a
    gradient to every leaf of ``params`` that requires one."""
    logits, aux = forward_fn(params, cfg, tokens, attn_impl, remat)
    return cross_entropy(logits, labels) + aux_weight * aux
