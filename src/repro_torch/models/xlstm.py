"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory with
recurrent mixing).

Port of ``repro/models/xlstm.py``:

  * mLSTM — exponential input gate and sigmoid forget gate over a matrix
    memory ``C_t = f_t C_{t-1} + i_t v_t k_tᵀ``. A full sequence uses the
    parallel form (the stabilised log-gate matrix
    ``D_ij = exp(F_i − F_j + ĩ_j − m_i)``, ``-inf`` above the diagonal);
    decode the O(1) recurrent form carrying ``(C, n, m)`` and the conv's
    trailing inputs.
  * sLSTM — scalar memory with per-head recurrent mixing ``R·h_{t-1}``,
    a sequential loop over time.

q/k/v are block-diagonal per head (H · dh² weights); the mLSTM cell runs
at :data:`PF` × the model width. The gate weights ``wi``, ``wf`` and the
sLSTM's ``r_*`` are float32 whatever the activation dtype: where the
reference multiplies an activation by one of them (JAX promotes bfloat16
@ float32 to float32) the activation is cast to float32 first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constraint
from repro_torch.models.common import dense_init, rms_norm, split_heads
from repro_torch.models.ssm import _causal_conv

PF = 2          # mLSTM up-projection factor
CONV_K = 4      # mLSTM conv width: its decode state keeps CONV_K - 1 inputs
GATES = ("z", "i", "f", "o")


def _cell_dims(cfg: ModelConfig) -> tuple[int, int]:
    dc = PF * cfg.d_model
    return dc, dc // cfg.num_heads


def _headwise(h: int, dh: int, gen: torch.Generator, dtype) -> nn.Parameter:
    return dense_init((h, dh, dh), gen, fan_in=dh, dtype=dtype)


def _apply_headwise(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh) @ w (H, dh, dh) -> (B, S, H, dh)."""
    return torch.einsum("bshd,hde->bshe", x, w)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log σ(x) as ``jax.nn.log_sigmoid`` computes it, -logaddexp(-x, 0)
    (whose gradient DTensor can also partition)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def _ones(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dc, dh = _cell_dims(cfg)
        self.w_up = dense_init((d, 2 * dc), gen, dtype=dtype)
        self.conv_w = nn.Parameter(
            (torch.randn((CONV_K, dc), generator=gen, device=gen.device)
             * 0.1).to(dtype), requires_grad=False)
        self.wq = _headwise(h, dh, gen, dtype)
        self.wk = _headwise(h, dh, gen, dtype)
        self.wv = _headwise(h, dh, gen, dtype)
        self.wi = dense_init((dc, h), gen, dtype=torch.float32)
        self.wf = dense_init((dc, h), gen, dtype=torch.float32)
        self.gn = _ones(dh, gen.device)
        self.w_down = dense_init((dc, d), gen, fan_in=dc, dtype=dtype)


def _mlstm_qkv(p, cfg: ModelConfig, u: torch.Tensor):
    """u (B, S, dc) -> q, k, v (B, S, H, dh) and float32 gate
    pre-activations (B, S, H)."""
    dc = u.shape[-1]
    h = cfg.num_heads
    dh = dc // h
    conv_u, _ = _causal_conv(u, p.conv_w)
    heads = split_heads(F.silu(conv_u), h, dh)
    q = _apply_headwise(p.wq, heads)
    k = _apply_headwise(p.wk, heads) / (dh ** 0.5)
    v = _apply_headwise(p.wv, split_heads(u, h, dh))
    i_pre = u.float() @ p.wi                           # (B, S, H)
    f_pre = u.float() @ p.wf
    return q, k, v, i_pre, f_pre


def _mlstm_parallel(p, cfg: ModelConfig, x: torch.Tensor,
                    with_state: bool):
    """The parallel form over x (B, S, d_model) -> (y, the recurrent state
    at S or None)."""
    b, s, _ = x.shape
    u, z = (x @ p.w_up).chunk(2, dim=-1)               # (B, S, dc) each
    u = constraint(u, "data", None, "model")
    dc = u.shape[-1]
    q, k, v, i_pre, f_pre = _mlstm_qkv(p, cfg, u)

    cum_f = torch.cumsum(_log_sigmoid(f_pre), dim=1)    # (B, S, H)
    # D̃_ij = F_i − F_j + ĩ_j  (j ≤ i)
    dmat = cum_f[:, :, None, :] - cum_f[:, None, :, :] + i_pre[:, None, :, :]
    ii = torch.arange(s, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    dmat = torch.where(causal, dmat, float("-inf"))     # (B, Si, Sj, H)
    m = dmat.amax(dim=2, keepdim=True)                  # (B, S, 1, H)
    qk = torch.einsum("bihd,bjhd->bijh", q.float(), k.float())
    smat = qk * torch.exp(dmat - m)
    norm = smat.sum(dim=2)                              # (B, S, H)
    denom = torch.maximum(norm.abs(), torch.exp(-m[:, :, 0, :]))
    hout = torch.einsum("bijh,bjhd->bihd", smat.contiguous(),
                        v.float().contiguous()) / denom[..., None]
    hout = rms_norm(hout, p.gn, cfg.norm_eps).to(x.dtype)
    out = constraint(hout.reshape(b, s, dc) * F.silu(z), "data", None,
                     "model")
    y = out @ p.w_down
    if not with_state:
        return y, None

    # the recurrent state after S tokens, from the cumulative gates:
    # m_S = max_j (F_S − F_j + ĩ_j), C̃_S = Σ_j exp(· − m_S) v_j k_jᵀ
    w_last = cum_f[:, -1:, :] - cum_f + i_pre           # (B, S, H)
    m_s = w_last.amax(dim=1)                            # (B, H)
    wexp = torch.exp(w_last - m_s[:, None, :])
    kf, vf = k.float(), v.float()
    return y, {"c": torch.einsum("bjh,bjhd,bjhe->bhde", wexp, vf, kf),
               "n": torch.einsum("bjh,bjhd->bhd", wexp, kf),
               "m": m_s,
               "conv": u.float()[:, -(CONV_K - 1):, :]}


def apply_mlstm(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Parallel-form mLSTM block. x: (B, S, d_model). ``p`` is an
    :class:`MLSTM`, or a namespace of a parameter tree's tensors."""
    return _mlstm_parallel(p, cfg, x, with_state=False)[0]


def apply_mlstm_prefill(p, cfg: ModelConfig, x: torch.Tensor
                        ) -> tuple[torch.Tensor, dict]:
    """Parallel forward and the recurrent-equivalent state at position S.

    The prompt must hold at least CONV_K - 1 = 3 tokens: the state's conv
    carry is the last three inputs (the reference's ``u[:, -3:]``).
    """
    if x.shape[1] < CONV_K - 1:
        raise ValueError(f"mLSTM prefill needs at least {CONV_K - 1} "
                         f"tokens, got {x.shape[1]}")
    return _mlstm_parallel(p, cfg, x, with_state=True)


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device=None) -> dict[str, torch.Tensor]:
    h = cfg.num_heads
    dc, dh = _cell_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), -1e30, **f32),
            "conv": torch.zeros((batch, CONV_K - 1, dc), **f32)}


def apply_mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    """Recurrent mLSTM step. x: (B, 1, d_model) -> (y, new state)."""
    b = x.shape[0]
    hh = cfg.num_heads
    u, z = (x @ p.w_up).chunk(2, dim=-1)
    dc = u.shape[-1]
    dh = dc // hh

    conv_u, conv_carry = _causal_conv(u, p.conv_w,
                                      state["conv"].to(u.dtype))
    heads = split_heads(F.silu(conv_u), hh, dh)
    q = _apply_headwise(p.wq, heads)[:, 0].float()
    k = (_apply_headwise(p.wk, heads)[:, 0] / (dh ** 0.5)).float()
    v = _apply_headwise(p.wv, split_heads(u, hh, dh))[:, 0].float()
    i_pre = (u.float() @ p.wi)[:, 0]                    # (B, H)
    f_pre = (u.float() @ p.wf)[:, 0]

    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None]           # (B, H, 1)
    f_g = torch.exp(log_f + state["m"] - m_new)[..., None]
    c = f_g[..., None] * state["c"] \
        + i_g[..., None] * (v[..., :, None] * k[..., None, :])
    n = f_g * state["n"] + i_g * k
    num = torch.einsum("bhde,bhe->bhd", c, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))[..., None]
    hout = rms_norm(num / den, p.gn, cfg.norm_eps)[:, None].to(x.dtype)
    y = (hout.reshape(b, 1, dc) * F.silu(z)) @ p.w_down
    return y, {"c": c, "n": n, "m": m_new, "conv": conv_carry.float()}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dh = d // h
        for g in GATES:
            setattr(self, f"w_{g}gate", dense_init((d, d), gen, dtype=dtype))
        for g in GATES:
            setattr(self, f"r_{g}", _headwise(h, dh, gen, torch.float32))
        self.gn = _ones(dh, gen.device)
        self.w_out = dense_init((d, d), gen, dtype=dtype)


def _slstm_step(p, carry, wx: dict):
    """One time step; ``wx`` holds the gate pre-activations (B, H, dh) of
    W x_t."""
    c, n, h, m = carry

    def mix(g):
        return wx[g] + torch.einsum("bhd,hde->bhe", h, getattr(p, f"r_{g}"))

    z = torch.tanh(mix("z"))
    o = torch.sigmoid(mix("o"))
    i_pre = mix("i")
    log_f = _log_sigmoid(mix("f"))
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = torch.clamp(f_g * n + i_g, min=1e-6)
    return c_new, n_new, o * c_new / n_new, m_new


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device=None) -> dict[str, torch.Tensor]:
    hh = cfg.num_heads
    shape = (batch, hh, cfg.d_model // hh)
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zeros, "n": zeros.clone(), "h": zeros.clone(),
            "m": torch.full(shape, -1e30, dtype=torch.float32,
                            device=device)}


def apply_slstm(p, cfg: ModelConfig, x: torch.Tensor,
                state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Sequential sLSTM block over x (B, S, d_model) from ``state`` (zeros
    and m = -1e30 when None) -> (y, the state at S). ``p`` is an
    :class:`SLSTM`, or a namespace of a parameter tree's tensors."""
    b, s, d = x.shape
    hh = cfg.num_heads
    dh = d // hh
    wx = {g: split_heads((x @ getattr(p, f"w_{g}gate")).float(), hh, dh)
          for g in GATES}
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    carry = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in range(s):
        carry = _slstm_step(p, carry, {g: w[:, t] for g, w in wx.items()})
        hs.append(carry[2])
    hs = rms_norm(torch.stack(hs, dim=1), p.gn, cfg.norm_eps).to(x.dtype)
    y = hs.reshape(b, s, d) @ p.w_out
    return y, dict(zip(("c", "n", "h", "m"), carry))


def apply_slstm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    return apply_slstm(p, cfg, x, state)
