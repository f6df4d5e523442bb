"""Mamba (selective SSM) block: chunked scan for a full sequence, O(1)
recurrent update for decode.

Port of ``repro/models/ssm.py``. A full sequence is cut into chunks of
:data:`CHUNK` steps; inside a chunk the discretised recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t`` runs as a log-depth
(Hillis–Steele) scan over time, and the state is carried from chunk to
chunk, so the (B, L, d_inner, d_state) tensors exist one chunk at a time.
Decode carries ``{"conv": the trailing K-1 conv inputs, "h": the SSM
state}``. No kernel computes the scan: the reference has no Pallas one
either (ROADMAP).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constraint
from repro_torch.models.common import dense_init

CHUNK = 256


def _fixed(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class SSM(nn.Module):
    """A Mamba block's weights in the reference's layout: S4D-real
    ``a_log`` = log(1..n), ``dt_bias`` the inverse softplus of a
    log-uniform step in [1e-3, 1e-1], ``d_skip`` = 1 (float32 each)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, \
            cfg.dt_rank_
        dev = gen.device
        dt = torch.exp(torch.rand((di,), generator=gen, device=dev)
                       * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        self.dt_bias = _fixed(dt + torch.log(-torch.expm1(-dt)))
        self.a_log = _fixed(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=dev)).expand(di, n)
            .contiguous())
        self.d_skip = _fixed(torch.ones((di,), device=dev))
        self.in_proj = dense_init((d, 2 * di), gen, dtype=dtype)
        self.conv_w = _fixed((torch.randn((cfg.ssm_conv_dim, di),
                                          generator=gen, device=dev) * 0.1)
                             .to(dtype))
        self.x_bc = dense_init((di, 2 * n), gen, dtype=dtype)
        self.x_dt = dense_init((di, r), gen, dtype=dtype)
        self.dt_proj = dense_init((r, di), gen, fan_in=r, dtype=dtype)
        self.out_proj = dense_init((di, d), gen, fan_in=di, dtype=dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. x (B, L, di); w (K, di).

    Returns ``(y, new_carry)``, the carry being the trailing K-1 inputs.
    """
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)                   # (B, L+K-1, di)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):, :]


def _ssm_params(p, cfg: ModelConfig, xc: torch.Tensor):
    """Input-dependent (dt, B, C) of ``xc`` (B, L, di), float32."""
    bc = xc @ p.x_bc                                    # (B, L, 2n)
    b_in, c_out = bc.float().chunk(2, dim=-1)
    dt = (xc @ p.x_dt) @ p.dt_proj                      # (B, L, di)
    dt = F.softplus(dt.float() + p.dt_bias)
    return dt, b_in, c_out


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over axis 1 from
    h = 0, in ceil(log2 L) doubling steps (Hillis–Steele)."""
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return b


def _scan_chunk(p, cfg: ModelConfig, xc: torch.Tensor, h0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact selective scan over one chunk. xc (B, L, di); h0 (B, di, n)."""
    a = -torch.exp(p.a_log)                             # (di, n)
    dt, b_in, c_out = _ssm_params(p, cfg, xc)
    xf = xc.float()
    abar = torch.exp(dt[..., None] * a)                 # (B, L, di, n)
    bx = (dt * xf)[..., None] * b_in[:, :, None, :]     # (B, L, di, n)
    # fold the incoming state into the first step
    bx = torch.cat([bx[:, :1] + (abar[:, 0] * h0)[:, None], bx[:, 1:]],
                   dim=1)
    hs = _scan(abar, bx)
    y = torch.einsum("bldn,bln->bld", hs, c_out) + xf * p.d_skip
    return y.to(xc.dtype), hs[:, -1]


def apply_ssm(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba block. x: (B, S, d_model)."""
    return apply_ssm_prefill(p, cfg, x)[0]


def apply_ssm_prefill(p, cfg: ModelConfig, x: torch.Tensor
                      ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-sequence forward and the decode state at S. ``p`` is an
    :class:`SSM`, or a namespace of a parameter tree's tensors. S must be
    a multiple of the chunk, ``min(CHUNK, S)``."""
    b, s, _ = x.shape
    xs_raw, z = (x @ p.in_proj).chunk(2, dim=-1)
    xs_raw = constraint(xs_raw, "data", None, "model")
    xs, conv_carry = _causal_conv(xs_raw, p.conv_w)
    xs = F.silu(xs)

    chunk = min(CHUNK, s)
    assert s % chunk == 0
    h = torch.zeros((b, cfg.d_inner, cfg.ssm_state_dim), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        y, h = _scan_chunk(p, cfg, xs[:, c0:c0 + chunk], h)
        ys.append(y)
    y = torch.cat(ys, dim=1) * F.silu(z)
    return y @ p.out_proj, {"conv": conv_carry, "h": h}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim),
                         dtype=torch.float32, device=device),
    }


def apply_ssm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                     state: dict[str, torch.Tensor]
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d_model) -> (y, new state)."""
    xs, z = (x @ p.in_proj).chunk(2, dim=-1)
    xs, conv_carry = _causal_conv(xs, p.conv_w, state["conv"])
    xs = F.silu(xs)

    a = -torch.exp(p.a_log)
    dt, b_in, c_out = _ssm_params(p, cfg, xs)
    xf = xs.float()[:, 0]                               # (B, di)
    dt0, b0, c0 = dt[:, 0], b_in[:, 0], c_out[:, 0]
    abar = torch.exp(dt0[..., None] * a)                # (B, di, n)
    h = abar * state["h"] + (dt0 * xf)[..., None] * b0[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c0) + xf * p.d_skip
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return y @ p.out_proj, {"conv": conv_carry, "h": h}
