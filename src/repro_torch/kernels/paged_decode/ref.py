"""Plain PyTorch version of the paged decode attention: the einsum chain
of the reference's ``apply_attn_decode_paged`` after the projections."""
from __future__ import annotations

import torch


def attend(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
           cache_len: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """q (B, Hq, D); k_new, v_new (B, Hkv, D); cache_len (B,); k, v
    (B, n_blk, bt, Hkv, D) -> (B, Hq, D) float32.

    The new token's (k, v) are inserted at ``cache_len`` for this
    computation only (nowhere once ``cache_len`` has reached
    ``n_blk * bt``); positions past ``cache_len`` may hold arbitrary pool
    bits and are masked out.
    """
    b, hq, hd = q.shape
    hkv = k_new.shape[1]
    pos = cache_len                                    # (B,) current lengths
    k_new, v_new = k_new[:, None], v_new[:, None]
    ck, cv = k.reshape(b, -1, hkv, hd), v.reshape(b, -1, hkv, hd)
    smax = ck.shape[1]
    span = torch.arange(smax, device=q.device)[None, :]
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
    return out.reshape(b, hq, hd)
