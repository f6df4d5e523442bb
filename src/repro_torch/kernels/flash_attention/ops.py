"""Flash attention: the dispatching wrapper.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel in ``csrc/flash_attention.cu`` or raise. There is no fallback.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ref

#: head dimensions the kernel is built for
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None,
              *, use_kernel: bool | None = None) -> torch.Tensor:
    """q (B, Hq, S, D), k / v (B, Hkv, S, D) -> (B, Hq, S, D) in q's dtype.

    ``Hq % Hkv == 0``; query head h attends with KV head ``h // (Hq/Hkv)``.
    float32 or bfloat16 operands; the softmax and the accumulation run in
    float32. ``scale`` defaults to ``1/sqrt(D)``. Forward only: with grad
    mode on and an operand that requires grad it raises.
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("expected q (B, Hq, S, D) and k, v (B, Hkv, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (s, d) or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         "not form grouped-query attention")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: operands must share one of "
                        f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the kernel has no backward (nor has the reference's): its output
        # would carry no grad_fn and silently cut q, k, v out of a gradient
        raise RuntimeError("flash_attention has no backward; train with "
                           "attn_impl='xla' (einsum attention)")
    common.check_contiguous("flash_attention", q, k, v)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.attention(q, k, v, causal=causal, scale=scale)
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (q, k, v)):
        raise ValueError("flash_attention: operands must share one CUDA "
                         "device")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel():
        scale = scale if scale is not None else 1.0 / math.sqrt(d)
        common.launch("flash_attention", q, k, v, out, b, hq, hkv, s, d,
                      int(q.dtype == torch.bfloat16), scale * math.log2(math.e),
                      int(causal))
    return out
