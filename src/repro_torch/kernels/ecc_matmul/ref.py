"""Plain PyTorch version of the SECDED decode-on-load matrix product.

Port of ``repro/kernels/ecc_matmul/ref.py``: decode and correct A's words
with the plain SECDED codec, reinterpret them as bf16, then one float32
product with B.
"""
from __future__ import annotations

import torch

from repro_torch.core import secded


def protect(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 (M, K) weights -> (bits (M, K//2) int32, codes (M, K//16)):
    element ``2j`` of a row in the low half of word ``j``."""
    bits = a.contiguous().view(torch.int32)
    return bits, secded.encode_block(bits)


def unprotect(bits: torch.Tensor) -> torch.Tensor:
    """(M, K//2) int32 words -> bf16 (M, K)."""
    return bits.contiguous().view(torch.bfloat16)


def ecc_matmul(a_bits: torch.Tensor, a_codes: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Decode-and-correct A, then A @ B in float32 -> (M, N) float32."""
    fixed, _, _ = secded.decode_block(a_bits, a_codes)
    return unprotect(fixed).float() @ b.float()
