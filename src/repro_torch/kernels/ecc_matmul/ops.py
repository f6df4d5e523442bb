"""SECDED decode-on-load matrix product: the dispatching wrapper.

CPU tensors take the plain version (:mod:`.ref`); CUDA tensors launch the
kernel in ``csrc/ecc_matmul.cu`` or raise. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.ecc_matmul import ref

protect = ref.protect
unprotect = ref.unprotect


def ecc_matmul(a_bits: torch.Tensor, a_codes: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """A (M, K) bf16 as SECDED-protected words (bits (M, K//2), codes
    (M, K//16) int32) @ B (K, N) bf16 -> (M, N) float32, with single
    data-bit errors of A corrected on load. K must be a multiple of 16."""
    if a_bits.dim() != 2 or b.dim() != 2:
        raise ValueError("expected A bits (M, K//2) and B (K, N)")
    m, kw = a_bits.shape
    k, n = b.shape
    if k != 2 * kw or k % 16:
        raise ValueError(f"K mismatch or not a multiple of 16: bits "
                         f"{tuple(a_bits.shape)}, b {tuple(b.shape)}")
    if a_codes.shape != (m, k // 16):
        raise ValueError(f"codes must be {(m, k // 16)}, got "
                         f"{tuple(a_codes.shape)}")
    if b.dtype != torch.bfloat16:
        raise TypeError(f"ecc_matmul: B must be bfloat16, got {b.dtype}")
    common.check_contiguous("ecc_matmul", a_bits, a_codes, b)
    if all(t.device.type == "cpu" for t in (a_bits, a_codes, b)):
        return ref.ecc_matmul(a_bits, a_codes, b)
    common.check_cuda_words("ecc_matmul", a_bits, a_codes)
    if b.device != a_bits.device:
        raise ValueError("ecc_matmul: operands must share one CUDA device")
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    if not k:
        return out.zero_()
    if m and n:
        common.launch("ecc_matmul", a_bits, a_codes, b, out, m, n, k)
    return out
